"""One rank of the CPU gloo meshes that ``test_torch_train.py`` and
``test_torch_mesh_train.py`` start.

    python tests/_torch_train_worker.py RANK CASE_DIR

Reads ``case.json`` (arch, its depth where not the reduced config's,
``mtp`` for an MTP head, mesh (dp, d1, d2) and ``pods``, chunks,
``seq_parallel``, optimizer mode and steps; or a
list of such cases under ``cases``, each with a ``name``, on one mesh
size), the JAX global weights ``params.npz`` and the global batches
``batches.npz`` (or the files a case names under ``params`` and
``batches``) from CASE_DIR, and joins the gloo group through a file
store there.  Then per case, on this rank's shard and its data-parallel
rows of the batch: the loss of batch 0 and every parameter's gradient,
summed over the data-parallel ranks as the optimizer sums them; and,
where the case asks for steps, that many ``build_train_step`` steps from
the same weights, one batch each.  Writes the loss, the gradients, the
step losses and grad norms, the updated parameters and, for a
``compressed`` case, the AdamW moments and the error-feedback residuals
after every step to ``rank{RANK}.npz`` (``{name}_rank{RANK}.npz`` for a
named case).  Imports only torch, numpy and the port.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.core.atp import make_context
from repro_torch.core.mesh import atp_topo
from repro_torch.launch.steps import build_train_step
from repro_torch.models import lm
from repro_torch.optim import adamw


def unflatten(flat) -> dict:
    tree: dict = {}
    for key in flat.files:
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return tree


def flatten(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach().numpy().copy()  # m, v, err change in place
    return out


def run_case(rank: int, case: dict, case_dir: Path) -> dict:
    topo = atp_topo(*case["mesh"], pods=case.get("pods", 1))
    cfg = get_config(case["arch"]).reduced()
    if case.get("layers"):
        cfg = dataclasses.replace(cfg, num_layers=case["layers"])
    if case.get("mtp"):
        cfg = dataclasses.replace(cfg, mtp=True)
    params = unflatten(np.load(case_dir / case.get("params", "params.npz")))
    flat = np.load(case_dir / case.get("batches", "batches.npz"))
    ctx = make_context(topo, chunks=case["chunks"],
                       seq_parallel=case.get("seq_parallel", False),
                       device_type="cpu")
    dp, i = ctx.dp, ctx.dp_index()

    def local(n):
        rows = flat[f"tokens{n}"].shape[0] // dp
        return {k: torch.from_numpy(flat[f"{k}{n}"][i * rows:(i + 1) * rows])
                for k in ("tokens", "labels")}

    tp = convert.params_from_jax(cfg, params, topo, rank)
    leaves = adamw.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss = lm.train_loss(ctx, cfg, tp, local(0), remat=False)
    grads = list(torch.autograd.grad(loss, leaves))
    if ctx.dp_axes:
        for g in grads:
            dist.all_reduce(g, group=ctx.group(ctx.dp_axes))
    out = {"loss": loss.detach().numpy()}
    out.update(flatten(adamw.tree_unflatten(tp, iter(grads)), "grad/"))

    if case["steps"]:
        step, info = build_train_step(
            cfg, topo, adamw.AdamWConfig(mode=case["mode"], warmup_steps=2),
            chunks=case["chunks"], remat=False, device="cpu")
        tp = convert.params_from_jax(cfg, params, topo, rank)
        state = adamw.init_opt_state(tp, info.ctx, case["mode"])
        losses, norms = [], []
        for n in range(case["steps"]):
            tp, state, m = step(tp, state, local(n))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if "err" in state:
                out.update(flatten(state["err"], f"err{n}/"))
                out.update(flatten(state["leaves"], f"opt{n}/"))
        out["losses"] = np.asarray(losses)
        out["grad_norms"] = np.asarray(norms)
        out.update(flatten(tp, "param/"))
    return out


def main(rank: int, case_dir: Path) -> None:
    torch.set_num_threads(1)
    spec = json.loads((case_dir / "case.json").read_text())
    cases = spec.get("cases", [spec])
    world = int(np.prod(cases[0]["mesh"])) * cases[0].get("pods", 1)
    dist.init_process_group("gloo", init_method=f"file://{case_dir}/store",
                            rank=rank, world_size=world)
    for case in cases:
        name = f"{case['name']}_" if "name" in case else ""
        np.savez(case_dir / f"{name}rank{rank}.npz",
                 **run_case(rank, case, case_dir))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), Path(sys.argv[2]))
