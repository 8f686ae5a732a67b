"""One rank of the CPU gloo mesh that ``test_torch_train.py`` starts.

    python tests/_torch_train_worker.py RANK CASE_DIR

Reads ``case.json`` (arch, its depth where not the reduced config's,
mesh, chunks, optimizer mode and steps), the
JAX global weights ``params.npz`` and the global batches ``batches.npz``
from CASE_DIR, and joins the gloo group through a file store there.  Then,
on this rank's shard and its data-parallel rows of the batch: the loss of
batch 0 and every parameter's gradient, summed over the data-parallel
ranks as the optimizer sums them; and, where the case asks for steps, that
many ``build_train_step`` steps from the same weights, one batch each.
Writes the loss, the gradients, the step losses and the updated
parameters to ``rank{RANK}.npz``.  Imports only torch, numpy and the port.
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
            out[f"{prefix}{k}"] = v.detach().numpy()
    return out


def main(rank: int, case_dir: Path) -> None:
    torch.set_num_threads(1)
    case = json.loads((case_dir / "case.json").read_text())
    topo = atp_topo(*case["mesh"])
    dist.init_process_group("gloo", init_method=f"file://{case_dir}/store",
                            rank=rank, world_size=topo.size)
    cfg = get_config(case["arch"]).reduced()
    if case.get("layers"):
        cfg = dataclasses.replace(cfg, num_layers=case["layers"])
    params = unflatten(np.load(case_dir / "params.npz"))
    flat = np.load(case_dir / "batches.npz")
    ctx = make_context(topo, chunks=case["chunks"], device_type="cpu")
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
        losses = []
        for n in range(case["steps"]):
            tp, state, m = step(tp, state, local(n))
            losses.append(float(m["loss"]))
        out["losses"] = np.asarray(losses)
        out.update(flatten(tp, "param/"))
    np.savez(case_dir / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), Path(sys.argv[2]))
