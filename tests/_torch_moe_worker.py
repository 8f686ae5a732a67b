"""One rank of the CPU gloo meshes that ``test_torch_moe.py`` starts.

    python tests/_torch_moe_worker.py RANK CASE_DIR

Reads ``case.json`` from CASE_DIR (the mesh and a list of cases, each
reduced dbrx-132b with ``num_shared`` shared experts, its global weights
``params_CASE.npz``, the global batches ``batch.npz`` and ``small.npz``,
the MoE inputs ``blocks.npz`` and the paged calls ``calls.npz``) and joins
the gloo group through a file store there.  Per case, on this rank's
shard:
  - ``moe_block`` of layer 0 on each input of ``blocks.npz`` (this rank's
    feature shard of it): its output and aux loss;
  - the loss and every gradient of each batch (``small``'s fewer tokens
    than ranks take the replicated dispatch);
  - the paged calls through ``lm.paged_step``: local logits and greedy
    picks;
  - with ``record``, the loss's forward once more on the port's own seeded
    bf16 weights under ``analysis.signature.recording("fwd")``, its record
    by key.
Writes ``CASE_rank{RANK}.npz`` and ``CASE_rank{RANK}.json``.  Imports only
torch, numpy and the port.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.analysis import signature
from repro_torch.configs.registry import get_config
from repro_torch.core.atp import make_context
from repro_torch.core.mesh import atp_topo
from repro_torch.launch.steps import _greedy_pick
from repro_torch.models import lm, moe
from repro_torch.models.paging import PagedConfig
from repro_torch.optim import adamw

from _torch_train_worker import flatten, unflatten


def config(shared: int):
    cfg = get_config("dbrx-132b").reduced()
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, num_shared=shared))


def run_case(rank: int, topo, case: dict, case_dir: Path):
    cfg = config(case["shared"])
    ctx = make_context(topo, device_type="cpu")
    name = case["name"]
    glob = unflatten(np.load(case_dir / f"params_{name}.npz"))
    params = convert.params_from_jax(cfg, glob, topo, rank)
    out, meta = {}, {}

    blocks = np.load(case_dir / "blocks.npz")
    p0 = lm.tree_map(lambda t: t[0], params["seg0"]["moe"])
    with torch.no_grad():
        for key in blocks.files:
            x = torch.from_numpy(blocks[key])
            hl = x.shape[-1] // ctx.d2
            x = x[..., ctx.index2() * hl:(ctx.index2() + 1) * hl]
            y, aux = moe.moe_block(ctx, cfg, p0, x.contiguous())
            out[f"blk_out_{key}"], out[f"blk_aux_{key}"] = y.numpy(), \
                aux.numpy()

    leaves = adamw.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    for which, prefix in (("batch", ""), ("small", "small_")):
        batch = {k: torch.from_numpy(v)
                 for k, v in np.load(case_dir / f"{which}.npz").items()}
        loss = lm.train_loss(ctx, cfg, params, batch, remat=False)
        grads = torch.autograd.grad(loss, leaves)
        out[f"{prefix}loss"] = loss.detach().numpy()
        out.update(flatten(adamw.tree_unflatten(params, iter(grads)),
                           f"{prefix}grad/"))
    batch = {k: torch.from_numpy(v)
             for k, v in np.load(case_dir / "batch.npz").items()}

    calls = np.load(case_dir / "calls.npz")
    caches = lm.init_paged_caches(cfg, ctx, PagedConfig(**case["paged"]),
                                  dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for i in range(case["calls"]):
            args = (torch.from_numpy(calls[f"{n}{i}"])
                    for n in ("tokens", "start", "table"))
            logits, caches = lm.paged_step(ctx, cfg, params, *args, caches)
            out[f"logits{i}"] = logits.numpy()
            out[f"pick{i}"] = _greedy_pick(ctx, cfg, logits).numpy()

    if case.get("record"):
        own = lm.shard_params(cfg, lm.init_params(cfg, seed=0, device="cpu"),
                              lm.layout_context(topo, rank))
        with signature.recording("fwd") as rec, torch.no_grad():
            lm.train_loss(ctx, cfg, own, batch, remat=False)
        meta["fwd"] = [[*k[:2], list(k[2]), k[3], *v]
                       for k, v in sorted(rec.by_key("fwd").items())]
    np.savez(case_dir / f"{name}_rank{rank}.npz", **out)
    (case_dir / f"{name}_rank{rank}.json").write_text(json.dumps(meta))


def main(rank: int, case_dir: Path) -> None:
    torch.set_num_threads(1)
    spec = json.loads((case_dir / "case.json").read_text())
    topo = atp_topo(*spec["mesh"])
    dist.init_process_group("gloo", init_method=f"file://{case_dir}/store",
                            rank=rank, world_size=topo.size)
    for case in spec["cases"]:
        run_case(rank, topo, case, case_dir)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), Path(sys.argv[2]))
