"""One rank of the CPU gloo meshes that ``test_torch_collectives.py`` and
``test_torch_strategy.py`` start.

    python tests/_torch_plan_worker.py RANK CASE_DIR

Reads ``case.json`` from CASE_DIR: the mesh (dp, d1, d2) and a list of
cases, each an arch (reduced, at its depth where given), a ``ParallelPlan``
as a dict, the global batch and the sequence, and whether its forward runs
under remat (default off) and its gradients are written.  Joins the gloo group through
a file store there, and for each case builds the training step from the
plan (``build_train_step(plan=...)``), then on this rank's shard of seeded
weights (the global tree from ``params_CASE.npz`` where the case names it,
else the port's own seeded ``init_params``) and its data-parallel rows of a
seeded batch:

  - the loss under ``analysis.signature.recording("fwd")`` and its
    gradients under ``"bwd"``, then one AdamW step under ``"bwd"`` too;
  - for the first case, the forward once more with no record installed,
    counting the calls of ``Record.note``.

Writes ``rank{RANK}.json``: per case the context's knobs, the forward
record by key, the backward record's ops and regions, the loss and, where
asked, the gradients (``grads_CASE_rank{RANK}.npz``).  Imports only torch,
numpy and the port.  The tests start the ranks through :func:`start` and
collect them through :func:`finish`.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.analysis import signature
from repro_torch.configs.registry import get_config
from repro_torch.core.mesh import atp_topo
from repro_torch.core.plan import ParallelPlan
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
            out[f"{prefix}{k}"] = v.detach().float().numpy()
    return out


def batch_of(cfg, b: int, s: int, seed: int = 2) -> dict:
    """The global batch (``test_torch_train.make_batch``'s)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1), dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -2:] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def run_case(rank: int, topo, case: dict, case_dir: Path, count_idle: bool):
    cfg = get_config(case["arch"]).reduced()
    if case.get("layers"):
        cfg = dataclasses.replace(cfg, num_layers=case["layers"])
    plan = ParallelPlan.from_dict(case["plan"])
    opt_cfg = adamw.AdamWConfig(mode="plain", warmup_steps=2)
    remat = case.get("remat", False)
    _, info = build_train_step(cfg, opt_cfg=opt_cfg, remat=remat,
                               device="cpu", plan=plan)
    ctx = info.ctx
    if case.get("params"):
        params = convert.params_from_jax(
            cfg, unflatten(np.load(case_dir / case["params"])), topo, rank)
    else:
        params = lm.shard_params(cfg, lm.init_params(cfg, seed=0,
                                                     device="cpu"),
                                 lm.layout_context(topo, rank))
    glob = batch_of(cfg, case["batch"], case["seq"])
    rows = case["batch"] // ctx.dp
    i = ctx.dp_index()
    batch = {k: torch.from_numpy(v[i * rows:(i + 1) * rows])
             for k, v in glob.items()}

    leaves = adamw.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    with signature.recording("fwd") as rec:
        loss = lm.train_loss(ctx, cfg, params, batch, remat=remat)
    with signature.recording("bwd", rec):
        grads = list(torch.autograd.grad(loss, leaves))
    out = {"name": case["name"], "loss": float(loss.detach()),
           "knobs": {"d1": ctx.d1, "d2": ctx.d2, "dp": ctx.dp,
                     "chunks": ctx.chunks,
                     "segments": [s.to_dict() for s in ctx.segment_plans]},
           "fwd": [[*k[:2], list(k[2]), k[3], *v]
                   for k, v in sorted(rec.by_key("fwd").items())]}
    if case.get("grads"):
        summed = []
        for g in grads:   # summed over dp, as the optimizer sums them
            g = g.clone()
            if ctx.dp_axes:
                dist.all_reduce(g, group=ctx.group(ctx.dp_axes))
            summed.append(g)
        np.savez(case_dir / f"grads_{case['name']}_rank{rank}.npz",
                 **flatten(adamw.tree_unflatten(params, iter(summed))))
    with signature.recording("bwd", rec):
        adamw.apply_adamw(opt_cfg, ctx, params,
                          adamw.tree_unflatten(params, iter(grads)),
                          adamw.init_opt_state(params, ctx, opt_cfg.mode),
                          lm.replication_factors(cfg, ctx, params))
    bwd = [e for e in rec.entries if e.phase == "bwd"]
    out["bwd_ops"] = sorted({e.op for e in bwd})
    out["bwd_regions"] = sorted({e.region for e in bwd})
    out["bwd_count"] = len(bwd)

    if count_idle:
        calls = []
        note = signature.Record.note

        def counting(self, *a, **k):
            calls.append(a)
            return note(self, *a, **k)

        signature.Record.note = counting
        try:
            with torch.no_grad():
                lm.train_loss(ctx, cfg, params, batch, remat=False)
            idle = len(calls)
            with signature.recording("fwd") as again, torch.no_grad():
                lm.train_loss(ctx, cfg, params, batch, remat=False)
        finally:
            signature.Record.note = note
        out["idle_notes"] = idle
        out["active_notes"] = len(calls) - idle
        out["active_entries"] = len(again.entries)
    return out


def start(case_dir: Path, mesh) -> list:
    """Start one process per rank of ``mesh`` (dp, d1, d2) on
    ``case_dir/case.json``."""
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    world = mesh[0] * mesh[1] * mesh[2]
    return [subprocess.Popen([sys.executable, __file__, str(r),
                              str(case_dir)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(world)]


def finish(case_dir: Path, procs) -> list[list[dict]]:
    """Wait for the ranks :func:`start` began; each rank's results."""
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:  # a rank that died leaves the others waiting in a collective
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return [json.loads((case_dir / f"rank{r}.json").read_text())
            for r in range(len(procs))]


def main(rank: int, case_dir: Path) -> None:
    torch.set_num_threads(1)
    spec = json.loads((case_dir / "case.json").read_text())
    topo = atp_topo(*spec["mesh"])
    dist.init_process_group("gloo", init_method=f"file://{case_dir}/store",
                            rank=rank, world_size=topo.size)
    results = [run_case(rank, topo, case, case_dir, count_idle=(n == 0))
               for n, case in enumerate(spec["cases"])]
    (case_dir / f"rank{rank}.json").write_text(json.dumps(results))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), Path(sys.argv[2]))
