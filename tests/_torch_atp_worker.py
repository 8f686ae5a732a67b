"""One rank of the CPU gloo mesh that ``test_torch_atp.py`` starts.

    python tests/_torch_atp_worker.py RANK CASE_DIR

Reads ``case.json`` (arch and its layer count, mesh, chunks or a
``ParallelPlan`` as a dict, whose decode sub-plan the serving step runs,
page geometry, the state pools' slot count or null), the JAX global
weights ``params.npz`` and the step inputs ``calls.npz`` from CASE_DIR,
joins the gloo group through a file store there, runs every call through
the port's ``lm.paged_step`` on this rank's shard, and writes its local
logits and the vocab-parallel greedy picks to ``rank{RANK}.npz``.  Imports
only torch, numpy and the port.
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
from repro_torch.core.plan import ParallelPlan
from repro_torch.launch.steps import _greedy_pick, resolve_ctx
from repro_torch.models import lm
from repro_torch.models.paging import PagedConfig


def unflatten(flat) -> dict:
    tree: dict = {}
    for key in flat.files:
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return tree


def main(rank: int, case_dir: Path) -> None:
    torch.set_num_threads(1)
    case = json.loads((case_dir / "case.json").read_text())
    topo = atp_topo(*case["mesh"])
    dist.init_process_group("gloo", init_method=f"file://{case_dir}/store",
                            rank=rank, world_size=topo.size)
    cfg = get_config(case["arch"]).reduced()
    if case["layers"]:
        cfg = dataclasses.replace(cfg, num_layers=case["layers"])
    if case.get("plan"):
        ctx = resolve_ctx(topo, ParallelPlan.from_dict(case["plan"]),
                          decode=True, device_type="cpu")
    else:
        ctx = make_context(topo, chunks=case["chunks"], device_type="cpu")
    params = convert.params_from_jax(
        cfg, unflatten(np.load(case_dir / "params.npz")), topo, rank)
    caches = lm.init_paged_caches(cfg, ctx, PagedConfig(**case["paged"]),
                                  dtype=torch.float32, device="cpu",
                                  slots=case["slots"])
    calls = np.load(case_dir / "calls.npz")
    out = {}
    with torch.no_grad():
        for i in range(case["calls"]):
            args = (torch.from_numpy(calls[f"{name}{i}"])
                    for name in ("tokens", "start", "table"))
            slot = torch.from_numpy(calls[f"slot{i}"]) if case["slots"] else None
            logits, caches = lm.paged_step(ctx, cfg, params, *args, caches,
                                           slot=slot)
            out[f"logits{i}"] = logits.numpy()
            out[f"pick{i}"] = _greedy_pick(ctx, cfg, logits).numpy()
    np.savez(case_dir / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), Path(sys.argv[2]))
