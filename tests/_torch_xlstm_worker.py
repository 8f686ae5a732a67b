"""One rank of the CPU gloo mesh that ``test_torch_xlstm.py`` starts.

    python tests/_torch_xlstm_worker.py RANK CASE_DIR

Reads ``case.json`` from CASE_DIR (the mesh, the reduced xlstm-1.3b's head
count, the paged geometry and the number of paged calls), the global
weights ``params.npz``, the global batch ``batch.npz`` and the paged calls
``calls.npz``, and joins the gloo group through a file store there.  On
this rank's shard: the paged calls through ``lm.paged_step`` (two state
slots; local logits), and the training loss and every gradient.  Writes
``rank{RANK}.npz``.  Imports only torch, numpy and the port.
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
from repro_torch.models import lm
from repro_torch.models.paging import PagedConfig
from repro_torch.optim import adamw

from _torch_train_worker import flatten, unflatten


def main(rank: int, case_dir: Path) -> None:
    torch.set_num_threads(1)
    spec = json.loads((case_dir / "case.json").read_text())
    topo = atp_topo(*spec["mesh"])
    dist.init_process_group("gloo", init_method=f"file://{case_dir}/store",
                            rank=rank, world_size=topo.size)
    cfg = dataclasses.replace(get_config("xlstm-1.3b").reduced(),
                              num_heads=spec["heads"],
                              num_kv_heads=spec["heads"])
    ctx = make_context(topo, device_type="cpu")
    params = convert.params_from_jax(
        cfg, unflatten(np.load(case_dir / "params.npz")), topo, rank)
    out = {}

    calls = np.load(case_dir / "calls.npz")
    caches = lm.init_paged_caches(cfg, ctx, PagedConfig(**spec["paged"]),
                                  dtype=torch.float32, device="cpu", slots=2)
    with torch.no_grad():
        for i in range(spec["calls"]):
            tok, start, table, slot = (torch.from_numpy(calls[f"{n}{i}"])
                                       for n in ("tokens", "start", "table",
                                                 "slot"))
            logits, caches = lm.paged_step(ctx, cfg, params, tok, start,
                                           table, caches, slot=slot)
            out[f"logits{i}"] = logits.numpy()

    batch = {k: torch.from_numpy(v)
             for k, v in np.load(case_dir / "batch.npz").items()}
    leaves = adamw.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = lm.train_loss(ctx, cfg, params, batch, remat=False)
    grads = torch.autograd.grad(loss, leaves)
    out["loss"] = loss.detach().numpy()
    out.update(flatten(adamw.tree_unflatten(params, iter(grads)), "grad/"))
    np.savez(case_dir / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), Path(sys.argv[2]))
