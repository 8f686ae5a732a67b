"""One rank of the CPU gloo mesh that ``test_torch_qwen2vl.py`` starts.

    python tests/_torch_qwen2vl_worker.py RANK CASE_DIR

Reads ``case.json`` from CASE_DIR (the mesh and the reduced qwen2-vl-7b's
head count), the global weights ``params.npz`` and the global batch
``batch.npz`` (``embeds [b, s, h]``, ``positions3 [3, b, s]``, ``labels``),
and joins the gloo group through a file store there.  On this rank's
shard, fed its feature slice of the embeds: the last position's prefill
logits, and the training loss and every gradient.  Writes
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
from repro_torch.optim import adamw

from _torch_train_worker import flatten, unflatten


def main(rank: int, case_dir: Path) -> None:
    torch.set_num_threads(1)
    spec = json.loads((case_dir / "case.json").read_text())
    topo = atp_topo(*spec["mesh"])
    dist.init_process_group("gloo", init_method=f"file://{case_dir}/store",
                            rank=rank, world_size=topo.size)
    cfg = dataclasses.replace(get_config("qwen2-vl-7b").reduced(),
                              num_heads=spec["heads"],
                              num_kv_heads=spec["heads"])
    ctx = make_context(topo, device_type="cpu")
    params = convert.params_from_jax(
        cfg, unflatten(np.load(case_dir / "params.npz")), topo, rank)
    batch = {k: torch.from_numpy(v)
             for k, v in np.load(case_dir / "batch.npz").items()}
    hl = batch["embeds"].shape[-1] // ctx.d2
    batch["embeds"] = batch["embeds"][..., ctx.index2() * hl:
                                      (ctx.index2() + 1) * hl].contiguous()
    out = {}
    with torch.no_grad():
        out["prefill"] = lm.prefill_logits(ctx, cfg, params, {
            k: v for k, v in batch.items() if k != "labels"}).numpy()
    leaves = adamw.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = lm.train_loss(ctx, cfg, params, batch, remat=False)
    # a batch of embeds leaves the embedding unused: its gradient is zeros
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    out["loss"] = loss.detach().numpy()
    out.update(flatten(adamw.tree_unflatten(params, iter(grads)), "grad/"))
    np.savez(case_dir / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), Path(sys.argv[2]))
