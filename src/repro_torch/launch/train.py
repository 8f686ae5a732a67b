"""Training launcher (counterpart of ``repro.launch.train``, its
non-elastic loop): a dense or zamba/mamba model, random weights from a
seed, batches from ``data.pipeline``, ``build_train_step`` and AdamW.
The paper's GPT models (``--arch gpt-m1`` .. ``gpt-m4``) train at their
own 4 layers unless ``--layers`` cuts them.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --layers 4 --seq 2048 --batch 1 --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
        --layers 14 --seq 2048 --batch 1 --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-m2 \\
        --seq 2048 --batch 1 --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
        --reduced --device cpu

runs on CUDA unless ``--device cpu`` is given, and prints the loss, the
global grad norm and the wall time of each step.  The batches come from a
synthetic token stream, or with ``--corpus FILE`` from a flat file of
uint16 tokens (read as a memmap).  A mesh of more than one
rank runs one process per rank under ``torch.distributed.run``, e.g.
``python -m torch.distributed.run --nproc-per-node 4 -m
repro_torch.launch.train --d1 2 --d2 2``.  The elastic, fault-tolerant
trainer of the JAX package is ROADMAP A11.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.mesh import atp_topo, resolve_device
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.launch.steps import build_train_step
from repro_torch.models import lm
from repro_torch.optim import adamw

log = logging.getLogger("repro_torch.train")


def main(argv=None) -> list[dict]:
    """Run the loop; returns each step's metrics as floats (loss,
    grad_norm, lr, ms)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--d1", type=int, default=1)
    ap.add_argument("--d2", type=int, default=1)
    ap.add_argument("--chunks", type=int, default=1)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (split over the dp ranks)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--opt-mode", default="zero1", choices=("plain", "zero1"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus", default=None,
                    help="a file of uint16 tokens to sample the batches "
                         "from (default: a synthetic stream)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    topo = atp_topo(args.dp, args.d1, args.d2)
    device = resolve_device(args.device)
    rank = 0
    if topo.size > 1:
        import torch.distributed as dist

        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        rank = dist.get_rank()
    opt_cfg = adamw.AdamWConfig(lr=args.lr, mode=args.opt_mode,
                                total_steps=args.steps)
    step, info = build_train_step(cfg, topo, opt_cfg, chunks=args.chunks,
                                  device=device)
    params = lm.shard_params(cfg, lm.init_params(cfg, seed=args.seed,
                                                 device=device),
                             lm.layout_context(topo, rank))
    opt_state = adamw.init_opt_state(params, info.ctx, opt_cfg.mode)
    ctx = info.ctx
    if args.batch % ctx.dp:
        raise ValueError(f"--batch {args.batch} does not split over dp="
                         f"{ctx.dp}")
    source = TokenSource(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                    seed=args.seed, corpus_path=args.corpus))
    log.info("train %s: %d layers, d_model %d, vocab %d, mesh (dp, d1, d2) "
             "= (%d, %d, %d), batch %d x seq %d, %s on %s", cfg.name,
             cfg.num_layers, cfg.d_model, cfg.vocab_size, args.dp, args.d1,
             args.d2, args.batch, args.seq, opt_cfg.mode, device)
    history = []
    for i in range(args.steps):
        host = source.host_batch(i, ctx.dp_index(), ctx.dp)
        batch = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # synchronises
        ms = 1e3 * (time.perf_counter() - t0)
        history.append({"loss": loss, "grad_norm": gnorm, "lr": m["lr"],
                        "ms": ms})
        log.info("step %d: loss %.4f grad norm %.4f lr %.3g, %.1f ms "
                 "(%.0f tokens/s)", i, loss, gnorm, m["lr"], ms,
                 args.batch * args.seq / (ms / 1e3))
    return history


if __name__ == "__main__":
    main()
