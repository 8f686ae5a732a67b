"""Training launcher (counterpart of ``repro.launch.train``, its
non-elastic loop): a dense, MoE, MLA or zamba/mamba model, random weights
from a seed, batches from ``data.pipeline``, ``build_train_step`` and AdamW.
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
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-v3-671b --layers 2 --seq 2048 --batch 1 --steps 5

runs on CUDA unless ``--device cpu`` is given, and prints the loss, the
global grad norm and the wall time of each step.  The batches come from a
synthetic token stream, or with ``--corpus FILE`` from a flat file of
uint16 tokens (read as a memmap).  A mesh of more than one
rank runs one process per rank under ``torch.distributed.run``, e.g.
``python -m torch.distributed.run --nproc-per-node 4 -m
repro_torch.launch.train --d1 2 --d2 2``.  The elastic, fault-tolerant
trainer of the JAX package is ROADMAP A11.

The strategy is a ``ParallelPlan`` end to end: ``--auto-atp`` searches one
(paper §3.5 with the overlap knobs; ``--no-overlap`` keeps to the seed
Eq. 2 space) on the ``--topology`` preset (default ``h100-sxm-8``) for
TP degree d1 * d2, ``--plan FILE`` loads a saved one, and plain
``--d1/--d2/--chunks`` make one with provenance ``manual-cli``; ``--save-plan
FILE`` writes the plan the run executes.  A plan with ``pods`` (two
data-parallel axes, pod and data) trains through ``--plan``; like the
reference's, the launcher has no ``--pods`` of its own.  ``--opt-mode``
takes plain, zero1 (the default) or compressed:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-m2 \
        --seq 2048 --batch 1 --auto-atp --save-plan plan.json
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-m2 \
        --seq 2048 --batch 1 --plan plan.json

``--calibrate`` (with ``--auto-atp``) measures (B1, B2), alpha_s, the
chunk and launch costs and the quantized bandwidths of every (d1, d2)
that fits the ranks of the run (``core.calibrate.calibrate_mesh``) before
the search; factorizations that do not fit keep the analytic model, so in
one process (``--calibrate`` on one card or on the CPU) the search gives
the analytic plan:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-m2 \
        --seq 2048 --batch 1 --auto-atp --calibrate
    python -m torch.distributed.run --nproc-per-node 8 -m \
        repro_torch.launch.train --arch gpt-m2 --d1 2 --d2 4 --auto-atp \
        --calibrate
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time

import torch

from repro_torch.configs.base import cut_depth
from repro_torch.configs.registry import get_config
from repro_torch.core import comm_matrix
from repro_torch.core.calibrate import calibrate_mesh
from repro_torch.core.cost_model import LayerCommProfile
from repro_torch.core.mesh import resolve_device
from repro_torch.core.plan import ParallelPlan, PlanSearchResult, plan_search
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.launch.steps import build_train_step
from repro_torch.models import lm
from repro_torch.optim import adamw

log = logging.getLogger("repro_torch.train")

#: the comm-matrix presets of the port's own card, and its dense bf16 peak
#: (TFLOP/s; the NVIDIA H100 SXM datasheet) that ``pick_plan`` prices their
#: GEMM time with.  Every other preset keeps ``plan_search``'s default, so
#: its plans stay equal to the reference's.
H100_PRESETS = frozenset({"h100-sxm-8", "h100-sxm-2x8"})
H100_PEAK_TFLOPS = 989.0


def comm_profile(cfg) -> LayerCommProfile:
    """Generalized Eq. 2 coefficients for this architecture's dense block
    (the per-kind constructor in the cost model)."""
    return LayerCommProfile.dense(cfg)


def pick_plan(cfg, tp: int, seq: int, batch: int,
              topology: str = "h100-sxm-8", dp: int = 1,
              calibrate: bool = False,
              overlap: bool = True) -> PlanSearchResult:
    """Search the plan space for this workload (``repro.launch.train.
    pick_plan``).

    The default is the per-segment search (``plan_search(model=cfg)``):
    each model segment gets its own (chunks, seq_parallel) against its
    per-kind comm profile over the shared mesh.  ``overlap=False`` keeps to
    the seed Eq. 2 space.  ``calibrate`` measures the process group the
    caller runs in first (``calibrate_mesh``; every rank must call this):
    the factorizations of ``tp`` that fit its ranks get measured entries,
    the others, and every one in a single process, keep the analytic
    model."""
    calib = None
    if calibrate:
        calib = calibrate_mesh(tp, comm_matrix.PRESETS[topology]())
        log.info("on-mesh calibration (%d factorizations): %s", len(calib),
                 calib.source)
    peak = ({"peak_tflops": H100_PEAK_TFLOPS} if topology in H100_PRESETS
            else {})
    if not overlap:
        return plan_search(topology, tp, layers=cfg.num_layers, batch=batch,
                           seq=seq, profile=comm_profile(cfg), dp=dp,
                           calibration=calib, chunks_options=(1,),
                           seq_parallel_options=(False,),
                           algo="rabenseifner", alpha_s=0.0, **peak)
    return plan_search(topology, tp, model=cfg, batch=batch, seq=seq,
                       dp=dp, calibration=calib, **peak)


def _init_dist(device: torch.device) -> torch.device:
    """Join the ranks of a ``torch.distributed.run`` launch (NCCL on the
    card, gloo on the host), once; returns this rank's device."""
    import torch.distributed as dist

    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device


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
    ap.add_argument("--opt-mode", default="zero1",
                    choices=("plain", "zero1", "compressed"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus", default=None,
                    help="a file of uint16 tokens to sample the batches "
                         "from (default: a synthetic stream)")
    ap.add_argument("--auto-atp", action="store_true",
                    help="search a ParallelPlan (paper §3.5 + overlap knobs)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="restrict --auto-atp to the seed Eq. 2 space")
    ap.add_argument("--calibrate", action="store_true",
                    help="measure (B1, B2) on the ranks of the run before "
                         "--auto-atp searches")
    ap.add_argument("--plan", default=None,
                    help="load a saved ParallelPlan JSON instead of searching")
    ap.add_argument("--save-plan", default=None,
                    help="write the executed plan JSON here")
    ap.add_argument("--topology", default="h100-sxm-8",
                    choices=list(comm_matrix.PRESETS),
                    help="comm-matrix preset for --auto-atp")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = cut_depth(cfg, args.layers)
    device = resolve_device(args.device)
    if args.calibrate and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        # the calibration measures the ranks of the run: join them first
        device = _init_dist(device)
    if args.plan:
        plan = ParallelPlan.load(args.plan)
        log.info("loaded plan %s: %s", args.plan, plan.describe())
    elif args.auto_atp:
        res = pick_plan(cfg, args.d1 * args.d2, args.seq, args.batch,
                        args.topology, dp=args.dp, calibrate=args.calibrate,
                        overlap=not args.no_overlap)
        plan = res.best
        log.info("ATP plan search on %s picked %s; top of the ranking: %s",
                 args.topology, plan.describe(),
                 [(c.d1, c.d2, c.chunks, c.seq_parallel,
                   round(c.t_exposed * 1e3, 2)) for c in res.costs[:4]])
    else:
        # manual knobs still make a plan: one artifact, one code path
        plan = ParallelPlan(d1=args.d1, d2=args.d2, dp=args.dp,
                            chunks=args.chunks,
                            provenance=(("searcher", "manual-cli"),))
    if args.save_plan:
        plan.save(args.save_plan)
        log.info("saved plan -> %s", args.save_plan)
    topo = plan.topo()
    rank = 0
    if topo.size > 1:
        device = _init_dist(device)
        rank = torch.distributed.get_rank()
    opt_cfg = adamw.AdamWConfig(lr=args.lr, mode=args.opt_mode,
                                total_steps=args.steps)
    step, info = build_train_step(cfg, opt_cfg=opt_cfg, device=device,
                                  plan=plan)
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
             "= (%d, %d, %d), batch %d x seq %d, %s on %s; plan %s", cfg.name,
             cfg.num_layers, cfg.d_model, cfg.vocab_size, ctx.dp, ctx.d1,
             ctx.d2, args.batch, args.seq, opt_cfg.mode, device,
             plan.describe())
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
