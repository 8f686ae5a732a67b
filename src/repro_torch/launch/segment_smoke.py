"""Heterogeneous-plan smoke gate (counterpart of
``repro.launch.segment_smoke``), on 8 gloo ranks on the CPU.

Exercises the per-segment strategy pipeline on a mixed dense-prefix + MoE
stack (the reference's 3-layer "smoke-mix": one dense layer, then two MoE
layers) over ic3 at TP degree 4 and dp 2, and exits non-zero on any
mismatch:

    per-segment search (model=cfg) -> save JSON -> load -> per-segment
    contexts identical -> decode masks seq_parallel everywhere -> three
    train steps with DIFFERENT knobs per segment (dense: chunks 2 and
    seq_parallel, MoE: chunks 1, seq_parallel masked) -> the mixed plan's
    losses equal the all-replicated plan's.

    PYTHONPATH=src python -m repro_torch.launch.segment_smoke

The search, the JSON round trip and ``describe`` run in this process; it
then starts 8 processes (``--rank``), each joining one gloo group through a
``file://`` store under a temporary directory, which build the train and
decode steps from the loaded plan and train.  The reference's static
jaxpr lint of the mixed train and decode steps has no counterpart here:
with ``--record DIR`` each rank writes the collectives its mixed train
step's forward and its decode step issue (``analysis.signature``) to
``DIR/rank{R}.json`` (and the plan to ``DIR/plan.json``), which
``tests/test_torch_segment_smoke.py`` holds against the reference's
``expected_signature``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

#: the gloo ranks: (dp, d1, d2) = (2, 2, 2)
RANKS = 8
#: the global batch and sequence of the three train steps
BATCH, SEQ = 8, 32
#: the decode step's wave and cache length
DECODE_B, DECODE_S_MAX = 4, 16
#: the loss parity's tolerance (relative, at least 1 absolute), as the
#: reference's
LOSS_TOL = 1e-4
#: seconds the gate waits for its ranks
RANK_TIMEOUT = 300


def check(ok: bool, what: str):
    if not ok:
        print(f"[segment-smoke] FAIL: {what}", flush=True)
        sys.exit(1)
    print(f"[segment-smoke] ok: {what}", flush=True)


def smoke_config():
    """The reference's "smoke-mix": a DBRX-style MoE stack with a
    DeepSeek-style dense prefix, fp32."""
    from repro_torch.configs.base import ModelConfig, MoEConfig

    return ModelConfig(
        name="smoke-mix", family="moe", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        dtype="float32",
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                      first_dense_layers=1))


def mixed_plan(path: Path):
    """Checks 1 and 2 in this process: the per-segment search and the v2
    plan JSON round trip of the forced heterogeneous plan, saved to
    ``path``.  Returns the loaded plan."""
    from repro_torch.configs.base import segments
    from repro_torch.core.atp import SegmentPlan
    from repro_torch.core.plan import ParallelPlan, plan_search

    cfg = smoke_config()
    kinds = [s.kind for s in segments(cfg)]
    check(kinds == ["dense", "moe"], f"mixed segments {kinds}")

    # 1. heterogeneous search: one SegmentPlan per segment, and the MoE
    #    segment must never be offered seq_parallel
    res = plan_search("ic3", 4, model=cfg, batch=BATCH, seq=SEQ, dp=2,
                      chunks_options=(1, 2))
    check(all(len(p.segments) == 2 for p in res.ranked),
          "every ranked plan carries per-segment knobs")
    check(all(not p.segment_plan("moe").seq_parallel for p in res.ranked),
          "search never assigns seq_parallel to the MoE segment")

    # 2. a maximally heterogeneous plan (the search may pick homogeneous
    #    knobs on a toy workload; the gate must exercise the threading):
    #    dense = chunks 2 + seq-parallel, moe = chunks 1
    plan = res.best.with_(
        d1=2, d2=2,
        segments=(SegmentPlan("dense", chunks=2, seq_parallel=True),
                  SegmentPlan("moe", chunks=1)))
    plan.save(str(path))
    loaded = ParallelPlan.load(str(path))
    check(loaded == plan, "v2 plan JSON round-trip is exact")
    check("segments[" in loaded.describe(), f"describe: {loaded.describe()}")
    check(loaded.topo().size == RANKS,
          f"the plan's mesh has {RANKS} ranks: {loaded.describe()}")
    return loaded


def _train(cfg, plan, rank: int, steps: int = 3) -> list[float]:
    """``steps`` AdamW (zero1) steps of ``build_train_step`` under ``plan``
    from seeded fp32 weights, on this dp rank's rows of the reference's
    token stream; the losses."""
    import torch

    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    step, info = build_train_step(cfg, device="cpu", plan=plan)
    ctx = info.ctx
    params = lm.shard_params(cfg, lm.init_params(cfg, seed=0, device="cpu"),
                             lm.layout_context(plan.topo(), rank))
    opt = adamw.init_opt_state(params, ctx, "zero1")
    src = TokenSource(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                 global_batch=BATCH))
    losses = []
    for i in range(steps):
        rows = src.host_batch(i, ctx.dp_index(), ctx.dp)
        params, opt, metrics = step(params, opt, {
            k: torch.from_numpy(v) for k, v in rows.items()})
        losses.append(float(metrics["loss"]))
    return losses


def _records(cfg, plan, rank: int) -> dict:
    """The forward collectives of the mixed train step's loss and of one
    decode tick (``DECODE_B`` rows, one token each, the greedy pick in),
    by key, as ``tests/_torch_plan_worker.py`` writes them."""
    import torch

    from repro_torch.analysis import signature
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch.steps import build_decode_step, resolve_ctx
    from repro_torch.models import lm

    params = lm.shard_params(cfg, lm.init_params(cfg, seed=0, device="cpu"),
                             lm.layout_context(plan.topo(), rank))
    ctx = resolve_ctx(None, plan, device_type="cpu")
    src = TokenSource(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                 global_batch=BATCH))
    rows = src.host_batch(0, ctx.dp_index(), ctx.dp)
    with signature.recording("fwd") as train, torch.no_grad():
        lm.train_loss(ctx, cfg, params,
                      {k: torch.from_numpy(v) for k, v in rows.items()},
                      remat=False)
    _, info = build_decode_step(cfg, B=DECODE_B, s_max=DECODE_S_MAX,
                                device="cpu", plan=plan)
    caches = info.init_caches()
    b = lm.decode_rows(info.ctx, DECODE_B)
    tokens = torch.zeros((b, 1), dtype=torch.int32)
    with signature.recording("fwd") as decode:
        info.plain(params, tokens, torch.tensor(0), caches)

    def by_key(rec):
        return [[*k[:2], list(k[2]), k[3], *v]
                for k, v in sorted(rec.by_key("fwd").items())]

    return {"train": by_key(train), "decode": by_key(decode)}


def rank_main(rank: int, work: Path, record: Path | None) -> None:
    """One of the 8 ranks: checks 3-5 on this rank's shard, the results
    in ``work/result{rank}.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.atp import SegmentPlan
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.launch.steps import build_decode_step, build_train_step

    torch.set_num_threads(1)
    cfg = smoke_config()
    loaded = ParallelPlan.load(str(work / "plan.json"))
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=loaded.topo().size)
    out = {}
    # 3. per-segment knobs reach the builders
    _, t_info = build_train_step(cfg, device="cpu", plan=loaded)
    dctx = t_info.ctx.for_segment("dense")
    mctx = t_info.ctx.for_segment("moe")
    out["train_dense"] = [dctx.chunks, dctx.seq_parallel]
    out["train_moe"] = [mctx.chunks, mctx.seq_parallel]
    _, d_info = build_decode_step(cfg, B=DECODE_B, s_max=DECODE_S_MAX,
                                  device="cpu", plan=loaded)
    out["decode_sp"] = [d_info.ctx.seq_parallel] + [
        s.seq_parallel for s in d_info.ctx.segment_plans]
    out["decode_segments"] = len(d_info.ctx.segment_plans)
    if record is not None:
        (record / f"rank{rank}.json").write_text(json.dumps(
            _records(cfg, loaded, rank)))
    # 5. three training steps under the mixed plan, and under the same
    #    plan with every segment replicated (sequence parallelism is a
    #    layout change, not a math change)
    out["mixed"] = _train(cfg, loaded, rank)
    out["flat"] = _train(cfg, loaded.with_(segments=(
        SegmentPlan("dense", chunks=1), SegmentPlan("moe", chunks=1))), rank)
    (work / f"result{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rank", type=int, default=None,
                    help="run as this rank of the 8 (started by the gate)")
    ap.add_argument("--work", default=None,
                    help="the ranks' directory: plan, store and results")
    ap.add_argument("--record", default=None,
                    help="write each rank's collective record here")
    args = ap.parse_args(argv)
    record = Path(args.record) if args.record else None
    if args.rank is not None:
        rank_main(args.rank, Path(args.work), record)
        return 0
    if record is not None:
        record.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        work = Path(td)
        loaded = mixed_plan(work / "plan.json")
        if record is not None:
            loaded.save(str(record / "plan.json"))
        src = Path(__file__).resolve().parents[2]
        env = dict(os.environ, PYTHONPATH=str(src) + (
            os.pathsep + os.environ["PYTHONPATH"]
            if os.environ.get("PYTHONPATH") else ""))
        cmd = [sys.executable, "-m", "repro_torch.launch.segment_smoke",
               "--work", str(work)]
        if record is not None:
            cmd += ["--record", str(record)]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(RANKS)]
        try:
            logs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
        finally:   # a rank that died leaves the others waiting
            for p in procs:
                p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                print(log)
            check(p.returncode == 0, f"rank {r} ran (exit {p.returncode})")
        res = [json.loads((work / f"result{r}.json").read_text())
               for r in range(RANKS)]
    check(all(r["train_dense"] == [2, True] for r in res),
          "train dense segment: chunks=2 seq_parallel=True")
    check(all(r["train_moe"] == [1, False] for r in res),
          "train moe segment: chunks=1 seq_parallel masked")
    check(all(r["decode_segments"] == 2 and not any(r["decode_sp"])
              for r in res),
          "decode masks seq_parallel in every segment plan")
    mixed, flat = res[0]["mixed"], res[0]["flat"]
    check(all(r["mixed"] == mixed and r["flat"] == flat for r in res),
          "every rank reports the same losses")
    check(all(math.isfinite(x) for x in mixed),
          f"3-step train under {loaded.describe()}: losses {mixed}")
    close = all(abs(a - b) < LOSS_TOL * max(1.0, abs(b))
                for a, b in zip(mixed, flat))
    check(close, f"mixed-plan losses match replicated plan: {mixed} ~ "
                 f"{flat}")
    print("[segment-smoke] PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
