"""Elastic-restart smoke gate (counterpart of ``repro.launch.elastic_smoke``),
on 8 gloo ranks on the CPU.

Exercises the complete failure -> shrink -> recover loop and exits
non-zero on any mismatch:

    calibrated plan (dp=2 x tp=4 = 8 ranks) -> fault-tolerant training
    -> injected failure that also SHRINKS the pool to 2 ranks (hosts 1-3
    of 4 simulated hosts, 2 ranks each, die on the membership fabric)
    -> the 6 ranks outside the committed view leave; the 2 survivors join
    a new group -> recalibrate on it (fresh (B1, B2)/alpha_s entries for
    tp=2, no ``calibration: stale`` tag) -> re-searched plan across a
    (d1, d2) change -> the checkpoint restored and cut for the new mesh
    -> loss trajectory matches an uninterrupted 8-rank run (the strategy
    is a layout choice, not a math change).

    PYTHONPATH=src python -m repro_torch.launch.elastic_smoke

The ranks are processes of this module, joined as the chaos smoke's are
(``launch.chaos_smoke.spawn``).  The reference's static conformance lint
of both plans' train steps (ROADMAP A13c) is not ported and not run.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

from repro_torch.launch.chaos_smoke import (FAIL_STEP, TOTAL_STEPS,
                                            elastic_run, rank_main, spawn)


def check(ok: bool, what: str):
    if not ok:
        print(f"[elastic-smoke] FAIL: {what}", flush=True)
        sys.exit(1)
    print(f"[elastic-smoke] ok: {what}", flush=True)


def smoke_config():
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(name="smoke-elastic", family="dense", num_layers=2,
                       d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                       vocab_size=256, head_dim=16, dtype="float32")


def elastic_rank(rank, world, work, case) -> dict:
    """Every rank: the calibrated plan (measured on the 8 ranks), an
    uninterrupted run, then the run that loses hosts 1-3 at step 5."""
    import torch

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core import comm_matrix
    from repro_torch.core.calibrate import calibrate_mesh
    from repro_torch.core.plan import plan_search
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch.train import make_elastic_trainer
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.runtime.faults import FaultEvent, FaultPlan
    from repro_torch.runtime.trainer import TrainerConfig

    cfg = smoke_config()
    calib = calibrate_mesh(4, comm_matrix.PRESETS["ic3"](), payload_kb=16,
                           repeats=1)
    plan = plan_search("ic3", 4, model=cfg, batch=8, seq=32, dp=2,
                       calibration=calib, chunks_options=(1, 2)).best
    out = {"plan": plan.to_dict()}
    _, _, _, out["base"] = elastic_run(cfg, plan, str(work / "base"), work,
                                       rank=rank, n_hosts=4)
    fplan = FaultPlan.scripted(FaultEvent("device_loss", at=FAIL_STEP,
                                          hosts=(1, 2, 3)))
    tr, live, fabric, out["losses"] = elastic_run(
        cfg, plan, str(work / "elastic"), work, rank=rank, n_hosts=4,
        fplan=fplan, recalib_deadline_s=120.0)
    final = fabric.hosts[0].committed
    new_plan = live["plan"]
    # the final state against the last checkpoint, restored and cut for
    # the surviving mesh
    tree, meta = ckpt.restore(str(work / "elastic"), tr.ckpt_template())
    params = tr.decode_ckpt(tree)[0]
    mine = live["params"]
    out.update(
        replans=tr.replans, total_failures=tr.total_failures,
        failures=tr.failures, ema=tr.watchdog.ema,
        epochs={str(e): sorted(v) for e, v in fabric.epochs().items()},
        final=[list(final.alive), final.planner],
        new_plan=new_plan.to_dict(), describe=new_plan.describe(),
        restored_step=meta["step"],
        restored_equal=all(torch.equal(a, b) for a, b in zip(
            adamw.tree_leaves(params), adamw.tree_leaves(mine))),
        shard_shapes=[list(t.shape) for t in adamw.tree_leaves(mine)],
        want_shapes=[list(t.shape) for t in adamw.tree_leaves(
            lm.shard_params(cfg, lm.init_params(cfg, device="meta"),
                            lm.layout_context(new_plan.topo(),
                                              live["rank"])))])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenario", choices=("elastic",), default=None,
                    help="run as a rank (started by the gate)")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--work", default=None)
    args = ap.parse_args(argv)
    if args.scenario is not None:
        rank_main({"elastic": elastic_rank}, args.scenario, args.rank,
                  args.world, Path(args.work))
        return 0
    from repro_torch.core.plan import ParallelPlan

    with tempfile.TemporaryDirectory() as td:
        res = spawn("elastic", 8, Path(td),
                    module="repro_torch.launch.elastic_smoke")
    left = [r for r in res if "departed" in r]
    stay = [r for r in res if "departed" not in r]
    check(len(left) == 6 and len(stay) == 2,
          f"the 6 ranks outside the committed view left: "
          f"{sorted({r['departed'] for r in left})}")
    s = stay[0]
    plan = ParallelPlan.from_dict(s["plan"])
    check(all(r["plan"] == s["plan"] for r in stay),
          "the survivors searched the same calibrated plan")
    check(plan.devices == 8 and plan.tp == 4,
          f"initial plan uses the full pod: {plan.describe()}")
    check(plan.calibration is not None and plan.calibration.covers_tp(4),
          "initial plan carries a tp=4 calibration table")
    # 1. the failure was recovered through the re-plan path
    check(all(r["replans"] == [FAIL_STEP] for r in stay),
          f"one elastic re-plan at step {FAIL_STEP}: {s['replans']}")
    check(all(len(v) == 1 for v in s["epochs"].values()),
          f"one committed view per epoch (no split-brain): {s['epochs']}")
    check(s["final"] == [[0], 0],
          f"converged view is the survivor set: {s['final']}")
    check(s["total_failures"] == 1 and s["failures"] == 0,
          f"failure counter decayed after recovery "
          f"(total={s['total_failures']}, consecutive={s['failures']})")
    check(s["ema"] is not None,
          "watchdog EMA re-seeded from post-replan steps")
    # 2. the recovered job runs a re-searched plan over the survivors,
    #    priced by fresh measurements on them
    new_plan = ParallelPlan.from_dict(s["new_plan"])
    check(all(r["new_plan"] == s["new_plan"] for r in stay),
          "both survivors run the planner's plan")
    check(new_plan.tp == 2 and new_plan.devices <= 2,
          f"re-plan fits the surviving pool: {new_plan.describe()}")
    check((new_plan.d1, new_plan.d2) != (plan.d1, plan.d2),
          f"(d1,d2) actually changed: {plan.d1, plan.d2} -> "
          f"{new_plan.d1, new_plan.d2}")
    check(new_plan.calibration is not None
          and new_plan.calibration.covers_tp(2),
          "calibration table has fresh surviving-mesh (tp=2) entries")
    check(not new_plan.calibration_stale
          and "[calibration:stale]" not in new_plan.describe(),
          "no calibration:stale tag after recalibration")
    check(any(k == "calibration" and v.startswith("recalibrated")
              for k, v in new_plan.provenance),
          "recalibration recorded in provenance")
    check(any(k == "calibration" and v.startswith("budget")
              for k, v in new_plan.provenance),
          "recovery budget spend recorded in provenance")
    check(" calib[" in s["describe"],
          f"describe() surfaces calibration provenance counts: "
          f"{s['describe']}")
    # 3. the final state is the new plan's shards, and the last
    #    checkpoint restores and cuts onto them bit for bit
    check(all(r["shard_shapes"] == r["want_shapes"] for r in stay),
          "final params are the surviving mesh's shards")
    check(all(r["restored_equal"] for r in stay),
          f"manager.restore of step {s['restored_step']}, cut for the "
          f"surviving mesh, equals the final params")
    # 4. loss continuity: the interrupted and shrunk run replays the
    #    uninterrupted trajectory
    base = {int(k): v for k, v in s["base"].items()}
    losses = {int(k): v for k, v in s["losses"].items()}
    check(sorted(losses) == list(range(TOTAL_STEPS)),
          f"all {TOTAL_STEPS} steps committed: {sorted(losses)}")
    drift = max(abs(losses[t] - base[t]) / max(1.0, abs(base[t]))
                for t in base)
    check(drift < 5e-4, f"loss trajectory continuous vs uninterrupted run "
                        f"(max rel drift {drift:.2e})")
    print("[elastic-smoke] PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
