"""Plan-lifecycle smoke gate (counterpart of ``repro.launch.plan_smoke``),
on one device: CUDA unless ``--device cpu``.

    search -> save JSON -> load -> equal contexts through the train and the
    paged builders -> 3 training steps from the loaded plan

then the paper's 21 plans (:func:`paper_plans`) against
``BENCH_paper_plans.json``, key for key (:func:`stored_paper_plans`).
Exits non-zero on the first mismatch.

    PYTHONPATH=src python -m repro_torch.launch.plan_smoke --device cpu \\
        --reduced
    PYTHONPATH=src python -m repro_torch.launch.plan_smoke     # on the card

The model is gpt-m2 at its own 4 layers, b = 1, s = 2048 (``--reduced``:
its reduced config at s = 32); the search is ``launch.train.pick_plan`` on
``h100-sxm-8`` at TP degree 1: one device runs only DeviceMesh(1, 1).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
from pathlib import Path

#: the paper's defaults for its tables (batch 4, sequence 2048)
BATCH, SEQ = 4, 2048

#: the measured IC1 bandwidths (B1, B2) in GB/s the paper's §5.3 ranks
#: with, per (d1, d2): Fig. 10 and Fig. 11 use these pairs
IC1_FIG10 = {(2, 4): (1.20, 4.95), (8, 1): (0.97, 0.97),
             (4, 2): (1.10, 2.5), (1, 8): (0.97, 0.97)}
IC1_FIG11 = {(2, 4): (1.20, 4.95), (8, 1): (0.97, 0.97)}

#: the stored plans, at the root of the repository
PAPER_PLANS_FILE = Path(__file__).resolve().parents[3] / "BENCH_paper_plans.json"


def paper_plans() -> dict[str, dict]:
    """``{key: plan.to_dict()}`` for the 21 plans of the paper's Fig. 10
    (IC1-IC4 x gpt-m1..m4) and Fig. 11 (gpt-m3 on five interconnects):
    the same ``plan_search`` calls, with the same calibration pairs, as the
    reference's paper tables, whose output ``BENCH_paper_plans.json``
    holds."""
    from repro_torch.configs.registry import PAPER_MODELS
    from repro_torch.core import comm_matrix as cm
    from repro_torch.core.calibrate import CalibrationTable
    from repro_torch.core.plan import plan_search

    def table(pairs):
        return (CalibrationTable.from_pairs(pairs, source="paper-measured")
                if pairs else None)

    out = {}
    fig10 = {
        "IC1(PCIe)": (cm.ic1_pcie_8gpu(), 8, IC1_FIG10),
        "IC2(dualNVL)": (cm.ic2_dual_nvlink_8gpu(), 8, None),
        "IC3(NVSwitch)": (cm.ic3_nvswitch_8gpu(), 8, None),
        "IC4(IB)": (cm.ic4_ib_cluster_16gpu(), 16, None),
    }
    for ic, (matrix, n, pairs) in fig10.items():
        for name, model in PAPER_MODELS.items():
            out[f"fig10/{ic}/{name}"] = plan_search(
                matrix, n, model=model, batch=BATCH, seq=SEQ,
                calibration=table(pairs)).best.to_dict()
    fig11 = {
        "IC1(PCIe,calib)": (cm.ic1_pcie_8gpu(), 8, IC1_FIG11),
        "IC2(dualNVL)": (cm.ic2_dual_nvlink_8gpu(), 8, None),
        "IC3(NVSwitch)": (cm.ic3_nvswitch_8gpu(), 8, None),
        "IC4(IB)": (cm.ic4_ib_cluster_16gpu(), 16, None),
        "TPUv5e-row": (cm.tpu_v5e_pod(), 16, None),
    }
    m3 = PAPER_MODELS["gpt-m3"]
    for ic, (matrix, n, pairs) in fig11.items():
        out[f"fig11/{ic}"] = plan_search(
            matrix, n, model=m3, batch=BATCH, seq=SEQ,
            calibration=table(pairs)).best.to_dict()
    return out


def stored_paper_plans() -> dict[str, dict]:
    """``BENCH_paper_plans.json`` as ``to_dict()`` gives it today.  The file
    predates the calibration entries' ``provenance`` field (plan format
    v5), so each stored dict goes through ``ParallelPlan.from_dict``,
    whose migration gives a pre-v5 entry ``"measured"``; nothing else
    changes."""
    from repro_torch.core.plan import ParallelPlan

    stored = json.loads(PAPER_PLANS_FILE.read_text())
    return {k: ParallelPlan.from_dict(d).to_dict() for k, d in stored.items()}


def check(ok: bool, what: str) -> None:
    if not ok:
        print(f"[plan-smoke] FAIL: {what}")
        sys.exit(1)
    print(f"[plan-smoke] ok: {what}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced gpt-m2 at s = 32 (CPU-sized)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.mesh import resolve_device
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch.steps import build_paged_step, build_train_step
    from repro_torch.launch.train import pick_plan
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    device = resolve_device(args.device)
    cfg = get_config("gpt-m2")
    seq, batch = 2048, 1
    if args.reduced:
        cfg, seq = cfg.reduced(), 32

    # 1. search the one mesh a single device runs, on the card's fabric
    plan = pick_plan(cfg, 1, seq, batch, "h100-sxm-8").best
    check((plan.d1, plan.d2) == (1, 1), f"searched {plan.describe()}")

    # 2. the JSON round trip: the saved artifact is the strategy
    with tempfile.TemporaryDirectory() as td:
        loaded = ParallelPlan.load(plan.save(os.path.join(td, "plan.json")))
    check(loaded == plan, "plan JSON round trip is exact")

    # 3. equal contexts from the searched and the loaded plan, through the
    #    train and the paged builders, with the plan's knobs in them
    slots = 4 if lm.is_recurrent(cfg) else None
    opt_cfg = adamw.AdamWConfig(warmup_steps=2)
    _, t_info = build_train_step(cfg, opt_cfg=opt_cfg, device=device,
                                 plan=plan)
    step, t_info2 = build_train_step(cfg, opt_cfg=opt_cfg, device=device,
                                     plan=loaded)
    check(t_info.ctx == t_info2.ctx, "train ATPContext equal (saved vs "
                                     "searched plan)")
    _, p_info = build_paged_step(cfg, device=device, slots=slots, plan=plan)
    _, p_info2 = build_paged_step(cfg, device=device, slots=slots,
                                  plan=loaded)
    check(p_info.ctx == p_info2.ctx, "paged ATPContext equal")
    check((t_info.ctx.chunks, t_info.ctx.segment_plans)
          == (plan.chunks, plan.segments), "builder kept the plan's knobs")

    # 4. three training steps from the loaded plan
    params = lm.shard_params(cfg, lm.init_params(cfg, device=device),
                             lm.layout_context(loaded.topo(), 0))
    opt = adamw.init_opt_state(params, t_info2.ctx, "zero1")
    src = TokenSource(DataConfig(cfg.vocab_size, seq, batch))
    losses = []
    for i in range(3):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in src.host_batch(i, 0, 1).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    check(all(math.isfinite(x) for x in losses),
          f"3 training steps under {loaded.describe()}: losses {losses}")

    # 5. the paper's plans, searched here, against the stored ones
    want = stored_paper_plans()
    got = paper_plans()
    check(sorted(got) == sorted(want), f"{len(got)} paper plans")
    for key in sorted(want):
        check(got[key] == want[key], f"paper plan {key}")
    print("[plan-smoke] PASS")


if __name__ == "__main__":
    main()
