"""Chaos smoke gate (counterpart of ``repro.launch.chaos_smoke``): scripted
faults, end to end, on gloo ranks on the CPU.

Five seeded scenarios drive the fault-domain runtime through its
recovery invariants and exit non-zero on any violation:

  S1  membership-elastic, 8 ranks: device loss kills 2 of 4 simulated
      hosts (2 ranks each) while a lease-delay fault makes a survivor
      look suspect; the loop must converge on ONE quorum-committed view
      per epoch, the 4 ranks outside it leave, the 4 survivors join a new
      group, re-plan once on the agreed pool and replay to loss continuity
      against an uninterrupted run.
  S2  deadline-budgeted recalibration under a scripted clock (this
      process, no ranks): the spend stays within ``deadline_s``, the most
      sensitive factorizations measured first, the rest degraded to
      carried/analytic entries with provenance recorded in the plan.
  S3  server degradation, 2 ranks: a backpressure window and per-request
      deadlines walk the full ladder (admission backoff, skipped beats,
      expiry) and the page pool must fully drain.
  S4  decode-mesh shrink, 4 ranks: ``launch.serve.remesh_paged_server``
      takes the server from (1, 2, 2) to (1, 2, 1); 2 ranks leave, and the
      2 survivors replay the in-flight prefill on a new group with
      greedy-token parity for every request.
  S5  torn checkpoint write and straggler window, 2 ranks: the torn save
      is counted, retried and swept by the trainer on every rank (not
      fatal), the straggler trips the watchdog.

    PYTHONPATH=src python -m repro_torch.launch.chaos_smoke [--out FILE]

Each scenario's ranks are processes of this module (``--scenario``,
``--rank``), joined by one gloo group through a ``file://`` store under a
temporary directory; a shrink re-joins the survivors on a new store
(``launch.train.file_store_regroup``), and a rank that leaves
(``launch.train.Departed``) writes what it saw and exits 0.  The metrics
are printed, and written to ``--out`` where it is given.  The reference's
static conformance lint (ROADMAP A13c) is not ported, so neither smoke
runs it.  ``spawn`` and ``elastic_run`` also serve the elastic smoke and
the tests.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

#: seconds a scenario waits for its ranks
RANK_TIMEOUT = 300
FAIL_STEP = 5
TOTAL_STEPS = 8


def check(ok: bool, what: str):
    if not ok:
        print(f"[chaos-smoke] FAIL: {what}", flush=True)
        sys.exit(1)
    print(f"[chaos-smoke] ok: {what}", flush=True)


def tiny_cfg(num_kv_heads: int = 2):
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(name="smoke-chaos", family="dense", num_layers=2,
                       d_model=64, num_heads=4, num_kv_heads=num_kv_heads,
                       d_ff=128, vocab_size=256, head_dim=16,
                       dtype="float32")


# ---------------------------------------------------------------------------
# Ranks.
# ---------------------------------------------------------------------------


def spawn(scenario: str, world: int, work: Path, case: dict | None = None,
          module: str = "repro_torch.launch.chaos_smoke") -> list[dict]:
    """Run ``scenario`` of ``module`` on ``world`` gloo ranks, a process
    each, with ``case`` (JSON) in ``work``; returns each rank's result.
    Raises with the rank's output where one failed."""
    work.mkdir(parents=True, exist_ok=True)
    (work / "case.json").write_text(json.dumps(case or {}))
    src = Path(__file__).resolve().parents[2]
    env = dict(os.environ, PYTHONPATH=str(src) + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    cmd = [sys.executable, "-m", module, "--scenario", scenario, "--world",
           str(world), "--work", str(work)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:   # a rank that died leaves the others waiting
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"{scenario} rank {r} failed (exit "
                               f"{p.returncode}):\n{log}")
    return [json.loads((work / f"{scenario}{r}.json").read_text())
            for r in range(world)]


def rank_main(scenarios: dict, scenario: str, rank: int, world: int,
              work: Path) -> None:
    """One rank: join the gloo group, run ``scenarios[scenario](rank,
    world, work, case)`` and write its result; a rank that leaves the run
    writes ``{"departed": why}``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.train import Departed

    torch.set_num_threads(1)
    case = json.loads((work / "case.json").read_text())
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=world)
    try:
        out = scenarios[scenario](rank, world, work, case)
    except Departed as e:
        out = {"departed": e.why}
    (work / f"{scenario}{rank}.json").write_text(json.dumps(out))
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def global_params(cfg, case: dict):
    """The global tree the case names (``params``: an ``.npz`` of the JAX
    package's leaves by their ``/`` paths), or the port's seeded init."""
    import numpy as np

    from repro_torch import convert
    from repro_torch.models import lm

    if not case.get("params"):
        return lm.init_params(cfg, seed=0, device="cpu")
    tree: dict = {}
    with np.load(case["params"]) as z:
        for key in z.files:
            *path, leaf = key.split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = convert.to_torch(z[key])
    return tree


def elastic_run(cfg, plan, ckpt_dir: str, work: Path, *, rank: int,
                n_hosts: int, total_steps: int = TOTAL_STEPS,
                fplan=None, measure=None, recalib_deadline_s=None,
                init_params=None):
    """One fault-tolerant training run of every rank
    (``make_elastic_trainer``; batch 8, seq 32, zero1, a checkpoint every 2
    steps): the ranks split over ``n_hosts`` simulated hosts on a
    membership fabric every rank simulates alike, ``fplan``'s device losses
    and lease delays injected.  Returns (trainer, live, fabric, each
    step's loss); ``live["params"]`` holds the run's final parameters."""
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch.train import (file_store_regroup, job_ranks,
                                          make_elastic_trainer)
    from repro_torch.optim import adamw
    from repro_torch.runtime.faults import delivery_schedule, trainer_injector
    from repro_torch.runtime.membership import (MembershipRuntime,
                                                fabric_over_devices)
    from repro_torch.runtime.trainer import TrainerConfig

    ranks = job_ranks()
    delivery = delivery_schedule(fplan) if fplan is not None else None
    fabric = fabric_over_devices(n_hosts, ranks, delivery=delivery)
    injector = (trainer_injector(fplan, fabric)
                if fplan is not None else None)
    source = TokenSource(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=8))
    per_host = len(ranks) // n_hosts
    trainer, live = make_elastic_trainer(
        cfg, plan, adamw.AdamWConfig(lr=1e-3, mode="zero1",
                                     total_steps=total_steps),
        TrainerConfig(total_steps=total_steps, ckpt_dir=ckpt_dir,
                      ckpt_every=2, max_failures=2),
        source, batch=8, seq=32,
        membership=MembershipRuntime(fabric, local_rank=rank // per_host),
        recalibrate=True, measure=measure,
        recalib_deadline_s=recalib_deadline_s, device="cpu",
        init_params=init_params, regroup=file_store_regroup(str(work)))
    live["params"], _ = trainer.run(fail_injector=injector)
    losses = {h["step"]: h["loss"] for h in trainer.history}
    return trainer, live, fabric, losses


# ---------------------------------------------------------------------------
# S1: membership-driven elastic recovery under device loss + lease delay.
# ---------------------------------------------------------------------------


def s1_fault_plan():
    from repro_torch.runtime.faults import FaultEvent, FaultPlan

    # hosts 2+3 die at step 5; host 1's heartbeats lag 0.25 s for the first
    # simulated second, long enough to flicker past lease_s, so hosts 0
    # and 1 disagree while both detect the death: the quorum must hold the
    # reshard until they agree on (0, 1)
    return FaultPlan.scripted(
        FaultEvent("device_loss", at=FAIL_STEP, hosts=(2, 3)),
        FaultEvent("lease_delay", at=0.0, hosts=(1,), duration=1.0,
                   severity=0.25),
        seed=1001)


def s1_plan():
    from repro_torch.core.plan import plan_search

    return plan_search("ic3", 4, model=tiny_cfg(), batch=8, seq=32,
                       dp=2).best


def s1_rank(rank, world, work, case) -> dict:
    """S1 on every rank: the uninterrupted run, then the chaos run."""
    plan = s1_plan()
    _, _, _, base = elastic_run(tiny_cfg(), plan, str(work / "base"), work,
                                rank=rank, n_hosts=4)
    out = {"plan": plan.to_dict(), "base": base}
    tr, live, fabric, losses = elastic_run(
        tiny_cfg(), plan, str(work / "chaos"), work, rank=rank, n_hosts=4,
        fplan=s1_fault_plan(), recalib_deadline_s=120.0)
    final = fabric.hosts[0].committed
    out.update(
        replans=tr.replans, losses=losses,
        epochs={str(e): sorted(v) for e, v in fabric.epochs().items()},
        final=[list(final.alive), final.planner],
        new_plan=live["plan"].to_dict(),
        t_commit=min(c.t for c in fabric.commits if c.view.epoch == 1))
    return out


def scenario_membership_elastic(metrics, work: Path):
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.runtime.faults import FaultPlan

    fplan = s1_fault_plan()
    check(FaultPlan.from_dict(fplan.to_dict()) == fplan,
          "S1 FaultPlan JSON round-trips")
    res = spawn("s1", 8, work)
    plan = ParallelPlan.from_dict(res[0]["plan"])
    check(plan.devices == 8, f"S1 plan uses the full pod: {plan.describe()}")
    left = [r for r in res if "departed" in r]
    stay = [r for r in res if "departed" not in r]
    check(len(left) == 4 and len(stay) == 4,
          f"S1 the 4 ranks outside the view left: "
          f"{[r['departed'] for r in left]}")
    s = stay[0]
    check(all(r["replans"] == [FAIL_STEP] for r in stay),
          f"S1 exactly one re-plan despite concurrent detectors: "
          f"{s['replans']}")
    check(bool(s["epochs"]) and all(len(v) == 1
                                    for v in s["epochs"].values()),
          f"S1 one committed view per epoch (no split-brain): "
          f"{s['epochs']}")
    check(s["final"] == [[0, 1], 0],
          f"S1 converged on the survivor set with host 0 planning: "
          f"{s['final']}")
    new_plan = ParallelPlan.from_dict(s["new_plan"])
    check(new_plan.devices <= 4 and not new_plan.calibration_stale,
          f"S1 re-plan fits 4 survivors, recalibrated: "
          f"{new_plan.describe()}")
    check(all(r["new_plan"] == s["new_plan"] for r in stay),
          "S1 every survivor runs the planner's plan")
    check(any(k == "calibration" and v.startswith("budget")
              for k, v in new_plan.provenance),
          "S1 recovery budget spend recorded in plan provenance")
    base = {int(k): v for k, v in s["base"].items()}
    losses = {int(k): v for k, v in s["losses"].items()}
    check(sorted(losses) == list(range(TOTAL_STEPS)),
          f"S1 all {TOTAL_STEPS} steps committed")
    drift = max(abs(losses[t] - base[t]) / max(1.0, abs(base[t]))
                for t in base)
    check(drift < 5e-4, f"S1 loss continuity after shrink "
                        f"(max rel drift {drift:.2e})")
    metrics["loss_continuity"] = 1.0
    metrics["single_replanner"] = 1.0
    metrics["recovery_sim_s"] = round(s["t_commit"], 3)


# ---------------------------------------------------------------------------
# S2: deadline-budgeted recalibration under a scripted clock.
# ---------------------------------------------------------------------------


def scenario_budget(metrics):
    from repro_torch.core.calibrate import (CalibEntry, CalibrationTable,
                                            recalibrate_surviving)
    from repro_torch.core.plan import ParallelPlan, replan_elastic

    cfg = tiny_cfg()
    old = CalibrationTable(entries=(
        ((4, 1), CalibEntry(b1=10.0, b2=float("inf"))),
        ((2, 2), CalibEntry(b1=9.0, b2=8.0)),
        ((1, 4), CalibEntry(b1=float("inf"), b2=7.0)),
    ), source="measured")
    plan = ParallelPlan(d1=4, d2=1, dp=2, topology="ic3", calibration=old,
                        provenance=(("calibration", "stale"),))
    clock = [0.0]

    def timer():
        return clock[0]

    def measure(d1, d2):
        clock[0] += 1.0   # every factorization costs 1 scripted second
        return CalibEntry(b1=100.0, b2=100.0)

    deadline = 1.5
    new = recalibrate_surviving(plan, devices=list(range(4)),
                                measure=measure, deadline_s=deadline,
                                timer=timer)
    spent = clock[0]
    check(spent <= deadline,
          f"S2 recalibration stayed within deadline_s "
          f"({spent:.1f}s <= {deadline}s)")
    counts = new.calibration.provenance_counts()
    check(counts.get("measured", 0) == 1 and counts.get("carried", 0) == 2,
          f"S2 budget degraded the tail to carried entries: {counts}")
    check(" calib[" in new.describe(),
          f"S2 describe() shows provenance counts: {new.describe()}")
    check(any(k == "calibration" and v.startswith("budget")
              for k, v in new.provenance),
          "S2 budget spend recorded in provenance")
    replanned = replan_elastic(new, 4, model=cfg, batch=8, seq=32)
    check(not replanned.calibration_stale,
          f"S2 re-planned artifact not stale: {replanned.describe()}")
    clock[0] = 0.0
    empty = recalibrate_surviving(plan, devices=list(range(4)),
                                  measure=measure, deadline_s=0.0,
                                  timer=timer)
    check(empty.calibration.provenance_counts().get("measured", 0) == 0
          and not any(v.startswith("recalibrated")
                      for _, v in empty.provenance),
          "S2 fully-exhausted budget does not claim recalibration")
    metrics["budget_respected"] = 1.0


# ---------------------------------------------------------------------------
# S3 + S4: server degradation ladder and decode-mesh shrink parity.
# ---------------------------------------------------------------------------


def _make_server(cfg, params, topo, *, num_pages):
    from repro_torch.launch.serve import make_paged_server
    from repro_torch.models.paging import PagedConfig
    from repro_torch.runtime.server import ServerConfig

    scfg = ServerConfig(batch_slots=2, prefill_chunk=4,
                        paged=PagedConfig(page_size=4, num_pages=num_pages,
                                          pages_per_slot=8))
    server, _ = make_paged_server(cfg, scfg, params, topo=topo,
                                  device="cpu")
    return server


def s3_rank(rank, world, work, case) -> dict:
    import numpy as np

    from repro_torch.core.mesh import atp_topo
    from repro_torch.runtime.faults import (BackpressureAllocator,
                                            FaultEvent, FaultPlan)
    from repro_torch.runtime.server import Request

    cfg = tiny_cfg(num_kv_heads=4)
    rng = np.random.default_rng(3)
    server = _make_server(cfg, global_params(cfg, case), atp_topo(1, 2, 1),
                          num_pages=40)
    fplan = FaultPlan.scripted(
        FaultEvent("backpressure", at=2, duration=12), seed=1003)
    bp = BackpressureAllocator(server.alloc, fplan, lambda: server.ticks)
    server.alloc = bp
    for rid in range(6):
        p = rng.integers(0, cfg.vocab_size, size=6, dtype=np.int32)
        # 4 deadlined requests die inside the window; 2 patient ones must
        # survive it and complete
        server.submit(Request(rid=rid, prompt=p, max_new=6,
                              deadline_ticks=12 if rid < 4 else None))
    server.run_until_drained()
    st = server.stats()
    return {"denied": bp.denied, "retries": st["admission_retries"],
            "expired": st["expired"],
            "expired_marked": all(r.expired and not r.done
                                  for r in server.expired),
            "completed": sorted(r.rid for r in server.completed),
            "drained": server.alloc.held_pages == 0 and not server.busy}


def scenario_server_degradation(metrics, work: Path):
    r = spawn("s3", 2, work)[0]
    check(r["denied"] > 0, f"S3 backpressure window denied allocations "
                           f"({r['denied']})")
    check(r["retries"] > 0, f"S3 admissions retried with backoff "
                            f"({r['retries']} retries)")
    check(r["expired"] > 0, f"S3 deadlined requests expired under pressure "
                            f"({r['expired']}/6)")
    check(r["expired_marked"], "S3 expired requests marked expired")
    check(r["completed"] == [4, 5],
          f"S3 patient requests completed: {r['completed']}")
    check(r["drained"],
          "S3 page pool fully drained (expired requests returned pages)")
    metrics["pool_drained"] = 1.0
    metrics["served_fraction"] = len(r["completed"]) / 6.0
    metrics["expired_request_rate"] = r["expired"] / 6.0


def s4_prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(4)
    return [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
            for n in (5, 9, 7, 12)]


def s4_rank(rank, world, work, case) -> dict:
    """The uninterrupted server on (1, 2, 2), then one stepped 7 ticks and
    remeshed onto (1, 2, 1): ranks 2 and 3 leave."""
    from repro_torch.core.mesh import atp_topo
    from repro_torch.launch.serve import remesh_paged_server
    from repro_torch.launch.train import file_store_regroup
    from repro_torch.runtime.server import Request

    cfg = tiny_cfg(num_kv_heads=4)
    prompts = s4_prompts(cfg)
    base = _make_server(cfg, global_params(cfg, case), atp_topo(1, 2, 2),
                        num_pages=40)
    for rid, p in enumerate(prompts):
        base.submit(Request(rid=rid, prompt=p.copy(), max_new=6))
    base.run_until_drained()
    out = {"base": {r.rid: [int(t) for t in r.out] for r in base.completed}}
    srv = _make_server(cfg, global_params(cfg, case), atp_topo(1, 2, 2),
                       num_pages=40)
    for rid, p in enumerate(prompts):
        srv.submit(Request(rid=rid, prompt=p.copy(), max_new=6))
    for _ in range(7):
        srv.step()   # leave some requests mid-prefill or mid-decode
    out["in_flight"] = sum(s is not None for s in srv.slots) + len(srv.queue)
    remesh_paged_server(srv, cfg, global_params(cfg, case),
                        topo=atp_topo(1, 2, 1), device="cpu",
                        regroup=file_store_regroup(str(work)))
    srv.run_until_drained()
    out.update(out={r.rid: [int(t) for t in r.out] for r in srv.completed},
               reshapes=srv.stats()["reshapes"],
               held=srv.alloc.held_pages)
    return out


def scenario_remesh_parity(metrics, work: Path):
    res = spawn("s4", 4, work)
    check([("departed" in r) for r in res] == [False, False, True, True],
          "S4 ranks 2 and 3 left the remeshed server")
    r = res[0]
    check(r["in_flight"] > 0, f"S4 requests in flight at the shrink "
                              f"({r['in_flight']})")
    check(r["reshapes"] == 1, "S4 reshape counted")
    check(r["out"] == r["base"] and res[1]["out"] == r["out"],
          f"S4 greedy-token parity across the remesh for all "
          f"{len(r['out'])} requests")
    check(r["held"] == 0, "S4 pool drained after the remesh run")
    metrics["remesh_parity"] = 1.0


# ---------------------------------------------------------------------------
# S5: torn checkpoint write + straggler window.
# ---------------------------------------------------------------------------


def s5_rank(rank, world, work, case) -> dict:
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch.train import make_elastic_trainer
    from repro_torch.optim import adamw
    from repro_torch.runtime.faults import (FaultEvent, FaultPlan,
                                            TornCheckpointWrites,
                                            VirtualStepClock)
    from repro_torch.runtime.trainer import TrainerConfig

    cfg = tiny_cfg()
    plan = ParallelPlan(d1=2, d2=1, dp=1,
                        provenance=(("searcher", "chaos-smoke"),))
    fplan = FaultPlan.scripted(
        FaultEvent("torn_ckpt", at=4),
        FaultEvent("straggler", at=2, duration=1, severity=20.0),
        seed=1005)
    source = TokenSource(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=8))
    ckpt_dir = str(work / "ckpt")
    mitigated = []
    trainer, _ = make_elastic_trainer(
        cfg, plan, adamw.AdamWConfig(lr=1e-3, total_steps=6),
        TrainerConfig(total_steps=6, ckpt_dir=ckpt_dir, ckpt_every=2,
                      max_failures=2),
        source, batch=8, seq=32, recalibrate=False, device="cpu")
    trainer.time_fn = VirtualStepClock(fplan)
    trainer.mitigation_hook = mitigated.append
    with TornCheckpointWrites(fplan) as torn:
        trainer.run()
    return {"torn": torn.torn, "total_failures": trainer.total_failures,
            "latest": ckpt.latest_step(ckpt_dir),
            "tmps": [n for n in os.listdir(ckpt_dir)
                     if n.startswith(".tmp_")],
            "steps": len(trainer.history),
            "events": [e[0] for e in trainer.watchdog.events],
            "mitigated": mitigated}


def scenario_torn_checkpoint(metrics, work: Path):
    res = spawn("s5", 2, work)
    r = res[0]
    check(r["torn"] == [4] and res[1]["torn"] == [],
          f"S5 the writer's save torn exactly once: {r['torn']}")
    check(all(x["total_failures"] == 1 for x in res),
          f"S5 torn write counted in failure accounting on every rank "
          f"({[x['total_failures'] for x in res]})")
    check(r["latest"] == 6, f"S5 run completed through the torn save "
                            f"(latest ckpt step {r['latest']})")
    check(not r["tmps"], "S5 orphan .tmp_ staging dir swept on retry")
    check(all(x["steps"] == 6 for x in res), "S5 all 6 steps committed")
    check(all(2 in x["events"] for x in res),
          f"S5 scripted straggler tripped the watchdog: {r['events']}")
    check(r["mitigated"] == [2], f"S5 mitigation hook fired: "
                                 f"{r['mitigated']}")
    metrics["torn_ckpt_recovered"] = 1.0


SCENARIOS = {"s1": s1_rank, "s3": s3_rank, "s4": s4_rank, "s5": s5_rank}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="write the metrics (JSON) here")
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), default=None,
                    help="run as a rank of this scenario (started by the "
                         "gate)")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--work", default=None)
    args = ap.parse_args(argv)
    if args.scenario is not None:
        rank_main(SCENARIOS, args.scenario, args.rank, args.world,
                  Path(args.work))
        return 0
    metrics: dict = {}
    with tempfile.TemporaryDirectory() as td:
        work = Path(td)
        scenario_budget(metrics)           # cheapest first: host code
        scenario_torn_checkpoint(metrics, work / "s5")
        scenario_server_degradation(metrics, work / "s3")
        scenario_remesh_parity(metrics, work / "s4")
        scenario_membership_elastic(metrics, work / "s1")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=1, sort_keys=True)
    print(f"[chaos-smoke] metrics{' -> ' + args.out if args.out else ''}: "
          f"{json.dumps(metrics, sort_keys=True)}", flush=True)
    print("[chaos-smoke] PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
