"""The port's calibration (``repro_torch.core.calibrate``'s measuring
half) against the reference's.

On four gloo ranks on the CPU (one process each, joined through a file
store under ``tmp_path``; ``_torch_calibrate_worker.py``) the
micro-benchmarks fill every field the reference's own tests check of
``calibrate_mesh`` on its host devices (``tests/test_plan.py``,
``test_quant.py``, ``test_segments.py``), every rank builds the same
table, none of the calibration's collectives lands in the collective
record, and a deadline run whose ranks' clocks differ ends on every rank
with one plan.  Without processes, ``recalibrate_surviving`` with an
injected benchmark and a scripted clock gives the reference's table,
provenance and tags on the same inputs (``test_robustness.py``,
``test_fault_tolerance.py``).  No number here is a card's: gloo on the
host times the host.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core import calibrate as ref_calibrate  # noqa: E402
from repro.core import plan as ref_plan  # noqa: E402
from repro_torch.core import calibrate  # noqa: E402
from repro_torch.core import plan as port_plan  # noqa: E402
from repro_torch.core.calibrate import CalibEntry, CalibrationTable  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_calibrate_worker.py"
WORLD = 4
#: the deadline run: rank 0's clock advances ``tick`` a reading, so its
#: first factorization spends the budget and the rest fall back
DEADLINE = dict(deadline_s=1.0, tick=0.1)
#: the sleep of the one slow rank of ``_time_fn``'s samples
STRAGGLE_S = 0.05


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of one four-rank spawn."""
    case_dir = tmp_path_factory.mktemp("calibrate")
    (case_dir / "case.json").write_text(json.dumps(dict(
        DEADLINE, straggle_s=STRAGGLE_S)))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r),
                               str(WORLD), str(case_dir)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=150)[0] for p in procs]
    finally:  # a rank that died leaves the others waiting in a collective
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return [json.loads((case_dir / f"rank{r}.json").read_text())
            for r in range(WORLD)]


def test_calibrate_mesh_on_gloo_ranks(ranks):
    """``test_calibrate_mesh_on_host_devices``, and the measured alpha of
    ``test_calibrate_mesh_measures_alpha``."""
    tab = CalibrationTable.from_dict(ranks[0]["tp2"])
    assert {k for k, _ in tab.entries} == {(1, 2), (2, 1)}
    e = tab.get(2, 1)
    assert e.b1 > 0 and math.isinf(e.b2)
    assert e.boundary_mode in ("psum", "ring")
    assert CalibrationTable.from_dict(tab.to_dict()) == tab
    for _, e in tab.entries:
        assert e.alpha_s is not None and e.alpha_s > 0.0
        assert e.provenance == "measured"
    assert tab.alpha(2, 1) == tab.get(2, 1).alpha_s
    assert math.isinf(tab.get(1, 2).b1) and tab.get(1, 2).b2 > 0


def test_calibrate_mesh_measures_quant_and_launch(ranks):
    """``test_calibrate_mesh_measures_quant_and_launch``: launch_s, alpha_s
    and the quantized bandwidths of every factorization of tp 4."""
    t = CalibrationTable.from_dict(ranks[0]["tp4"])
    assert {k for k, _ in t.entries} == {(1, 4), (2, 2), (4, 1)}
    for key in ((4, 1), (2, 2), (1, 4)):
        e = dict(t.entries)[key]
        assert e.launch_s is not None and e.launch_s >= 0.0
        assert e.alpha_s is not None and e.alpha_s > 0.0
        assert e.t_psum > 0 and e.t_ring > 0
        q = t.quant_bandwidths(*key)
        assert q is not None
        assert all(b > 0 for b in q)
        assert [c for c, _, _ in e.chunk_eff] == [2, 4]
        assert all(0 < x <= 1.0 for _, *eff in e.chunk_eff for x in eff)
    back = CalibrationTable.from_dict(json.loads(json.dumps(t.to_dict())))
    assert back == t


@pytest.mark.parametrize("what", ["tp2", "tp4", "deadline", "picked"])
def test_every_rank_holds_the_same_result(ranks, what):
    """One table (and one plan) on every rank: the samples are the slowest
    rank's and the budget's decisions the first rank's."""
    for r in range(1, WORLD):
        assert ranks[r][what] == ranks[0][what], f"rank {r} differs"


def test_every_sample_is_the_slowest_ranks(ranks):
    """A call that only the last rank makes slow times as slow on every
    rank: the seconds are agreed by an all-reduce MAX."""
    for r in ranks:
        assert STRAGGLE_S <= r["slowest"] < 20 * STRAGGLE_S
    assert len({r["slowest"] for r in ranks}) == 1


def test_calibration_is_not_recorded_as_a_step(ranks):
    assert all(r["recorded"] == 0 for r in ranks)


def test_deadline_run_with_differing_clocks_ends_with_one_plan(ranks):
    """Rank 0's clock spends the budget on the first factorization; the
    others' stand still, and would measure every one on their own."""
    got = ranks[0]["deadline"]
    tab = CalibrationTable.from_dict(got["calibration"])
    prov = [e.provenance for k, e in tab.entries if k[0] * k[1] == 4]
    assert prov.count("measured") == 1
    assert set(prov) - {"measured"} <= {"carried", "analytic"}
    assert "deadline-budgeted" in tab.source
    budget = [v for k, v in got["provenance"] if v.startswith("budget")]
    assert len(budget) == 1 and "measured=1 " in budget[0]


def test_pick_plan_with_calibration_on_gloo_ranks(ranks):
    """``pick_plan(calibrate=True)`` on four ranks carries the measured
    table of every factorization of tp 4 into the plan."""
    plan = port_plan.ParallelPlan.from_dict(ranks[0]["picked"])
    assert plan.tp == 4
    assert {k for k, _ in plan.calibration.entries} == {(1, 4), (2, 2),
                                                        (4, 1)}
    assert plan.calibration.source == "measured"


# ---------------------------------------------------------------------------
# recalibrate_surviving without processes, against the reference.
# ---------------------------------------------------------------------------


def _budget_fixture(pkg, plan_mod):
    """``test_robustness.budget_fixture`` for either package."""
    old = pkg.CalibrationTable(entries=(
        ((4, 1), pkg.CalibEntry(b1=10.0, b2=float("inf"))),
        ((2, 2), pkg.CalibEntry(b1=9.0, b2=8.0)),
    ), source="measured")
    plan = plan_mod.ParallelPlan(d1=4, d2=1, dp=1, topology="ic3",
                                 calibration=old)
    clock = [0.0]

    def timer():
        return clock[0]

    def measure(d1, d2):
        clock[0] += 1.0
        return pkg.CalibEntry(b1=100.0, b2=100.0)

    return plan, clock, timer, measure


def _fault_plan(pkg, plan_mod):
    """``test_fault_tolerance``'s plan and benchmark."""
    tab = pkg.CalibrationTable.from_pairs(
        {(2, 2): (1.0, 2.0), (4, 1): (0.5, 0.5)}, source="unit")
    plan = plan_mod.ParallelPlan(d1=2, d2=2, dp=2, topology="ic3",
                                 calibration=tab)

    def measure(d1, d2):
        return pkg.CalibEntry(b1=10.0 * d1, b2=5.0 * d2, t_psum=1e-5,
                              t_ring=2e-5, alpha_s=1e-6)

    return plan, measure


def _same(got, want):
    assert got.calibration.to_dict() == want.calibration.to_dict()
    assert tuple(got.provenance) == tuple(want.provenance)
    assert got.calibration_stale == want.calibration_stale
    assert got.describe() == want.describe()


@pytest.mark.parametrize("deadline", [None, 0.0, 0.5, 1.0, 1.5, 2.5, 10.0])
def test_recalibrate_surviving_under_a_deadline_equals_the_reference(
        deadline):
    port, pclock, ptimer, pmeasure = _budget_fixture(calibrate, port_plan)
    ref, rclock, rtimer, rmeasure = _budget_fixture(ref_calibrate, ref_plan)
    got = calibrate.recalibrate_surviving(
        port, devices=list(range(4)), measure=pmeasure, deadline_s=deadline,
        timer=ptimer)
    want = ref_calibrate.recalibrate_surviving(
        ref, devices=list(range(4)), measure=rmeasure, deadline_s=deadline,
        timer=rtimer)
    _same(got, want)
    assert pclock[0] == rclock[0]


@pytest.mark.parametrize("survivors", [2, 4])
def test_recalibrate_after_a_shrink_equals_the_reference(survivors):
    """Shrink, recalibrate and re-plan (``replan_elastic``): the same
    tables, tags and plans as the reference's."""
    port, pmeasure = _fault_plan(calibrate, port_plan)
    ref, rmeasure = _fault_plan(ref_calibrate, ref_plan)
    stale_p = port_plan.replan_elastic(port, survivors)
    stale_r = ref_plan.replan_elastic(ref, survivors)
    _same(stale_p, stale_r)
    got = calibrate.recalibrate_surviving(
        stale_p, devices=list(range(survivors)), measure=pmeasure)
    want = ref_calibrate.recalibrate_surviving(
        stale_r, devices=list(range(survivors)), measure=rmeasure)
    _same(got, want)
    assert not got.calibration_stale
    _same(port_plan.replan_elastic(got, survivors),
          ref_plan.replan_elastic(want, survivors))


def test_measuring_needs_the_ranks_it_names():
    """One process measures nothing it would need a group for: (1, 1) is
    the trivial entry, every larger factorization is skipped."""
    tab = calibrate.calibrate_mesh(4)
    assert tab.entries == () and tab.source == "measured"
    trivial = calibrate.calibrate_mesh(1).get(1, 1)
    assert math.isinf(trivial.b1) and math.isinf(trivial.b2)
    assert trivial.chunk_eff == ((2, 1.0, 1.0), (4, 1.0, 1.0))
    with pytest.raises(ValueError, match="needs 4 ranks"):
        calibrate._measure_factorization(2, 2, 1024, 1, devices=[0])
