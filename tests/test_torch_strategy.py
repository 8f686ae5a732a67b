"""The port's strategy stack against the reference's (ROADMAP A6).

``repro_torch.core.{comm_matrix, cost_model, search, plan}`` are copies of
the reference's pure-Python modules, so they are held to equality, not to a
tolerance: the cost functions give the same floats (``==``) on every
preset and knob, ``plan_search`` gives JSON-equal plans on IC1-IC6 for the
paper's GPT models and every config of the registry, the paper's 21 plans
equal ``BENCH_paper_plans.json``, and plan files cross between the two
packages unchanged.  Then the reference's own claims about plans and the
cost model, the contexts and builders a plan drives, the knobs the port
refuses (ROADMAP A7, A8), the launchers' plan flags, and one gloo run of a
searched plan against the reference's gradients.
"""
import dataclasses
import functools
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.core import comm_matrix as ref_cm  # noqa: E402
from repro.core import cost_model as ref_cost  # noqa: E402
from repro.core import plan as ref_plan  # noqa: E402
from repro.core import search as ref_search  # noqa: E402
from repro.core.atp import make_context as jax_make_context  # noqa: E402
from repro.core.calibrate import CalibrationTable as RefTable  # noqa: E402
from repro.core.calibrate import robust_seconds as ref_robust  # noqa: E402
from repro.core.compat import shard_map  # noqa: E402
from repro.core.mesh import MeshTopo as JaxMeshTopo  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import comm_matrix as cm  # noqa: E402
from repro_torch.core import cost_model  # noqa: E402
from repro_torch.core import search  # noqa: E402
from repro_torch.core.atp import (SEQ_PARALLEL_KINDS, ATPContext,  # noqa: E402
                                  DecodePlan, SegmentPlan, make_context)
from repro_torch.core.calibrate import (CalibEntry, CalibrationTable,  # noqa: E402
                                        calibrate_mesh, recalibrate_surviving,
                                        robust_seconds)
from repro_torch.core.mesh import atp_topo, factorizations  # noqa: E402
from repro_torch.core.plan import (ParallelPlan, PredictedCost,  # noqa: E402
                                   plan_search, replan_elastic)
from repro_torch.launch import plan_smoke, serve, train  # noqa: E402
from repro_torch.launch.steps import (build_paged_step,  # noqa: E402
                                      build_train_step, resolve_ctx)
from repro_torch.models import lm  # noqa: E402

from _torch_plan_worker import batch_of, finish, start  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
PROF = cost_model.LayerCommProfile.gpt(8192)
REF_PROF = ref_cost.LayerCommProfile.gpt(8192)
IC_PRESETS = ("ic1", "ic2", "ic3", "ic4", "ic5", "ic6")
#: every config the search reads: the paper's GPT models and the registry
MODELS = sorted(registry.PAPER_MODELS) + sorted(registry.ARCHS)
#: the measured IC1 pairs of the paper's §5.3
IC1_PAIRS = {(2, 4): (1.20, 4.95), (8, 1): (0.97, 0.97),
             (4, 2): (1.10, 2.5), (1, 8): (0.97, 0.97)}


def same(a, b) -> bool:
    """Two results of the two packages' functions, field for field."""
    if dataclasses.is_dataclass(a):
        return dataclasses.asdict(a) == dataclasses.asdict(b)
    return a == b


def jsons(plans) -> list[str]:
    return [json.dumps(p.to_dict(), sort_keys=True) for p in plans]


# ---------------------------------------------------------------------------
# The cost model, exactly.
# ---------------------------------------------------------------------------


def _fits(fn):
    """``fn()``'s value, or the ValueError's message where the mesh does
    not embed into the topology."""
    try:
        return fn()
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("preset", sorted(ref_cm.PRESETS))
def test_cost_functions_equal_the_references_exactly(preset):
    """``axis_algorithm_bw``, ``t_comm``, ``t_comm_overlap`` (chunks 1, 2,
    4, 8; sequence-parallel on and off; ring and Rabenseifner; alpha 0 and
    1e-5) and ``t_comm_decode`` on every factorization of every reference
    preset: the same floats."""
    m, rm = cm.PRESETS[preset](), ref_cm.PRESETS[preset]()
    assert same(m, rm)
    n = m.num_devices
    work = cost_model.segment_workloads(registry.get_config("zamba2-7b"))
    rwork = ref_cost.segment_workloads(ref_registry.get_config("zamba2-7b"))
    for d1, d2 in factorizations(n):
        assert _fits(lambda: cost_model.axis_algorithm_bw(m, d1, d2)) == \
            _fits(lambda: ref_cost.axis_algorithm_bw(rm, d1, d2))
        if isinstance(_fits(lambda: m.axis_bandwidths(d1, d2)), str):
            continue
        shape = dict(layers=4, batch=4, seq=2048)
        assert same(cost_model.t_comm(m, d1, d2, profile=PROF, **shape),
                    ref_cost.t_comm(rm, d1, d2, profile=REF_PROF, **shape))
        for chunks in (1, 2, 4, 8):
            for sp in (False, True):
                for algo in ("ring", "rabenseifner"):
                    for alpha in (0.0, 1e-5):
                        knobs = dict(chunks=chunks, seq_parallel=sp,
                                     algo=algo, alpha_s=alpha, **shape)
                        assert same(
                            cost_model.t_comm_overlap(m, d1, d2, profile=PROF,
                                                      **knobs),
                            ref_cost.t_comm_overlap(rm, d1, d2,
                                                    profile=REF_PROF,
                                                    **knobs)), knobs
        for alpha in (0.0, 1e-5):
            assert same(
                cost_model.t_comm_decode(m, d1, d2, workloads=work, batch=4,
                                         alpha_s=alpha),
                ref_cost.t_comm_decode(rm, d1, d2, workloads=rwork, batch=4,
                                       alpha_s=alpha))


#: the H100 presets' Eq. 3 raw and Eq. 4 algorithm bandwidths (B1', B2',
#: B1, B2) in GB/s for every factorization (their docstrings' table)
H100_BANDWIDTHS = {
    "h100-sxm-8": {(1, 8): (math.inf, 900.0, math.inf, 900 * 8 / 14),
                   (2, 4): (300.0, 900.0, 300.0, 600.0),
                   (4, 2): (900.0, 300.0, 600.0, 300.0),
                   (8, 1): (900.0, math.inf, 900 * 8 / 14, math.inf)},
    "h100-sxm-2x8": {(1, 16): (math.inf, 400.0, math.inf, 400 * 16 / 30),
                     (2, 8): (50.0, 900.0, 50.0, 900 * 8 / 14),
                     (4, 4): (100.0, 900.0, 100 * 4 / 6, 600.0),
                     (8, 2): (200.0, 300.0, 200 * 8 / 14, 300.0),
                     (16, 1): (400.0, math.inf, 400 * 16 / 30, math.inf)},
}


@pytest.mark.parametrize("preset", sorted(H100_BANDWIDTHS))
def test_h100_presets_per_dim_bandwidths(preset):
    m = cm.PRESETS[preset]()
    want = H100_BANDWIDTHS[preset]
    assert sorted(want) == factorizations(m.num_devices)
    for (d1, d2), bw in want.items():
        assert cost_model.axis_algorithm_bw(m, d1, d2) == pytest.approx(bw)


# ---------------------------------------------------------------------------
# The search, as JSON.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", IC_PRESETS)
def test_plan_search_equals_the_references_on_every_config(preset):
    """``plan_search(model=...)``: every ranked plan JSON-equal, for the
    paper's GPT models and every config of the registry (MoE, MLA and
    xLSTM included: the search is pure Python)."""
    n = cm.PRESETS[preset]().num_devices
    for name in MODELS:
        got = plan_search(preset, n, model=registry.get_config(name),
                          batch=4, seq=2048)
        want = ref_plan.plan_search(preset, n,
                                    model=ref_registry.get_config(name),
                                    batch=4, seq=2048)
        assert jsons(got.ranked) == jsons(want.ranked), (preset, name)


@pytest.mark.parametrize("form", ["layers-profile", "decode", "int8",
                                  "calibrated", "dp-pods"])
def test_plan_search_forms_equal_the_references(form):
    """The ``layers=``/``profile=`` form, a decode sub-plan, an int8 wire,
    a calibration table and data-parallel pods, on IC1-IC6."""
    for preset in IC_PRESETS:
        n = cm.PRESETS[preset]().num_devices
        port_kw, ref_kw = dict(batch=4, seq=2048), dict(batch=4, seq=2048)
        if form == "layers-profile":
            port_kw.update(layers=4, profile=PROF)
            ref_kw.update(layers=4, profile=REF_PROF)
        else:
            port_kw["model"] = registry.get_config("llama3-8b")
            ref_kw["model"] = ref_registry.get_config("llama3-8b")
        if form == "decode":
            port_kw["decode_batch"] = ref_kw["decode_batch"] = 8
        if form == "int8":
            port_kw["wire_dtype"] = ref_kw["wire_dtype"] = "int8"
        if form == "calibrated":
            pairs = {k: v for k, v in IC1_PAIRS.items() if k[0] * k[1] == n}
            port_kw["calibration"] = CalibrationTable.from_pairs(pairs)
            ref_kw["calibration"] = RefTable.from_pairs(pairs)
        if form == "dp-pods":
            port_kw.update(dp=2, pods=2)
            ref_kw.update(dp=2, pods=2)
        got = plan_search(preset, n, **port_kw)
        want = ref_plan.plan_search(preset, n, **ref_kw)
        assert jsons(got.ranked) == jsons(want.ranked), (form, preset)


def test_search_helpers_equal_the_references():
    for preset in IC_PRESETS:
        m, rm = cm.PRESETS[preset](), ref_cm.PRESETS[preset]()
        n = m.num_devices
        got = search.search_strategy(m, n, layers=4, batch=4, seq=2048,
                                     profile=PROF, calibration=IC1_PAIRS)
        want = ref_search.search_strategy(rm, n, layers=4, batch=4,
                                          seq=2048, profile=REF_PROF,
                                          calibration=IC1_PAIRS)
        assert [dataclasses.asdict(c) for c in got.ranked] == \
            [dataclasses.asdict(c) for c in want.ranked]
        for d1, d2 in factorizations(n):
            if isinstance(_fits(lambda: m.axis_bandwidths(d1, d2)), str):
                continue
            assert search.recommend_chunks(m, d1, d2) == \
                ref_search.recommend_chunks(rm, d1, d2)
    samples = [3.0, 1.0, 2.0, 50.0, 1.5]
    assert robust_seconds(samples) == ref_robust(samples)
    assert SEQ_PARALLEL_KINDS == __import__(
        "repro.core.atp", fromlist=["x"]).SEQ_PARALLEL_KINDS


def test_the_paper_plans_equal_the_stored_file():
    """The 21 plans of Fig. 10 and Fig. 11 equal ``BENCH_paper_plans.json``
    key for key, predicted costs included.  The file predates the
    calibration entries' ``provenance`` field; through ``from_dict`` its
    entries read as measured, and that field is its only difference from
    what the search gives today."""
    got = plan_smoke.paper_plans()
    assert got == plan_smoke.stored_paper_plans()
    assert len(got) == 21
    raw = json.loads(plan_smoke.PAPER_PLANS_FILE.read_text())
    for key, d in got.items():
        d = json.loads(json.dumps(d))
        for entry in (d["calibration"] or {}).get("entries", {}).values():
            assert entry.pop("provenance") == "measured"
        assert d == raw[key], key


# ---------------------------------------------------------------------------
# Plan files.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(p.name for p in DATA.glob("plan_v*")))
def test_plan_files_load_equal_in_both_packages(name):
    text = (DATA / name).read_text()
    port = ParallelPlan.from_json(text)
    ref = ref_plan.ParallelPlan.from_json(text)
    assert port.to_dict() == ref.to_dict()
    # the JSON crosses both ways unchanged
    assert ref_plan.ParallelPlan.from_json(port.to_json()).to_dict() == \
        port.to_dict()
    assert ParallelPlan.from_json(ref.to_json()) == port
    assert port.describe() == ref.describe()
    assert port.decode_view().to_dict() == ref.decode_view().to_dict()


def _full_plan() -> ParallelPlan:
    calib = CalibrationTable(
        entries=(((2, 4), CalibEntry(b1=1.2, b2=4.95, t_psum=2e-3,
                                     t_ring=1e-3)),
                 ((8, 1), CalibEntry(b1=0.97, b2=math.inf))),
        source="unit-test")
    return ParallelPlan(
        d1=2, d2=4, dp=3, pods=2, chunks=4, boundary_mode="ring",
        seq_parallel=True, topology="ic1", calibration=calib,
        segments=(SegmentPlan("dense", chunks=2, wire_dtype="int8"),),
        decode=DecodePlan(d1=8, d2=1, speculate=True,
                          predicted_t_step=1e-4),
        predicted=PredictedCost(t_comm=1e-3, t_exposed=5e-4, t_gemm=2e-3),
        provenance=(("searcher", "unit"), ("note", "x")))


def test_plan_json_round_trip_is_exact(tmp_path):
    p = _full_plan()
    q = ParallelPlan.from_json(p.to_json())
    assert q == p
    assert q.calibration.get(8, 1).b2 == math.inf
    assert q.calibration.boundary_mode(2, 4) == "ring"
    assert ParallelPlan.load(p.save(str(tmp_path / "plan.json"))) == p
    assert ref_plan.ParallelPlan.from_json(p.to_json()).to_json() == \
        p.to_json()
    twice = ParallelPlan(d1=2, d2=2, provenance=(
        ("elastic", "replanned 16->8 devices"),
        ("elastic", "replanned 8->4 devices")))
    assert ParallelPlan.from_json(twice.to_json()) == twice
    t = CalibrationTable.from_pairs(IC1_PAIRS)
    assert CalibrationTable.from_dict(t.to_dict()) == t
    assert t.as_pairs()[(2, 4)] == (1.2, 4.95) and t.bandwidths(3, 3) is None


def test_plan_validation_and_a_newer_version_refused():
    with pytest.raises(ValueError):
        ParallelPlan(d1=0, d2=4)
    with pytest.raises(ValueError):
        ParallelPlan(d1=2, d2=2, chunks=0)
    with pytest.raises(ValueError):
        ParallelPlan(d1=2, d2=2, boundary_mode="laser")
    with pytest.raises(ValueError):
        ParallelPlan(d1=2, d2=2, wire_dtype="int4")
    with pytest.raises(ValueError):
        SegmentPlan("dense", chunks=0)
    with pytest.raises(ValueError):
        DecodePlan(d1=2, d2=1, chunks=2)
    d = _full_plan().to_dict()
    d["format_version"] = 999
    with pytest.raises(ValueError, match="format_version"):
        ParallelPlan.from_dict(d)


@pytest.mark.parametrize("preset", IC_PRESETS)
def test_plan_search_seed_parity_when_overlap_disabled(preset):
    """``plan_search`` restricted to the seed space ranks as Eq. 2's
    ``search_strategy`` does."""
    matrix = cm.PRESETS[preset]()
    n = matrix.num_devices
    seed = search.search_strategy(matrix, n, layers=4, batch=4, seq=2048,
                                  profile=PROF)
    res = plan_search(preset, n, layers=4, batch=4, seq=2048, profile=PROF,
                      chunks_options=(1,), seq_parallel_options=(False,),
                      algo="rabenseifner", alpha_s=0.0)
    assert [(p.d1, p.d2) for p in res.ranked] == \
        [(c.d1, c.d2) for c in seed.ranked]
    assert all(p.chunks == 1 and not p.seq_parallel for p in res.ranked)
    for p, c in zip(res.costs, seed.ranked):
        assert p.t_exposed == pytest.approx(c.t_comm, rel=1e-9)


def test_calibrated_search_prefers_the_measured_faster_mesh():
    """Paper §5.3: IC1's analytic model picks (8, 1); the measured table
    flips the choice to (2, 4), and the winning plan carries it."""
    kw = dict(layers=4, batch=4, seq=2048, profile=PROF,
              chunks_options=(1,), seq_parallel_options=(False,),
              algo="rabenseifner", alpha_s=0.0)
    calib = CalibrationTable.from_pairs(IC1_PAIRS, source="paper")
    assert plan_search("ic1", 8, **kw).mesh() == (8, 1)
    cal = plan_search("ic1", 8, calibration=calib, **kw)
    assert cal.mesh() == (2, 4)
    assert cal.best.calibration == calib
    assert dict(cal.best.provenance)["calibrated"] == "yes"


def test_replan_elastic_shrinks_dp_first():
    new = replan_elastic(ParallelPlan(d1=2, d2=2, dp=4), 8)
    assert (new.d1, new.d2, new.dp) == (2, 2, 2)
    assert any(k == "elastic" for k, _ in new.provenance)


def test_replan_elastic_never_grows_the_job():
    new = replan_elastic(ParallelPlan(d1=2, d2=1, dp=1), 8)
    assert (new.d1, new.d2, new.dp) == (2, 1, 1)


def test_replan_elastic_halves_tp_when_needed():
    new = replan_elastic(ParallelPlan(d1=4, d2=2, dp=1), 4)
    assert new.tp == 4 and new.devices <= 4
    assert new.calibration is None


def test_replan_elastic_researches_with_workload():
    plan = plan_search("ic4", 16, layers=4, batch=4, seq=2048,
                       profile=PROF).best
    new = replan_elastic(plan, 8, layers=4, batch=4, seq=2048, profile=PROF)
    assert new.tp == 8
    assert dict(new.provenance)["searcher"] == "plan_search"
    assert (new.d1, new.d2) in factorizations(8)
    ref = ref_plan.replan_elastic(ref_plan.ParallelPlan.from_dict(
        plan.to_dict()), 8, layers=4, batch=4, seq=2048, profile=REF_PROF)
    assert new.to_dict() == ref.to_dict()


def test_ic3_selects_atp1_and_ic4_atp2():
    """§5.3: NVSwitch 8 GPUs -> DeviceMesh(8, 1); flat IB 16 GPUs ->
    DeviceMesh(8, 2)."""
    kw = dict(layers=4, batch=4, seq=2048, profile=PROF)
    assert search.search_strategy(cm.ic3_nvswitch_8gpu(), 8,
                                  **kw).mesh() == (8, 1)
    assert search.search_strategy(cm.ic4_ib_cluster_16gpu(), 16,
                                  **kw).mesh() == (8, 2)


def test_ic1_calibrated_atp4_wins_by_46_percent():
    r = search.search_strategy(cm.ic1_pcie_8gpu(), 8, layers=4, batch=4,
                               seq=2048, profile=PROF,
                               calibration={(2, 4): (1.20, 4.95),
                                            (8, 1): (0.97, 0.97)})
    t24 = next(c.t_comm for c in r.ranked if (c.d1, c.d2) == (2, 4))
    t81 = next(c.t_comm for c in r.ranked if (c.d1, c.d2) == (8, 1))
    assert 1 - t24 / t81 == pytest.approx(0.46, abs=0.03)


def test_fig12_comm_decreases_with_scale():
    costs = [search.search_strategy(cm.ic5_nvlink_network(n), n, layers=4,
                                    batch=4, seq=2048, profile=PROF
                                    ).best.t_comm for n in (8, 16, 32, 64)]
    assert all(a > b for a, b in zip(costs, costs[1:]))


def test_measuring_is_refused_naming_a7():
    with pytest.raises(NotImplementedError, match="A7"):
        calibrate_mesh(4)
    with pytest.raises(NotImplementedError, match="A7"):
        recalibrate_surviving(ParallelPlan(d1=2, d2=2))
    with pytest.raises(NotImplementedError, match="A7"):
        train.pick_plan(registry.get_config("gpt-m1"), 8, 2048, 4,
                        calibrate=True)


# ---------------------------------------------------------------------------
# Contexts and builders.
# ---------------------------------------------------------------------------

LLAMA = registry.get_config("llama3-8b").reduced()
ZAMBA = dataclasses.replace(registry.get_config("zamba2-7b").reduced(),
                            num_layers=5)


def test_context_from_a_plan_is_equal_after_json(tmp_path):
    plan = plan_search("h100-sxm-8", 1, model=ZAMBA, batch=2, seq=32,
                       decode_batch=4).best
    loaded = ParallelPlan.load(plan.save(str(tmp_path / "p.json")))
    ctx = make_context(plan=plan, device_type="cpu")
    assert make_context(plan=loaded, device_type="cpu") == ctx
    assert loaded.context(device_type="cpu") == ctx
    assert ctx.segment_plans == plan.segments
    # the segment entries take part in equality
    assert dataclasses.replace(ctx, segment_plans=()) != ctx


def test_make_context_refuses_a_mismatch_and_nothing():
    with pytest.raises(ValueError, match="plan/topology mismatch"):
        make_context(atp_topo(1, 4, 1), plan=ParallelPlan(d1=2, d2=2),
                     device_type="cpu")
    with pytest.raises(TypeError):
        make_context()
    with pytest.raises(ValueError, match="boundary_mode"):
        make_context(atp_topo(1, 1, 1), boundary_mode="laser",
                     device_type="cpu")


def test_for_segment_gives_each_kind_its_knobs():
    ctx = make_context(plan=ParallelPlan(d1=1, d2=1, chunks=4, segments=(
        SegmentPlan("zamba", chunks=2, seq_parallel=True),
        SegmentPlan("mamba", chunks=1))), device_type="cpu")
    z = ctx.for_segment("zamba")
    # a zamba segment masks seq_parallel: its context builds, and its view
    # runs the segment's chunks without it
    assert (z.chunks, z.seq_parallel, z.segment_plans) == (2, False, ())
    assert ctx.for_segment("mamba").chunks == 1
    assert ctx.for_segment("dense").chunks == 4     # the scalar default
    assert ctx.any_seq_parallel and not ctx.any_ring


@pytest.mark.parametrize("plan", [
    ParallelPlan(d1=1, d2=1, boundary_mode="ring"),
    ParallelPlan(d1=1, d2=1, seq_parallel=True),
    ParallelPlan(d1=1, d2=1, wire_dtype="int8"),
    ParallelPlan(d1=1, d2=1, wire_dtype="fp8"),
    ParallelPlan(d1=1, d2=1, segments=(SegmentPlan("dense",
                                                   seq_parallel=True),)),
    ParallelPlan(d1=1, d2=1, segments=(SegmentPlan("zamba",
                                                   boundary_mode="ring"),)),
    ParallelPlan(d1=1, d2=1, segments=(SegmentPlan("mamba",
                                                   wire_dtype="int8"),)),
], ids=["ring", "seq_parallel", "int8", "fp8", "dense-sp", "zamba-ring",
        "mamba-int8"])
def test_unported_knobs_raise_naming_a8(plan):
    """A plan or segment asking for a ring boundary, a quantized wire or
    the sequence-parallel spec raises when its context is built: it never
    runs as a plain psum."""
    with pytest.raises(NotImplementedError, match="A8"):
        make_context(plan=plan, device_type="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        build_train_step(LLAMA, device="cpu", plan=plan)
    with pytest.raises(NotImplementedError, match="A8"):
        ATPContext(topo=atp_topo(1, 1, 1), ax1=None, ax2=None, dp_axes=(),
                   boundary_mode=plan.boundary_mode,
                   seq_parallel=plan.seq_parallel,
                   wire_dtype=plan.wire_dtype, segment_plans=plan.segments)


def test_builders_carry_the_plans_knobs():
    """``build_train_step(plan=)`` runs the plan's knobs; ``build_paged_step
    (plan=)`` its decode sub-plan's (chunks 1 in every segment), with
    ``seq_parallel`` masked, so a serving step of a plan that trains
    sequence-parallel builds."""
    plan = ParallelPlan(d1=1, d2=1, chunks=4, segments=(
        SegmentPlan("dense", chunks=2),), decode=DecodePlan(d1=1, d2=1))
    _, t_info = build_train_step(LLAMA, device="cpu", plan=plan)
    assert (t_info.ctx.chunks, t_info.ctx.segment_plans) == (4, plan.segments)
    assert t_info.ctx.for_segment("dense").chunks == 2
    _, p_info = build_paged_step(LLAMA, device="cpu", plan=plan)
    assert p_info.ctx.chunks == 1
    assert p_info.ctx.segment_plans == (SegmentPlan("dense", chunks=1),)
    assert p_info.ctx == resolve_ctx(None, plan, decode=True,
                                     device_type="cpu")
    sp = plan.with_(seq_parallel=True, decode=None)
    _, p_info = build_paged_step(LLAMA, device="cpu", plan=sp)
    assert (p_info.ctx.chunks, p_info.ctx.seq_parallel) == (4, False)
    with pytest.raises(NotImplementedError, match="A8"):
        build_train_step(LLAMA, device="cpu", plan=sp)
    # a topology still builds as before, and neither refuses
    _, t_info = build_train_step(LLAMA, atp_topo(1, 1, 1), chunks=2,
                                 device="cpu")
    assert (t_info.ctx.chunks, t_info.ctx.segment_plans) == (2, ())
    with pytest.raises(TypeError):
        resolve_ctx(None, None)


def test_server_from_a_plan_serves_the_topologys_tokens():
    """``make_paged_server(plan=...)`` on a plan with a decode sub-plan
    gives the greedy tokens of the server built from the topology; a
    decode sub-plan asking for speculation is refused (ROADMAP A9)."""
    from repro_torch.runtime.server import Request

    plan = plan_search("h100-sxm-8", 1, model=LLAMA, batch=4, seq=24,
                       decode_batch=4).best
    assert plan.decode is not None
    prompts = serve.sample_prompts(LLAMA, 3, 12, seed=0)
    scfg = serve.paged_server_config([len(p) for p in prompts], slots=2,
                                     prefill_chunk=8, page_size=4,
                                     max_seq=24, max_new=4)

    def tokens(**kw):
        server, info = serve.make_paged_server(
            LLAMA, scfg, lm.init_params(LLAMA, seed=3, device="cpu"),
            device="cpu", **kw)
        for rid, p in enumerate(prompts):
            server.submit(Request(rid=rid, prompt=p, max_new=4))
        server.run_until_drained()
        return info.ctx, {r.rid: list(r.out) for r in server.completed}

    ctx_p, from_plan = tokens(plan=plan)
    ctx_t, from_topo = tokens()
    assert from_plan == from_topo and len(from_plan) == 3
    assert dataclasses.replace(ctx_p, segment_plans=()) == ctx_t
    spec = plan.with_(decode=dataclasses.replace(plan.decode, speculate=True))
    with pytest.raises(NotImplementedError, match="A9"):
        serve.make_paged_server(LLAMA, scfg, {}, device="cpu", plan=spec)


def test_launchers_search_save_and_load_a_plan(tmp_path):
    """``launch.train``: ``--auto-atp --save-plan`` then ``--plan`` runs the
    same plan and the same losses; manual knobs make a ``manual-cli``
    plan; ``--calibrate`` is refused (A7).  ``launch.serve --plan`` serves
    from the saved plan."""
    path = str(tmp_path / "plan.json")
    common = ["--reduced", "--device", "cpu", "--steps", "2", "--seq", "16",
              "--batch", "2", "--topology", "ic3"]
    first = train.main(common + ["--auto-atp", "--save-plan", path])
    plan = ParallelPlan.load(path)
    assert dict(plan.provenance)["searcher"] == "plan_search"
    assert dict(plan.provenance)["matrix"] == "IC3-NVSwitch"
    again = train.main(common + ["--plan", path])
    assert [h["loss"] for h in again] == [h["loss"] for h in first]
    manual = str(tmp_path / "manual.json")
    train.main(common + ["--chunks", "2", "--save-plan", manual])
    m = ParallelPlan.load(manual)
    assert (m.d1, m.d2, m.chunks) == (1, 1, 2)
    assert dict(m.provenance) == {"searcher": "manual-cli"}
    with pytest.raises(NotImplementedError, match="A7"):
        train.main(common + ["--auto-atp", "--calibrate"])
    serve.main(["--reduced", "--device", "cpu", "--requests", "2",
                "--max-new", "2", "--prompt-len", "8", "--max-seq", "16",
                "--prefill-chunk", "8", "--page-size", "4", "--plan", path])


def test_pick_plan_prices_the_h100_presets_at_the_cards_peak():
    """On the H100 presets ``pick_plan`` passes the card's dense bf16 peak;
    on the paper's presets it keeps ``plan_search``'s default, so its
    plans equal the reference's ``pick_plan``'s."""
    cfg = registry.get_config("gpt-m2")
    res = train.pick_plan(cfg, 8, 2048, 4, "h100-sxm-8")
    assert dict(res.best.provenance)["peak_tflops"] == repr(989.0)
    assert dict(res.best.provenance)["matrix"] == "H100-SXM-8"
    from repro.launch.train import pick_plan as ref_pick

    for overlap in (True, False):
        got = train.pick_plan(cfg, 8, 2048, 4, "ic3", overlap=overlap)
        want = ref_pick(ref_registry.get_config("gpt-m2"), 8, 2048, 4, "ic3",
                        overlap=overlap)
        assert jsons(got.ranked) == jsons(want.ranked)


# ---------------------------------------------------------------------------
# One gloo run: a searched plan trains on a (1, 2, 2) mesh.
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _jax_reference(b, s):
    """The reduced llama3-8b's fp32 JAX weights and its single-device loss
    and gradients on the worker's batch."""
    cfg = ref_registry.get_config("llama3-8b").reduced()
    params = jax_lm.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    batch = batch_of(cfg, b, s)
    topo = JaxMeshTopo((("data", 1),))
    ctx = jax_make_context(topo)

    def f(p, bt):
        return jax.value_and_grad(
            lambda q: jax_lm.train_loss(ctx, cfg, q, bt, remat=False))(p)

    g = jax.jit(shard_map(f, mesh=topo.build(jax.devices()[:1]),
                          in_specs=(P(), P()), out_specs=(P(), P()),
                          check_vma=True))
    loss, grads = g(params, batch)
    return (jax.tree.map(np.asarray, params), float(loss),
            jax.tree.map(np.asarray, grads))


def test_searched_plan_trains_on_a_gloo_mesh_as_the_reference(tmp_path):
    """A plan searched on ic3 at tp 4 with ``chunks_options=(1, 2)`` (its
    DeviceMesh(2, 2) entry: chunks 2) drives the training step of the
    reduced llama3-8b on a (1, 2, 2) gloo mesh: every rank's loss and
    local gradient within 1e-4 of the reference's single-device ones, as
    ``test_torch_train.py`` compares them."""
    b, s = 2, 12
    cfg = LLAMA
    res = plan_search("ic3", 4, model=cfg, batch=b, seq=s,
                      chunks_options=(1, 2))
    plan = next(p for p in res.ranked if (p.d1, p.d2) == (2, 2))
    assert plan.chunks == 2
    params, want_loss, want_grads = _jax_reference(b, s)
    np.savez(tmp_path / "params.npz", **_flat(params))
    (tmp_path / "case.json").write_text(json.dumps(dict(mesh=(1, 2, 2), cases=[
        dict(name="searched", arch="llama3-8b", plan=plan.to_dict(),
             batch=b, seq=s, remat=False, params="params.npz",
             grads=True)])))
    results = finish(tmp_path, start(tmp_path, (1, 2, 2)))
    topo = atp_topo(1, 2, 2)
    for r, res_r in enumerate(results):
        (got,) = res_r
        assert got["knobs"]["chunks"] == 2
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-4,
                                   atol=1e-4)
        grads = np.load(tmp_path / f"grads_searched_rank{r}.npz")
        want = _flat(lm.tree_map(lambda t: t.numpy(), convert.params_from_jax(
            cfg, want_grads, topo, r)))
        assert sorted(grads.files) == sorted(want)
        for key, w in want.items():
            np.testing.assert_allclose(grads[key], w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"rank {r} grad {key}")
