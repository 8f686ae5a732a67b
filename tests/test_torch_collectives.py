"""The collectives the port's training step issues, held against the plan
that priced them.

The reference derives, in pure Python, the collective inventory a plan's
step should issue (``repro.analysis.expect.expected_signature``).  The port
records what its step does issue (``repro_torch.analysis.signature``): every
collective of the model path is noted where ``core.atp`` issues it, under
the region the model code opens.  Here the forward regions of one training
step on CPU gloo meshes must equal the expectation exactly, count and raw
bytes per (region, op, axes, quant), for reduced llama3-8b, gpt-m1 and
zamba2-7b (5 layers: two zamba super-blocks and a Mamba2 tail) with chunks
1 and 2 on (1, 2, 2), and with chunks 1 on (1, 4, 1) and (2, 2, 1);
reduced xlstm-1.3b with chunks 1 and 2 on (1, 2, 2) (no departure); and
reduced llama3-8b on two data-parallel axes, (pods 2, data 2, 1, 1), with
chunks 1.  Each mesh starts four ranks of ``_torch_plan_worker.py`` once,
for all of its cases, the four meshes at once.

The port departs from the reference's inventory at three keys, each with
fewer wire bytes or fewer calls (ROADMAP §C lists them); :func:`departed`
applies exactly these three to the expectation before the comparison:

  - ``seg{i}:zamba``: the shared block's regather of its in-projection over
    tp1 is an all-gather of the [b, s, h/d1] shards (result b*s*h
    elements), where the reference places each shard in zeros and
    all-reduces the [b, s, h] result (``_gather_ax1_invariant``, for JAX's
    invariance typing): one call per super-block either way, half the wire
    bytes of the all-reduce;
  - ``seg{i}:moe`` (``test_torch_moe.py``): the all-to-all dispatch's token
    gather over tp1 is an all-gather of each rank's [T/n, h] block (result
    T/d2 * h elements), where the reference places the block in zeros and
    all-reduces the [T/d2, h] result, for the same typing: one call per
    layer either way, half the wire bytes;
  - ``shell:loss``: the mean's denominator is known on every rank, so the
    port all-reduces the loss sum only (one f32 element over the dp axes)
    where the reference also all-reduces the token count.

On a plan with pods the expectation itself names the loss's all-reduce
over ("data",) alone, though the reference's step reduces the loss over
("pod", "data"), as the port does: :func:`departed` names that key's axes
as the step issues them (ROADMAP §C), its counts and bytes unchanged.

Reduced llama3-8b also runs the ring, int8, fp8, seq_parallel and ring +
seq_parallel plans on (1, 2, 2) and (1, 4, 1) (``A8_PLANS``): the forward
record equals the expectation the same way (ppermute hops, the quantized
wire's pmax and f32 payloads, the reduce-scatters and sequence gathers),
and the backward record, each collective noted under the region of the
forward op it mirrors, passes the reference's structural rules
(``check_conformance``'s backward half): a ring-planned region runs
ppermutes backward, a psum-planned one none, a quantized region's
cotangent rides the quantized wire.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.analysis.expect import check_conformance  # noqa: E402
from repro.analysis.expect import expected_signature  # noqa: E402
from repro.analysis.signature import Collective, StepSignature  # noqa: E402
from repro.configs.base import segments  # noqa: E402
from repro.configs.registry import get_config  # noqa: E402
from repro.core.plan import ParallelPlan as RefPlan  # noqa: E402
from repro_torch.analysis import signature  # noqa: E402
from repro_torch.core.atp import SegmentPlan  # noqa: E402
from repro_torch.core.plan import ParallelPlan  # noqa: E402

from _torch_plan_worker import finish, start  # noqa: E402

ARCHS = ("llama3-8b", "gpt-m1", "zamba2-7b")
LAYERS = {"zamba2-7b": 5}
#: (global batch, sequence) per mesh and arch: two rows a dp rank, so that
#: chunks 2 splits the batch; zamba's sequence is two reduced SSD chunks
SEQ = {"llama3-8b": 16, "gpt-m1": 16, "zamba2-7b": 32, "xlstm-1.3b": 32}
#: the meshes (dp, d1, d2[, pods]) and the chunks each runs
MESHES = {(1, 2, 2): (1, 2), (1, 4, 1): (1,), (2, 2, 1): (1,),
          (2, 1, 1, 2): (1,)}
#: the archs of a mesh where not ``ARCHS``: (pods 2, data 2) holds the
#: loss and the optimizer over both dp axes; (1, 2, 2) also runs reduced
#: xlstm-1.3b (two super-blocks of one mLSTM and one sLSTM block)
MESH_ARCHS = {(2, 1, 1, 2): ("llama3-8b",),
              (1, 2, 2): ARCHS + ("xlstm-1.3b",)}


#: the ring, quantized and sequence-parallel plans llama3-8b runs on the
#: meshes of ``A8_MESHES`` (chunks 1)
A8_PLANS = {"ring": dict(boundary_mode="ring"), "int8": dict(wire_dtype="int8"),
            "fp8": dict(wire_dtype="fp8"), "sp": dict(seq_parallel=True),
            "ring-sp": dict(boundary_mode="ring", seq_parallel=True)}
A8_MESHES = ((1, 2, 2), (1, 4, 1))


def a8_plan(mesh, name) -> ParallelPlan:
    dp, d1, d2 = mesh
    return ParallelPlan(d1=d1, d2=d2, dp=dp, provenance=(("searcher", "test"),),
                        **A8_PLANS[name])


def archs_of(mesh):
    return MESH_ARCHS.get(mesh, ARCHS)


def ref_config(arch):
    cfg = get_config(arch).reduced()
    if arch in LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=LAYERS[arch])
    return cfg


def make_plan(arch, mesh, chunks) -> ParallelPlan:
    """The plan a case runs: every segment at ``chunks``, except that a
    zamba2-7b tail of Mamba2 blocks keeps chunks 1, so that two segments of
    one step run different knobs."""
    dp, d1, d2, *pods = mesh
    segs = tuple(SegmentPlan(kind=s.kind,
                             chunks=1 if s.kind == "mamba" else chunks)
                 for s in segments(ref_config(arch)))
    return ParallelPlan(d1=d1, d2=d2, dp=dp, pods=pods[0] if pods else 1,
                        chunks=chunks, segments=segs,
                        provenance=(("searcher", "test"),))


def case_name(arch, chunks):
    return f"{arch}_ck{chunks}"


def batch_of(mesh):
    """Two rows a dp rank."""
    return 2 * mesh[0] * (mesh[3] if len(mesh) > 3 else 1)


def departed(exp: dict, cfg, plan, batch: int, seq: int) -> dict:
    """The reference's ``by_key()`` of a step over ``batch`` rows (global)
    of ``seq`` tokens with the port's two documented departures applied
    (module docstring); the bytes-known flag dropped."""
    want = {k: (n, b) for k, (n, b, _) in exp.items()}
    rows = batch // (plan.dp * plan.pods)
    esize = 4 if cfg.dtype == "float32" else 2   # activation bytes

    def move(src, dst, count, nbytes):
        n, b = want[src]
        want[src] = (n - count, b - nbytes)
        if want[src] == (0, 0):
            del want[src]
        n, b = want.get(dst, (0, 0))
        want[dst] = (n + count, b + nbytes)

    for i, seg in enumerate(segments(cfg)):
        if seg.kind == "zamba" and plan.d1 > 1:
            region = f"seg{i}:zamba"
            nbytes = seg.count * rows * seq * cfg.d_model * esize
            move((region, "psum", ("tp1",), False),
                 (region, "all_gather", ("tp1",), False), seg.count, nbytes)
        tokens, tp = rows * seq, plan.d1 * plan.d2
        if (seg.kind in ("moe", "mla_moe") and plan.d1 > 1
                and tokens % tp == 0):
            # the all-to-all dispatch's token gather of [T/d2, h]
            region = f"seg{i}:{seg.kind}"
            nbytes = seg.count * tokens // plan.d2 * cfg.d_model * esize
            move((region, "psum", ("tp1",), False),
                 (region, "all_gather", ("tp1",), False), seg.count, nbytes)
    if plan.pods > 1:
        # the expectation names ("data",) whatever the pods
        # (repro/analysis/expect.py:618); the reference's train_loss
        # reduces over ctx.dp_axes, ("pod", "data") (repro/models/lm.py:
        # 866-868), as the port does
        want[("shell:loss", "psum", ("pod", "data"), False)] = want.pop(
            ("shell:loss", "psum", ("data",), False))
    # the sum and the count (and an MoE model's aux loss, kept)
    aux = int(cfg.moe is not None)
    for loss in [k for k in want if k[:2] == ("shell:loss", "psum")]:
        assert want[loss] == (2 + aux, 8 + 4 * aux), want[loss]
        want[loss] = (1 + aux, 4 + 4 * aux)
    return want


def expected(arch, plan, batch, seq) -> dict:
    """What the port's forward must record under ``plan``."""
    cfg = ref_config(arch)
    ref_plan = RefPlan.from_dict(plan.to_dict())
    return departed(expected_signature(cfg, ref_plan, "train", batch,
                                       seq).by_key(), cfg, plan, batch, seq)


def recorded(result) -> dict:
    return {(r, op, tuple(axes), q): (n, b)
            for r, op, axes, q, n, b in result["fwd"]}


#: the case whose forward runs under remat, as the training step's does by
#: default: its recompute lands in the backward's record, not the forward's
REMAT = ((1, 2, 2), "gpt-m1", 2)


def write_cases(tmp_path, mesh):
    cases = [dict(name=case_name(a, c), arch=a, layers=LAYERS.get(a),
                  plan=make_plan(a, mesh, c).to_dict(),
                  batch=batch_of(mesh), seq=SEQ[a],
                  remat=(mesh, a, c) == REMAT)
             for c in MESHES[mesh] for a in archs_of(mesh)]
    if mesh in A8_MESHES:
        cases += [dict(name=f"llama3-8b_{name}", arch="llama3-8b",
                       plan=a8_plan(mesh, name).to_dict(),
                       batch=batch_of(mesh), seq=SEQ["llama3-8b"])
                  for name in A8_PLANS]
    (tmp_path / "case.json").write_text(json.dumps(
        dict(mesh=mesh, cases=cases)))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Every mesh's results, rank by rank: one spawn per mesh, the three
    meshes at once."""
    dirs = {mesh: tmp_path_factory.mktemp("x".join(map(str, mesh)))
            for mesh in MESHES}
    for mesh, d in dirs.items():
        write_cases(d, mesh)
    started = {mesh: start(d, mesh) for mesh, d in dirs.items()}
    return {mesh: finish(dirs[mesh], procs) for mesh, procs in started.items()}


CASES = [(mesh, arch, c) for mesh, chunks in MESHES.items()
         for c in chunks for arch in archs_of(mesh)]


def _result(records, mesh, arch, chunks, rank):
    name = case_name(arch, chunks)
    return next(r for r in records[mesh][rank] if r["name"] == name)


@pytest.mark.parametrize("mesh,arch,chunks", CASES,
                         ids=[f"{'x'.join(map(str, m))}-{a}-ck{c}"
                              for m, a, c in CASES])
def test_forward_collectives_equal_the_plans_expectation(records, mesh, arch,
                                                         chunks):
    """Every rank's forward record equals the expectation of the plan it
    ran, count and raw bytes per key; the plan's knobs reached the
    context; the backward ran, and so did the optimizer, whose
    collectives carry ``opt:*`` regions."""
    plan = make_plan(arch, mesh, chunks)
    want = expected(arch, plan, batch_of(mesh), SEQ[arch])
    for rank in range(len(records[mesh])):
        res = _result(records, mesh, arch, chunks, rank)
        assert res["knobs"]["chunks"] == chunks
        assert res["knobs"]["segments"] == [s.to_dict() for s in plan.segments]
        got = recorded(res)
        assert got == want, (rank, sorted(set(got.items()) ^ set(want.items())))
        # the gradients' all-reduces (and remat's recompute of the forward)
        assert "psum" in res["bwd_ops"] and res["bwd_count"] > 0
        assert [r for r in res["bwd_regions"] if r.startswith("opt:")]


def test_two_dp_axes_reduce_the_loss_and_the_optimizer_over_both(records):
    """On (pods 2, data 2) the loss sum goes over ("pod", "data"), as the
    reference's expectation has it, and so does every optimizer
    collective of a dp reduction (the flat dp group); none goes over one
    of the two alone."""
    mesh = (2, 1, 1, 2)
    for rank in range(4):
        res = _result(records, mesh, "llama3-8b", 1, rank)
        got = recorded(res)
        assert got[("shell:loss", "psum", ("pod", "data"), False)] == (1, 4)
        axes = {tuple(a) for a in res["opt_axes"]}
        assert axes == {("pod", "data")}, axes


def test_the_check_has_teeth(records):
    """A record taken under chunks 2 differs from the chunks-1 plan's
    expectation (and from the chunks-1 record), on the same mesh."""
    mesh = (1, 2, 2)
    for arch in ARCHS:
        got = recorded(_result(records, mesh, arch, 2, 0))
        one = make_plan(arch, mesh, 1)
        assert got != expected(arch, one, batch_of(mesh), SEQ[arch]), arch
        assert got != recorded(_result(records, mesh, arch, 1, 0)), arch


def test_zamba_segments_run_their_own_chunks(records):
    """zamba2-7b's zamba segment ran chunks 2 and its Mamba2 tail chunks 1:
    the tail's row boundary is one all-reduce per block, the zamba
    segment's two."""
    got = recorded(_result(records, (1, 2, 2), "zamba2-7b", 2, 0))
    one = recorded(_result(records, (1, 2, 2), "zamba2-7b", 1, 0))
    tail = ("seg1:mamba", "psum", ("tp1",), False)
    assert got[tail] == one[tail]
    body = ("seg0:zamba", "psum", ("tp1",), False)
    assert got[body][0] > one[body][0] and got[body][1] == one[body][1]


def test_nothing_is_recorded_without_a_record(records):
    """With no record installed the issue sites note nothing (``Record.
    note`` is never called); with one installed the same forward notes its
    collectives."""
    for mesh in MESHES:
        first = records[mesh][0][0]
        assert first["idle_notes"] == 0
        assert first["active_notes"] == first["active_entries"] > 0
    assert signature.ACTIVE is None


def test_the_record_keys_and_bytes_follow_the_references_conventions():
    """One record by hand: regions nest, an all-gather counts its result's
    elements, phases split ``by_key``, a ``quant`` scope marks its entries
    quantized (a ring hop, ``ppermute``, among them), an op the reference
    does not name raises, and the record is removed after."""
    rec = signature.Record()
    with signature.recording("fwd", rec):
        with signature.region("seg0:dense"):
            rec.note("psum", "tp2", 6, torch.bfloat16)
            with signature.region("shell:exit"):
                rec.note("all_gather", ("tp1", "tp2"), 8, torch.float32)
            rec.note("psum", "tp2", 2, torch.bfloat16)
            with signature.quant():
                rec.note("pmax", "tp1", 1, torch.float32)
                rec.note("ppermute", "tp1", 5, torch.float32)
    with signature.recording("bwd", rec):
        rec.note("pmax", "tp1", 3, torch.float32, region="opt:x")
    assert signature.ACTIVE is None
    assert rec.by_key() == {("seg0:dense", "psum", ("tp2",), False): (2, 16),
                            ("shell:exit", "all_gather", ("tp1", "tp2"),
                             False): (1, 32),
                            ("seg0:dense", "pmax", ("tp1",), True): (1, 4),
                            ("seg0:dense", "ppermute", ("tp1",), True): (1, 20)}
    assert rec.by_key("bwd") == {("opt:x", "pmax", ("tp1",), False): (1, 12)}
    with pytest.raises(ValueError):
        rec.note("broadcast", "tp1", 1, torch.float32)


A8_CASES = [(mesh, name) for mesh in A8_MESHES for name in A8_PLANS]
A8_IDS = [f"{'x'.join(map(str, m))}-{n}" for m, n in A8_CASES]


def _named(records, mesh, name, rank):
    return next(r for r in records[mesh][rank] if r["name"] == name)


@pytest.mark.parametrize("mesh,name", A8_CASES, ids=A8_IDS)
def test_a8_forward_collectives_equal_the_plans_expectation(records, mesh,
                                                             name):
    """The forward record of a ring, quantized or sequence-parallel plan
    equals the reference's expectation of that plan, count for count and
    byte for byte, on every rank."""
    plan = a8_plan(mesh, name)
    want = expected("llama3-8b", plan, batch_of(mesh), SEQ["llama3-8b"])
    for rank in range(4):
        got = recorded(_named(records, mesh, f"llama3-8b_{name}", rank))
        assert got == want, (rank, sorted(set(got.items())
                                          ^ set(want.items())))


def backward_errors(result, plan, mesh) -> list[str]:
    """The reference's structural backward rules (``check_conformance``)
    on a rank's backward record under ``plan``."""
    sig = StepSignature(tuple(
        Collective(op=op, axes=tuple(axes), elems=0, dtype="float32",
                   quant=quant, region=region, backward=True, site="",
                   count=n)
        for region, op, axes, quant, n, _ in result["bwd"]))
    exp = expected_signature(ref_config("llama3-8b"),
                             RefPlan.from_dict(plan.to_dict()), "train",
                             batch_of(mesh), SEQ["llama3-8b"])
    return [e for e in check_conformance(sig, exp) if " bwd:" in e]


@pytest.mark.parametrize("mesh,name", A8_CASES, ids=A8_IDS)
def test_a8_backward_follows_the_references_structural_rules(records, mesh,
                                                             name):
    """The reference's backward rules hold on every rank's record; the
    dense segment runs ppermutes backward under a ring plan and a
    quantized collective under a quantized one; and the rules have teeth:
    the psum plan's backward fails a ring plan's and a quantized plan's."""
    plan = a8_plan(mesh, name)
    for rank in range(4):
        res = _named(records, mesh, f"llama3-8b_{name}", rank)
        assert backward_errors(res, plan, mesh) == [], rank
        seg = {(op, q) for region, op, _, q, _, _ in res["bwd"]
               if region == "seg0:dense"}
        assert (("ppermute", False) in seg) == ("ring" in name), seg
        assert any(q for _, q in seg) == (name in ("int8", "fp8")), seg
    if name in ("ring", "int8"):
        plain = _named(records, mesh, "llama3-8b_ck1", 0)
        assert backward_errors(plain, plan, mesh)
