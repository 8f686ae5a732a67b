"""The port's ring and quantized boundary collectives and collective
matmuls (``repro_torch.core.overlap``) on four gloo ranks, against the
monolithic collectives and against the JAX package.

One spawn of four ``_torch_overlap_worker.py`` ranks runs every case on a
(1, 2, 2) mesh: rings of 4 over the flat TP group and of 2 over tp1 and
tp2.  Each case's output and the gradients of ``sum(output * ct)`` (``ct``
seeded per rank: the per-rank partial-cotangent convention the mirrored
backward serves) are held against numpy's sums of every rank's inputs:

  - the ring all-reduce in its three schedules (bidirectional where a dim
    splits into 2d, one way where it splits into d, one all-reduce where
    none does), each counted hop by hop in the collective record; the ring
    reduce-scatter and all-gather, and a scatter dim that does not divide
    (it raises);
  - the collective matmuls (the chunked all-reduce and the reduce-scatter
    forms) against GEMM + monolithic collective, forward and gradient;
  - the quantized wire: ``wire_quantize`` against the reference's on the
    same inputs inside ``shard_map`` (``check_vma=False``, as
    ``tests/test_overlap.py`` runs it), bit for bit, q and scale, int8 and
    fp8; the quantized ring against ``quant_psum`` and against the
    reference's quantized ring, bit for bit, forward and backward; the
    quantized reduce-scatter, ring or not, against the dequantized sum;
  - the bf16-wire ring all-reduce against the reference's ring, bit for
    bit: the same hops in the same order.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core import overlap as ref_overlap  # noqa: E402
from repro.core.compat import shard_map  # noqa: E402

from _torch_overlap_worker import inputs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_overlap_worker.py"
TOL = dict(rtol=1e-5, atol=1e-5)


def _cases():
    out = []

    def add(name, op, axes, x, out_shape, seed=None, **kw):
        out.append(dict(name=name, op=op, axes=axes, x=x, out=out_shape,
                        seed=len(out) if seed is None else seed, **kw))

    for axes, d in (("tp", 4), ("tp1", 2), ("tp2", 2)):
        add(f"ar-bidir-{axes}", "ring_all_reduce", axes, [8, 6], [8, 6])
        uni = [12, 5] if d == 4 else [6, 5]
        add(f"ar-uni-{axes}", "ring_all_reduce", axes, uni, uni)
        add(f"ar-fallback-{axes}", "ring_all_reduce", axes, [3, 5], [3, 5])
        add(f"rs0-{axes}", "ring_reduce_scatter", axes, [8, 6],
            [8 // d, 6], dim=0)
        add(f"rs1-{axes}", "ring_reduce_scatter", axes, [4, 8], [4, 8 // d],
            dim=1)
        add(f"ag0-{axes}", "ring_all_gather", axes, [2, 3], [2 * d, 3],
            dim=0)
        add(f"ag1-{axes}", "ring_all_gather", axes, [3, 2], [3, 2 * d],
            dim=1)
        add(f"mm-ar-{axes}", "overlap_matmul_ar", axes, [4, 3, 8], [4, 3, 6],
            w=[8, 6], chunks=2)
        add(f"mm-ar-ck3-{axes}", "overlap_matmul_ar", axes, [4, 3, 8],
            [4, 3, 6], w=[8, 6], chunks=3)
        add(f"mm-rs-{axes}", "overlap_matmul_rs", axes, [2, 8, 8],
            [2, 8 // d, 6], w=[8, 6], dim=1)
        for wire in ("int8", "fp8"):
            # each pair on the same inputs
            seed = len(out)
            for op in ("quant_psum", "quant_ring_all_reduce"):
                add(f"{op}-{wire}-{axes}", op, axes, [8, 6], [8, 6],
                    seed=seed, wire=wire)
            for ring in (False, True):
                add(f"qrs-{wire}-{ring}-{axes}", "quant_reduce_scatter",
                    axes, [8, 6], [8 // d, 6], seed=seed + 1, dim=0,
                    wire=wire, ring=ring)
            add(f"mm-ar-{wire}-{axes}", "overlap_matmul_ar", axes,
                [4, 3, 8], [4, 3, 6], w=[8, 6], chunks=2, wire=wire)
    add("rs-bad", "ring_reduce_scatter", "tp", [6, 5], [6, 5], dim=0)
    add("mm-rs-bad", "overlap_matmul_rs", "tp", [2, 6, 8], [2, 6, 6],
        w=[8, 6], dim=1)
    for wire in ("int8", "fp8"):
        add(f"q-{wire}", "wire_quantize", "tp", [16, 24], [16, 24],
            wire=wire)
    return out


CASES = {c["name"]: c for c in _cases()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("overlap")
    (d / "cases.json").write_text(json.dumps(list(CASES.values())))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(d)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:  # a rank that died leaves the others waiting in a collective
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return [(dict(np.load(d / f"rank{r}.npz")),
             json.loads((d / f"rank{r}.json").read_text())) for r in range(4)]


def members(axes: str, rank: int) -> list[int]:
    """The global ranks of ``rank``'s group on ``axes``, in group order
    (the (1, 2, 2) mesh: rank = 2 * tp1 + tp2)."""
    if axes == "tp":
        return [0, 1, 2, 3]
    if axes == "tp1":
        return [rank % 2, 2 + rank % 2]
    return [2 * (rank // 2), 2 * (rank // 2) + 1]


def block(a, i, d, dim):
    return np.split(a, d, axis=dim)[i]


def expected(case, rank):
    """(y, dx, dw or None) from numpy over every member's inputs."""
    ms = members(case["axes"], rank)
    d, idx, dim = len(ms), ms.index(rank), case.get("dim", 0)
    ins = [inputs(case, m) for m in ms]
    x = [i["x"] for i in ins]
    ct = [i["ct"] for i in ins]
    me = ins[idx]
    op = case["op"]
    if op == "ring_all_reduce":
        return sum(x), sum(ct), None
    if op == "ring_reduce_scatter":
        return block(sum(x), idx, d, dim), np.concatenate(ct, dim), None
    if op == "ring_all_gather":
        return np.concatenate(x, dim), block(sum(ct), idx, d, dim), None
    w = [i["w"] for i in ins]
    k = me["w"].shape[0]
    if op == "overlap_matmul_ar":
        c = sum(ct)
        return (sum(xi @ wi for xi, wi in zip(x, w)), c @ me["w"].T,
                me["x"].reshape(-1, k).T @ c.reshape(-1, c.shape[-1]))
    if op == "overlap_matmul_rs":
        full = np.concatenate(ct, dim)
        return (block(sum(xi @ wi for xi, wi in zip(x, w)), idx, d, dim),
                full @ me["w"].T,
                me["x"].reshape(-1, k).T @ full.reshape(-1, full.shape[-1]))
    raise ValueError(op)


EXACT = [n for n, c in CASES.items() if c["op"] in (
    "ring_all_reduce", "ring_reduce_scatter", "ring_all_gather",
    "overlap_matmul_rs") and "bad" not in n
    or (c["op"] == "overlap_matmul_ar" and "wire" not in c)]


@pytest.mark.parametrize("name", EXACT)
def test_rings_and_collective_matmuls_match_the_monolithic_collectives(
        ranks, name):
    case = CASES[name]
    for rank, (arrays, _) in enumerate(ranks):
        y, dx, dw = expected(case, rank)
        np.testing.assert_allclose(arrays[f"{name}/y"], y, **TOL)
        np.testing.assert_allclose(arrays[f"{name}/dx"], dx, **TOL)
        if dw is not None:
            np.testing.assert_allclose(arrays[f"{name}/dw"], dw, **TOL)


@pytest.mark.parametrize("axes,d", [("tp", 4), ("tp1", 2), ("tp2", 2)])
def test_ring_all_reduce_schedules_hop_by_hop(ranks, axes, d):
    """Bidirectional: 4(d-1) hops of E/2d elements each way of the
    backward too; one way: 2(d-1) hops of E/d; no divisible dim: one
    all-reduce.  The axes noted are the group's."""
    ax = ["tp1", "tp2"] if axes == "tp" else [axes]
    for rank, (_, metas) in enumerate(ranks):
        for name, want in (
                ("ar-bidir", ["ppermute", ax, False, 4 * (d - 1),
                              4 * (d - 1) * 48 // (2 * d) * 4]),
                ("ar-uni", ["ppermute", ax, False, 2 * (d - 1),
                            2 * (d - 1) * (60 if d == 4 else 30) // d * 4]),
                ("ar-fallback", ["psum", ax, False, 1, 15 * 4])):
            meta = metas[f"{name}-{axes}"]
            assert meta["fwd"] == [want] and meta["bwd"] == [want], (
                rank, name, meta)


def test_a_scatter_dim_that_does_not_divide_raises(ranks):
    for _, metas in ranks:
        assert "divisible by the ring size 4" in metas["rs-bad"]["error"]
        assert "divisible by the ring size 4" in metas["mm-rs-bad"]["error"]


QUANT = [(wire, axes) for wire in ("int8", "fp8")
         for axes in ("tp", "tp1", "tp2")]


@pytest.mark.parametrize("wire,axes", QUANT)
def test_quantized_ring_equals_quant_psum_bit_for_bit(ranks, wire, axes):
    """Grid values sum exactly in f32 on any schedule: the ring's output
    and its backward's equal the one all-reduce's, bit for bit; each is the
    members' shared-scale grid values summed and dequantized; every member
    holds the same result."""
    for rank, (arrays, metas) in enumerate(ranks):
        ring = f"quant_ring_all_reduce-{wire}-{axes}"
        mono = f"quant_psum-{wire}-{axes}"
        for out in ("y", "dx"):
            np.testing.assert_array_equal(arrays[f"{ring}/{out}"],
                                          arrays[f"{mono}/{out}"])
        first = ranks[members(axes, rank)[0]][0]
        np.testing.assert_array_equal(arrays[f"{mono}/y"],
                                      first[f"{mono}/y"])
        y, dx, _ = expected(dict(CASES[mono], op="ring_all_reduce"), rank)
        np.testing.assert_allclose(arrays[f"{mono}/y"], y, rtol=0.05,
                                   atol=0.05 * np.abs(y).max())
        ax = ["tp1", "tp2"] if axes == "tp" else [axes]
        want = [["pmax", ax, True, 1, 4], ["psum", ax, True, 1, 48 * 4]]
        assert metas[mono]["fwd"] == want and metas[mono]["bwd"] == want
        assert all(m[2] for m in metas[ring]["fwd"] + metas[ring]["bwd"])


@pytest.mark.parametrize("wire,axes", QUANT)
def test_quantized_reduce_scatter_ring_or_not(ranks, wire, axes):
    """The quantized reduce-scatter, ring or one collective, bit for bit
    the same; near the exact block of the sum; the backward's all-gather
    of the quantized cotangent equal too."""
    for rank, (arrays, _) in enumerate(ranks):
        a, b = (f"qrs-{wire}-{ring}-{axes}" for ring in (False, True))
        for out in ("y", "dx"):
            np.testing.assert_array_equal(arrays[f"{a}/{out}"],
                                          arrays[f"{b}/{out}"])
        y, dx, _ = expected(dict(CASES[a], op="ring_reduce_scatter"), rank)
        np.testing.assert_allclose(arrays[f"{a}/y"], y, rtol=0.05,
                                   atol=0.05 * np.abs(y).max())
        np.testing.assert_allclose(arrays[f"{a}/dx"], dx, rtol=0.05,
                                   atol=0.05 * np.abs(dx).max())


def _reference(fn, xs):
    """``fn`` on a 1-D mesh "x" of four host devices, rank r's input
    ``xs[r]``, inside ``shard_map`` with ``check_vma=False``; per-rank
    outputs stacked."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    stacked = jnp.asarray(np.stack(xs))

    def body(x):
        return jax.tree.map(lambda t: t[None], fn(x[0]))

    return jax.tree.map(np.asarray, jax.jit(shard_map(
        body, mesh=mesh, in_specs=P("x"), out_specs=P("x"),
        check_vma=False))(stacked))


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_wire_quantize_equals_the_reference_bit_for_bit(ranks, wire):
    case = CASES[f"q-{wire}"]
    q, scale = _reference(
        lambda x: ref_overlap.wire_quantize(x, "x", wire),
        [inputs(case, r)["x"] for r in range(4)])
    for rank, (arrays, _) in enumerate(ranks):
        np.testing.assert_array_equal(arrays[f"q-{wire}/q"], q[rank])
        np.testing.assert_array_equal(arrays[f"q-{wire}/scale"],
                                      np.reshape(scale[rank], (1,)))


@pytest.mark.parametrize("wire", ["int8", "fp8", "bf16"])
def test_rings_equal_the_references_rings_bit_for_bit(ranks, wire):
    """The quantized ring (and the bf16-wire ring: the same hops and sums
    in the same order) on four ranks against the reference's, forward and
    backward (the reference's custom VJP: the same ring on the
    cotangent)."""
    if wire == "bf16":
        name = "ar-bidir-tp"

        def fwd(x):
            return ref_overlap.ring_all_reduce(x, "x", 4)
    else:
        name = f"quant_ring_all_reduce-{wire}-tp"

        def fwd(x):
            return ref_overlap.quant_ring_all_reduce(x, "x", 4, wire)
    case = CASES[name]
    xs = [inputs(case, r)["x"] for r in range(4)]
    cts = [inputs(case, r)["ct"] for r in range(4)]
    y = _reference(fwd, xs)
    dx = _reference(fwd, cts)
    for rank, (arrays, _) in enumerate(ranks):
        np.testing.assert_array_equal(arrays[f"{name}/y"], y[rank])
        np.testing.assert_array_equal(arrays[f"{name}/dx"], dx[rank])
