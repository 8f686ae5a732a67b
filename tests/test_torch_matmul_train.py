"""The matmul's training-regime plan (variant 2 of ``csrc/matmul.cu``) and a
plain mirror of its persistent schedule.

``ops.matmul_plan`` sends every launch with ``ops.TRAIN_M`` rows or more,
and every launch that reads A transposed (wgrad's ``a^T``), to variant 2: 128x256 tiles, one block per SM finishing
whole tiles in waves, and a last wave that leaves most SMs idle cut into
stream-K runs.  Here: the plan at every llama3-8b and zamba2-7b training
shape (forward, dgrad ``dz @ b^T``, wgrad ``a^T @ dz``); the serving
shapes' plans against the rule they had before variant 2 existed; a numpy
mirror of the kernel's walk (``WsWalk``, ``ws_tile_origin``) that covers
every (tile, K step) once, sums a split tile's partials in block order
and gives every block work within one tile of the mean; and that
schedule, run in fp32 with its partials kept in the kernel's workspace
slots, against ``ref.matmul_ref`` and the JAX package's matmul (Pallas in
interpret mode) at small ragged shapes (1e-5 and 1e-4: only the order of
summation differs).
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CS = _load(Path(__file__).resolve().parents[1] / "chip_smoke.py",
            "chip_smoke_train")
T = _CS.TRAIN_SHAPE["batch"] * _CS.TRAIN_SHAPE["seq"]
TRAIN_GEMMS = [(path, label, K, N)
               for path, gemms in (("llama3-8b", _CS.LLAMA_GEMMS),
                                   ("zamba2-7b", _CS.ZAMBA_GEMMS))
               for label, K, N, _ in gemms]


def _roles(K, N):
    """(M, N, K, a_trans) of a projection's three launches in a step."""
    return {"forward": (T, N, K, False), "dgrad": (T, K, N, False),
            "wgrad": (K, N, T, True)}


CASES = [(path, label, role, *shape)
         for path, label, K, N in TRAIN_GEMMS
         for role, shape in _roles(K, N).items()]
IDS = [f"{p}-{lb}-{r}" for p, lb, r, *_ in CASES]


def _serving_rule(M, N, K, sms=ops.SMS):
    """The plan every shape had before variant 2 (stream-K over 1 or 2
    blocks an SM): the serving shapes must keep it."""
    variant = 0 if M <= 16 or 2 * K * N <= 8 << 20 else 1
    bm, bn, bk = ((16, 64, 64), (64, 128, 64))[variant]
    tiles, kt = -(-M // bm) * -(-N // bn), -(-K // bk)
    per_sm = 2
    while per_sm > 1 and tiles * kt < per_sm * sms * 128:
        per_sm -= 1
    return (variant, bm, bn, bk, tiles, kt, min(per_sm * sms, tiles * kt),
            0)


@pytest.mark.parametrize("path,label,role,M,N,K,a_trans", CASES, ids=IDS)
def test_every_training_shape_takes_the_training_variant(path, label, role,
                                                         M, N, K, a_trans):
    plan = ops.matmul_plan(M, N, K, a_trans=a_trans)
    assert plan.variant == 2 and plan.name == "128x256 wgmma ws"
    assert (plan.bm, plan.bn, plan.bk) == (128, 256, 64)
    assert plan.tiles == -(-M // 128) * -(-N // 256)
    assert plan.kt == -(-K // 64)
    assert plan.blocks == min(ops.SMS, plan.tiles) or plan.whole < plan.tiles
    # the lm_head's dgrad (256 tiles, 2004 K steps) runs two whole waves
    if label == "lm_head" and path == "llama3-8b" and role == "dgrad":
        assert (plan.tiles, plan.kt, plan.whole) == (256, 2004, 256)


SERVING = [(path, label, M, K, N)
           for path, gemms in (("llama3-8b", _CS.LLAMA_GEMMS),
                               ("zamba2-7b", _CS.ZAMBA_GEMMS))
           for label, K, N, _ in gemms
           for M in (_CS.SERVE["prefill_chunk"], _CS.SERVE["slots"])]


@pytest.mark.parametrize("path,label,M,K,N", SERVING,
                         ids=[f"{p}-{lb}-M{m}" for p, lb, m, _, _ in SERVING])
def test_serving_shapes_keep_their_plans(path, label, M, K, N):
    assert dataclasses.astuple(ops.matmul_plan(M, N, K)) == \
        _serving_rule(M, N, K)


def _walk(plan):
    """The kernel's walk in numpy: per block, its items (tile, first K
    step, end K step) -- the tiles it finishes whole (p, p + P, ... below
    ``whole``), then its stream-K run cut at tile edges."""
    P, kt, whole = plan.blocks, plan.kt, plan.whole
    W = (plan.tiles - whole) * kt
    starts = (np.arange(P + 1, dtype=np.int64) * W) // P
    out = []
    for p in range(P):
        items = [(int(t), 0, kt) for t in np.arange(p, whole, P)]
        u = np.arange(starts[p], starts[p + 1])
        for t in np.unique(u // kt):
            ks = u[u // kt == t] % kt
            items.append((whole + int(t), int(ks[0]), int(ks[-1]) + 1))
        out.append(items)
    return out


#: row tiles of a group in variant 2's tile order (the kernel's kGroupM)
GROUP_M = 16


def _tile_origin(plan, tile, M, N):
    """The kernel's ``ws_tile_origin``: tile ``tile``'s first row and
    column, in groups of ``GROUP_M`` row tiles, column-major inside a
    group."""
    tiles_n = -(-N // plan.bn)
    g, r = divmod(tile, GROUP_M * tiles_n)
    rows = min(-(-M // plan.bm) - g * GROUP_M, GROUP_M)
    return (g * GROUP_M + r % rows) * plan.bm, r // rows * plan.bn


def _check_schedule(plan, M, N):
    walk = _walk(plan)
    cover = np.zeros((plan.tiles, plan.kt), dtype=np.int32)
    per_block = np.zeros(plan.blocks, dtype=np.int64)
    touches = {}
    for p, items in enumerate(walk):
        for t, k0, k1 in items:
            cover[t, k0:k1] += 1
            per_block[p] += k1 - k0
            touches.setdefault(t, []).append((p, k0, k1))
    # every output tile once: each of its K steps by exactly one block
    assert (cover == 1).all()
    # a split tile's blocks, in block order, cover its K steps in order:
    # the order the merging block sums their partials in
    for t, runs in touches.items():
        assert sorted(runs) == runs == plan.tile_runs(t)
        assert [k0 for _, k0, _ in runs] == [0] + [k1 for *_, k1 in runs[:-1]]
        assert (len(runs) == 1) == (t < plan.whole or runs[0][2] - runs[0][1]
                                    == plan.kt)
    # every block within one tile of the mean
    mean = per_block.mean()
    assert per_block.max() - mean <= plan.kt and mean - per_block.min() \
        <= plan.kt
    # the grouped tile order visits every tile origin once
    origins = {_tile_origin(plan, t, M, N) for t in range(plan.tiles)}
    assert origins == {(m0, n0) for m0 in range(0, M, plan.bm)
                       for n0 in range(0, N, plan.bn)}


@pytest.mark.parametrize("path,label,role,M,N,K,a_trans", CASES, ids=IDS)
def test_the_persistent_schedule_covers_every_tile_once(path, label, role, M,
                                                        N, K, a_trans):
    plan = ops.matmul_plan(M, N, K, a_trans=a_trans)
    assert plan.variant == 2
    _check_schedule(plan, M, N)


@pytest.mark.parametrize("M,N,K,sms", [
    (300, 520, 700, 4),     # 8 whole tiles, the ninth split over 4 blocks
    (200, 300, 130, 16),    # 4 tiles, all split over 12 blocks
    (600, 1000, 2100, 5),   # 20 tiles in 4 whole waves
    (2100, 1000, 520, 132),  # 68 tiles: fewer than SMs, all split
    (520, 1000, 2100, 132),  # the ragged wgrad of the card test
])
def test_the_split_rule_and_schedule_at_small_shapes(M, N, K, sms):
    plan = ops.matmul_plan(M, N, K, sms, a_trans=True)
    rest = plan.tiles % sms
    assert (plan.whole < plan.tiles) == (
        rest > 0 and sms - rest > ops.SPLIT_IDLE * sms
        and (rest == plan.tiles or rest * plan.kt >= sms))
    _check_schedule(plan, M, N)


def _run_schedule(plan, a, b, bias, act):
    """``plan``'s schedule as the kernel runs it, in fp32: whole tiles
    finished by their block; a split tile's partials written to the
    block's workspace slot (2 p for the tile its run starts in, 2 p + 1
    for the one it ends in) and summed in block order, then the epilogue
    once."""
    M, K = a.shape
    N = b.shape[1]
    bm, bn, bk = plan.bm, plan.bn, plan.bk
    out = torch.empty(M, N, dtype=torch.float32)
    slots = {}

    def product(t, k0, k1):
        m0, n0 = _tile_origin(plan, t, M, N)
        ks = slice(k0 * bk, min(K, k1 * bk))
        return (m0, n0), a[m0:m0 + bm, ks] @ b[ks, n0:n0 + bn]

    for p in range(plan.blocks):
        first = plan.whole + plan._start(p) // plan.kt
        for t, k0, k1 in _walk(plan)[p]:
            (m0, n0), part = product(t, k0, k1)
            if k0 == 0 and k1 == plan.kt:
                out[m0:m0 + bm, n0:n0 + bn] = part
                continue
            slot = 2 * p + (0 if t == first else 1)
            assert slot not in slots   # a slot holds one partial
            slots[slot] = (t, part)
    for t in range(plan.whole, plan.tiles):
        runs = plan.tile_runs(t)
        if len(runs) == 1:
            continue
        m0, n0 = _tile_origin(plan, t, M, N)
        total = torch.zeros_like(out[m0:m0 + bm, n0:n0 + bn])
        for q, _, _ in runs:
            first = plan.whole + plan._start(q) // plan.kt
            tile, part = slots[2 * q + (0 if t == first else 1)]
            assert tile == t
            total = total + part
        out[m0:m0 + bm, n0:n0 + bn] = total
    return ref.epilogue(out, bias, act)


@pytest.mark.parametrize("M,K,N,sms,act,bias,a_trans", [
    (300, 700, 520, 4, None, False, True),     # one tile split over 4
    (200, 130, 300, 16, "silu", True, True),   # every tile split
    (600, 2100, 1000, 5, "gelu", True, True),  # whole waves only
    (330, 900, 610, 7, None, True, True),      # ragged, split remainder
    (520, 2048, 2100, 132, "silu", True, False),  # a forward, M >= 512
])
def test_the_schedule_reproduces_the_plain_matmul(M, K, N, sms, act, bias,
                                                  a_trans):
    plan = ops.matmul_plan(M, N, K, sms, a_trans=a_trans)
    assert plan.variant == 2
    rng = np.random.default_rng(M + K + N)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    bv = rng.standard_normal(N).astype(np.float32) if bias else None
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tbias = None if bv is None else torch.from_numpy(bv)
    got = _run_schedule(plan, ta, tb, tbias, act)
    torch.testing.assert_close(got, ref.matmul_ref(ta, tb, tbias, act),
                               rtol=1e-5, atol=1e-5)
    # the Pallas kernel in interpret mode, on 256-wide blocks (few steps)
    pallas = jax_ops.matmul(jnp.asarray(a), jnp.asarray(b),
                            None if bv is None else jnp.asarray(bv),
                            activation=act, block_m=256, block_n=256,
                            block_k=256, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-4,
                               atol=1e-4)


def test_matmul_backward_reads_a_transposed_on_the_cpu_path():
    """wgrad hands the kernel ``a^T`` as a view: on the CPU the plain
    backward, through the same wrapper, equals the JAX package's product
    of the transposed activation."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((96, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 72)) / 6).astype(np.float32)
    dz = rng.standard_normal((96, 72)).astype(np.float32)
    da, db = ops.matmul_backward(torch.from_numpy(a), torch.from_numpy(w),
                                 torch.from_numpy(dz))
    np.testing.assert_allclose(db.numpy(), np.asarray(
        jax_ref.matmul_ref(jnp.asarray(a).T, jnp.asarray(dz))), rtol=1e-4,
        atol=1e-4)
    np.testing.assert_allclose(da.numpy(), np.asarray(
        jax_ref.matmul_ref(jnp.asarray(dz), jnp.asarray(w).T)), rtol=1e-4,
        atol=1e-4)
    assert ops.matmul_plan(40, 72, 96, a_trans=True).variant == 2
