"""The CUDA kernels' launch plans and the plain versions of their splits.

``ops.matmul_plan``, ``ops.attention_plan`` and ``ops.ssd_plan`` choose
tiles and splits from the shapes alone; here they are checked at every serving shape that
``chip_smoke.py`` times: each must give the card's 132 SMs a block, and the
splits must cover K (or the keys) exactly.  ``ref.matmul_split_ref`` and
``ref.attention_split_ref`` compute what the split kernels compute (fp32
partials summed in split order, the epilogue once; partial outputs with
their log-sum-exp, merged) and are held against the unsplit plain
versions.  fp32 inputs: only the order of summation differs (1e-5).
``ops.attention_bwd_plan`` (the attention backward's dK/dV items) is
checked at the training shape and the card tests' shapes, and its plain
twin ``ref.attention_bwd_split_ref`` against ``ref.attention_bwd_ref``
and against ``jax.grad`` of the JAX package's ``attention_core``.
"""
import collections
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_ROOT = Path(__file__).resolve().parents[1]
_CS = _load(_ROOT / "chip_smoke.py", "chip_smoke")
#: the attention backward's card-test shapes (that file imports no JAX)
FA_BWD_CASES = _load(_ROOT / "tests/test_torch_cuda.py",
                     "torch_cuda_cases").FA_BWD_CASES
_M = (_CS.SERVE["prefill_chunk"], _CS.SERVE["slots"])
GEMMS = [(path, label, M, K, N)
         for path, gemms in (("llama3-8b", _CS.LLAMA_GEMMS),
                             ("zamba2-7b", _CS.ZAMBA_GEMMS))
         for label, K, N, _ in gemms for M in _M]


def _covers(ranges, end):
    """Contiguous, non-empty, from 0 to ``end``."""
    assert ranges[0][0] == 0 and ranges[-1][1] == end
    assert all(k0 < k1 for k0, k1 in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def _check_stream_k(plan):
    """Every tile's K steps are covered once, in block order, by the runs
    of the blocks that share it; a tile is finished once: by its one block
    when that block covers it whole, else by the last of its several
    blocks (whose runs are then all partial).  Every block gets a run of
    the same length, give or take one unit."""
    per_block = [0] * plan.blocks
    for tile in range(plan.tiles):
        runs = plan.tile_runs(tile)
        _covers([(k0, k1) for _, k0, k1 in runs], plan.kt)
        assert [p for p, *_ in runs] == list(range(runs[0][0],
                                                   runs[-1][0] + 1))
        assert (len(runs) == 1) == (runs[0][2] - runs[0][1] == plan.kt)
        for p, k0, k1 in runs:
            per_block[p] += k1 - k0
    assert max(per_block) - min(per_block) <= 1
    assert max(len(plan.tile_runs(t)) for t in range(plan.tiles)) \
        == plan.max_share


@pytest.mark.parametrize("path,label,M,K,N", GEMMS,
                         ids=[f"{p}-{lb}-M{m}" for p, lb, m, _, _ in GEMMS])
def test_matmul_plan_fills_the_card_at_every_serving_shape(path, label, M, K,
                                                           N):
    plan = ops.matmul_plan(M, N, K)
    bm, bn, bk, _ = ops.MATMUL_VARIANTS[plan.variant]
    assert (plan.bm, plan.bn, plan.bk) == (bm, bn, bk)
    assert plan.bm == 16 if M <= 16 or N * K <= 4 << 20 else plan.bm == 64
    assert plan.tiles == -(-M // bm) * -(-N // bn)
    assert plan.kt == -(-K // bk)
    assert plan.blocks in (ops.SMS, ops.BLOCKS_PER_SM * ops.SMS)
    _check_stream_k(plan)
    # no tile is merged from more than a few dozen partials
    assert plan.max_share <= 33, plan


@pytest.mark.parametrize("M,N,K", [(4, 240, 3584), (64, 240, 3584),
                                   (70, 1000, 1024), (37, 77, 100),
                                   (64, 3584, 14336), (1, 8, 8)])
def test_matmul_plan_runs_cover_k_at_odd_shapes(M, N, K):
    plan = ops.matmul_plan(M, N, K)
    assert 1 <= plan.blocks <= min(ops.BLOCKS_PER_SM * ops.SMS,
                                   plan.tiles * plan.kt)
    _check_stream_k(plan)


@pytest.mark.parametrize("M,K,N,act,bias,sms", [
    (64, 3584, 96, "silu", True, 132),   # shared tiles, bias + silu
    (4, 1000, 240, "gelu", True, 132),   # K not a multiple of the runs
    (37, 100, 77, None, True, 5),        # ragged, two K steps
    (16, 640, 130, "silu", False, 7),    # runs that cross tile edges
])
def test_stream_k_plain_sums_in_order_then_applies_the_epilogue_once(
        M, K, N, act, bias, sms):
    plan = ops.matmul_plan(M, N, K, sms=sms)
    assert plan.max_share > 1
    rng = np.random.default_rng(M + K + N)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((K, N)) * K ** -0.5)
                         .astype(np.float32))
    bv = torch.from_numpy(rng.standard_normal(N).astype(np.float32)) \
        if bias else None
    want = ref.matmul_ref(a, b, bv, act)
    got = torch.empty_like(want)
    tiles_n = -(-N // plan.bn)
    for tile in range(plan.tiles):
        m0, n0 = tile // tiles_n * plan.bm, tile % tiles_n * plan.bn
        rows, cols = slice(m0, m0 + plan.bm), slice(n0, n0 + plan.bn)
        ranges = [(k0 * plan.bk, min(K, k1 * plan.bk))
                  for _, k0, k1 in plan.tile_runs(tile)]
        got[rows, cols] = ref.matmul_split_ref(
            a[rows], b[:, cols], None if bv is None else bv[cols], act,
            k_ranges=ranges)
        if act is not None and len(ranges) > 1:
            # an epilogue per partial would be another function
            per_part = sum(ref.epilogue(a[rows, k0:k1] @ b[k0:k1, cols],
                                        None if bv is None else bv[cols], act)
                           for k0, k1 in ranges)
            assert float((per_part - want[rows, cols]).abs().max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


ATTN = [  # (path, step, b, sq, hq, hkv, skv) of chip_smoke's timed calls
    ("llama3-8b", "prefill", 1, 64, 32, 8, 272),
    ("llama3-8b", "decode", 4, 1, 32, 8, 272),
    ("zamba2-7b", "prefill", 1, 64, 32, 32, 272),
    ("zamba2-7b", "decode", 4, 1, 32, 32, 272),
]


@pytest.mark.parametrize("path,step,b,sq,hq,hkv,skv", ATTN,
                         ids=[f"{p}-{s}" for p, s, *_ in ATTN])
def test_attention_plan_at_the_serving_shapes(path, step, b, sq, hq, hkv,
                                              skv):
    """A decode tick of llama3-8b (32 blocks) splits its keys until the
    blocks cover the card; zamba2-7b's (128 blocks) already fills most of
    it; a prefill chunk's 64-row tiles see too few key tiles (5) to pay
    for a merge."""
    plan = ops.attention_plan(b, sq, hq, hkv, skv)
    assert plan.row_tiles * plan.rows >= sq * hq // hkv
    # GQA packing: a decode tick's rows of one kv head fit one tile
    assert plan.row_tiles == -(-sq * (hq // hkv) // 64)
    blocks = b * hkv * plan.row_tiles * plan.splits
    if (path, step) == ("llama3-8b", "decode"):
        assert plan.splits == 5 and blocks >= ops.SMS, plan
    else:
        assert plan.splits == 1, plan
    _covers(plan.key_ranges(skv), skv)


def test_attention_plan_splits_long_rows():
    # one decode row over 4096 keys: as many splits as the kernel merges
    plan = ops.attention_plan(1, 1, 4, 1, 4096)
    assert plan.splits == ops.MAX_KV_SPLITS
    _covers(plan.key_ranges(4096), 4096)
    # a 64-row prefill tile over 4096 keys: splits of at least 4 key tiles
    plan = ops.attention_plan(1, 64, 32, 8, 4096)
    assert plan.splits == 5 and plan.tiles_per_split >= 4
    assert ops.attention_plan(8, 64, 32, 32, 272).splits == 1


def _qkv(rng, b, sq, sk, hq, hkv, d):
    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return randn(b, sq, hq, d), randn(b, sk, hkv, d), randn(b, sk, hkv, d)


@pytest.mark.parametrize("b,sq,hq,hkv,sk,q_off,kv_len,window,softcap,span", [
    # decode rows with many splits, most of which see no key
    (3, 1, 8, 2, 300, [137, 9, 0], [138, 10, 1], 0, 0.0, 16),
    # a prefill chunk at an offset, GQA 4:1
    (1, 24, 8, 2, 100, [40], [64], 0, 0.0, 32),
    # fully masked rows (kv_len 0) beside a live one
    (2, 5, 2, 2, 40, [0, 3], [0, 8], 0, 0.0, 8),
    # window + softcap: early splits hidden by the window
    (2, 12, 4, 4, 96, [10, 70], [22, 82], 8, 30.0, 16),
])
def test_split_kv_plain_matches_attention_ref(b, sq, hq, hkv, sk, q_off,
                                              kv_len, window, softcap, span):
    rng = np.random.default_rng(sk + sq)
    q, k, v = _qkv(rng, b, sq, sk, hq, hkv, 16)
    qo = torch.tensor(q_off, dtype=torch.int32)
    kl = torch.tensor(kv_len, dtype=torch.int32)
    ranges = [(k0, min(sk, k0 + span)) for k0 in range(0, sk, span)]
    kw = dict(window=window, softcap=softcap)
    got = ref.attention_split_ref(q, k, v, qo, kl, key_ranges=ranges, **kw)
    want = ref.attention_ref(q, k, v, qo, kl, **kw)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    dead = ~ref.attention_mask(sq, sk, qo, kl, window=window).any(-1)
    assert float(got[dead].abs().sum()) == 0.0


SSD = [  # (b, s, nh): zamba2-7b's prefill chunk, decode tick, one-token
    # step, long prompt and ragged run, then odd shapes
    (1, 64, 112), (4, 1, 112), (1, 1, 112), (1, 1024, 112), (2, 100, 112),
    (3, 37, 5), (1, 2, 1), (7, 1, 3), (2, 64, 66), (65, 5, 2), (1, 9, 300)]


@pytest.mark.parametrize("b,s,nh", SSD)
def test_ssd_plan_covers_each_row_head_and_state_row_once(b, s, nh):
    """Every (batch row, head, state row p) falls in exactly one block, in
    the kernel's grid order; s = 1 takes the one-token kernel's 16-row
    blocks, a longer run a split the chunked kernel takes."""
    plan = ops.ssd_plan(b, s, nh)
    seen = collections.Counter()
    blocks = list(plan.block_rows())
    for bi, h, p0, p1 in blocks:
        assert 0 <= p0 < p1 <= 64 and p1 - p0 == plan.rows
        seen.update((bi, h, p) for p in range(p0, p1))
    assert len(blocks) == plan.blocks
    assert len(seen) == b * nh * 64 and set(seen.values()) == {1}
    assert plan.one_token == (s == 1)
    if plan.one_token:
        assert plan.rows == ops.SSD_STEP_ROWS
    else:
        assert plan.splits in ops.SSD_SPLITS


def test_ssd_plan_splits_until_half_the_card_has_a_block():
    """A prefill chunk of one batch row takes one block per head at
    zamba2-7b's 112 heads, 2 splits at the 56 heads of one of 2 tensor-
    parallel ranks and 4 at the 28 of one of 4 (112 blocks each); a decode
    tick and a one-token step launch 4 blocks of 16 rows per (batch row,
    head)."""
    for nh, splits in ((112, 1), (56, 2), (28, 4), (7, 4)):
        assert ops.ssd_plan(1, 64, nh).splits == splits
    assert ops.ssd_plan(2, 64, 28).splits == 2
    assert ops.ssd_plan(1, 1, 112).blocks == 448
    assert ops.ssd_plan(4, 1, 112).blocks == 1792
    for b, s, nh in SSD[:5]:
        assert 2 * ops.ssd_plan(b, s, nh).blocks >= ops.SMS


NORMS = [  # (rows, width): llama3-8b's and zamba2-7b's block norms at a
    # prefill chunk, a decode tick and a ragged count, zamba2-7b's grouped
    # norm at both steps and a one-token step, then odd shapes
    (64, 4096), (4, 4096), (37, 4096), (64, 3584), (4, 3584), (37, 3584),
    (7168, 64), (448, 64), (112, 64), (1, 1024), (4144, 1024), (3, 8),
    (5, 136), (100000, 2048), (1, 512), (300, 4088)]


@pytest.mark.parametrize("rows,width", NORMS)
def test_rmsnorm_plan_holds_each_row_in_whole_warps(rows, width):
    """A variant the kernel has; its threads hold the whole row; a block of
    whole warps within the thread limit; rows per block a power of two."""
    plan = ops.rmsnorm_plan(rows, width)
    assert (plan.threads, plan.vectors) in ops.RMSNORM_VARIANTS
    assert plan.threads * plan.vectors * 8 >= width
    threads = plan.threads * plan.rows
    assert threads % 32 == 0 and threads <= ops.RMSNORM_MAX_THREADS
    assert plan.rows & (plan.rows - 1) == 0
    if width <= 64:
        assert plan.threads == 8
    if width in (3584, 4096):
        assert (plan.threads, plan.vectors, plan.rows) == (128, 4, 1)


# ---------------------------------------------------------------------------
# The attention backward's dK/dV plan
# ---------------------------------------------------------------------------


def _bwd_case(c):
    """(b, sq, hq, hkv, skv, window, q_offset, kv_len) of a card-test
    case (``test_torch_cuda.FA_BWD_CASES``)."""
    b, sq = c["b"], c["s"]
    skv = c.get("skv") or sq
    return (b, sq, c["hq"], c["hkv"], skv, c.get("window", 0),
            list(c.get("q_offset") or (0,) * b),
            list(c.get("kv_len") or (skv,) * b))


def _visible_pairs(b, sq, hq, hkv, skv, window, q_offset, kv_len,
                   keys=ops.BWD_KEYS):
    """(bh, key tile, row tile) of every pair of a key tile (of ``keys``)
    and a row tile (64 positions of one q head) with a visible (row, key),
    from the plain mask."""
    grp = hq // hkv
    mask = ref.attention_mask(sq, skv, torch.tensor(q_offset),
                              torch.tensor(kv_len), window=window)
    pt, kt = -(-sq // 64), -(-skv // keys)
    padded = torch.zeros(b, pt * 64, kt * keys, dtype=torch.bool)
    padded[:, :sq, :skv] = mask
    tiles = padded.reshape(b, pt, 64, kt, keys).any(4).any(2)  # [b, pt, kt]
    return {(bi * hkv + kvh, k, p * grp + g)
            for bi, p, k in tiles.nonzero().tolist()
            for kvh in range(hkv) for g in range(grp)}


#: llama3-8b's training shape is among them
BWD_PLAN_CASES = [_bwd_case(c) for c in FA_BWD_CASES]


@pytest.mark.parametrize("b,sq,hq,hkv,skv,window,q_offset,kv_len",
                         BWD_PLAN_CASES)
def test_attention_bwd_plan_walks_every_visible_pair_once(
        b, sq, hq, hkv, skv, window, q_offset, kv_len):
    """The kernel's walk of the plan (each item clipped to the tiles its
    key tile sees for these offsets and lengths) covers every visible
    (key tile, row tile) pair exactly once and no invisible one; every key
    tile has items, their parts numbered in order, split ones in slots of
    their own."""
    plan = ops.attention_bwd_plan(b, sq, hq, hkv, skv, True, window, d=128)
    seen = collections.Counter()
    for bh, kt, _, tiles in plan.walk(sq, q_offset, kv_len, True, window):
        seen.update((bh, kt, t) for t in tiles)
    assert set(seen.values()) <= {1}
    assert set(seen) == _visible_pairs(b, sq, hq, hkv, skv, window,
                                       q_offset, kv_len)
    by_tile = collections.defaultdict(list)
    for bh, kt, r0, r1, part, parts, slot in plan.items:
        by_tile[bh, kt].append((part, parts, slot))
        assert 0 <= r0 <= r1 <= plan.row_tiles and r1 - r0 <= plan.max_len
    assert len(by_tile) == b * hkv * plan.key_tiles
    slots = collections.Counter()
    for parts in by_tile.values():
        assert sorted(p for p, *_ in parts) == list(range(parts[0][1]))
        if parts[0][1] > 1:
            slots.update(slot + p for p, _, slot in parts)
        else:
            assert parts[0][2] == -1
    assert set(slots.values()) <= {1} and len(slots) == plan.slots
    assert 1 <= plan.blocks <= ops.BWD_BLOCKS_PER_SM * ops.SMS


def test_attention_bwd_plan_balances_the_causal_square():
    """At llama3-8b's s = 2048 key tile 0 sees 128 row tiles and key tile
    31 sees 4; the plan's items are within 1.25x of their mean, longest
    first, about two for each of the 264 blocks."""
    plan = ops.attention_bwd_plan(1, 2048, 32, 8, 2048, d=128)
    spans = [ops.bwd_visible_tiles(kt, 0, 2048, 2048, 4, True, 0)
             for kt in (0, 31)]
    assert plan.key_tiles == 32
    assert [t1 - t0 for t0, t1 in spans] == [128, 4]
    lengths = plan.lengths()
    assert max(lengths) <= 1.25 * sum(lengths) / len(lengths)
    assert lengths == sorted(lengths, reverse=True)
    assert plan.blocks == 2 * ops.SMS
    assert len(lengths) <= 3 * plan.blocks


SPLIT_BWD = [  # (b, sq, hq, hkv, skv, window, softcap, q_offset, kv_len)
    (1, 200, 8, 2, 200, 0, 0.0, [0], [200]),           # GQA 4:1, ragged
    (2, 130, 4, 4, 130, 48, 0.0, [0, 0], [130, 130]),  # window, b = 2
    (2, 96, 4, 2, 128, 0, 30.0, [32, 0], [128, 70]),   # offsets, softcap
]


def _split_parts(plan, sq, skv, q_offset, kv_len, window):
    """``ref.attention_bwd_split_ref``'s parts: (bh, first key, end key)
    of each key tile -> its items' row tiles, in part order."""
    parts = collections.defaultdict(list)
    for bh, kt, part, tiles in sorted(
            plan.walk(sq, q_offset, kv_len, True, window),
            key=lambda w: w[:3]):
        k0 = plan.keys * kt
        parts[bh, k0, min(k0 + plan.keys, skv)].append(tiles)
    return parts


def _bwd_inputs(rng, b, sq, hq, hkv, skv, d=16, dv=None):
    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    dv = d if dv is None else dv
    return (randn(b, sq, hq, d), randn(b, skv, hkv, d), randn(b, skv, hkv, dv),
            randn(b, sq, hq, dv))


@pytest.mark.parametrize("b,sq,hq,hkv,skv,window,softcap,q_offset,kv_len",
                         SPLIT_BWD)
@pytest.mark.parametrize("max_len", [None, 1])
def test_split_backward_plain_matches_attention_bwd_ref(
        monkeypatch, b, sq, hq, hkv, skv, window, softcap, q_offset, kv_len,
        max_len):
    """dK/dV as partials per item, summed in item order, against the
    unsplit plain backward: fp32, only the order of summation differs
    (1e-5).  ``max_len`` 1: one row tile an item, the most partials."""
    if max_len is not None:
        monkeypatch.setattr(ops, "BWD_MIN_ITEM", max_len)
        monkeypatch.setattr(ops, "BWD_ITEMS_PER_BLOCK", 10 ** 6)
    ops.attention_bwd_plan.cache_clear()
    try:
        plan = ops.attention_bwd_plan(b, sq, hq, hkv, skv, True, window,
                                      d=16)
    finally:
        ops.attention_bwd_plan.cache_clear()
    if max_len is not None:
        assert plan.max_len == max_len and any(len(p) > 1 for p in _split_parts(
            plan, sq, skv, q_offset, kv_len, window).values())
    rng = np.random.default_rng(sq + skv)
    q, k, v, do = _bwd_inputs(rng, b, sq, hq, hkv, skv)
    qo, kl = torch.tensor(q_offset), torch.tensor(kv_len)
    opts = dict(window=window, softcap=softcap)
    out, lse = ref.attention_lse_ref(q, k, v, qo, kl, **opts)
    want = ref.attention_bwd_ref(q, k, v, out, do, lse, qo, kl, **opts)
    got = ref.attention_bwd_split_ref(
        q, k, v, out, do, lse, qo, kl,
        parts=_split_parts(plan, sq, skv, q_offset, kv_len, window), **opts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("b,sq,hq,hkv,skv,window,softcap,q_offset,kv_len",
                         SPLIT_BWD)
def test_split_backward_plain_matches_jax_grad_of_attention_core(
        b, sq, hq, hkv, skv, window, softcap, q_offset, kv_len):
    """The split schedule's dq, dk, dv against ``jax.grad`` of the JAX
    package's ``attention_core`` (the plain jnp attention its Pallas kernel
    computes, on the CPU as the package's own tests run it) on the same
    numpy-made inputs: fp32, 1e-4 (the JAX side differentiates through
    its softmax; every row of these cases sees a key)."""
    d = 16
    plan = ops.attention_bwd_plan(b, sq, hq, hkv, skv, True, window, d=d)
    rng = np.random.default_rng(sq * 7 + skv)
    q, k, v, do = _bwd_inputs(rng, b, sq, hq, hkv, skv, d)
    qo, kl = torch.tensor(q_offset), torch.tensor(kv_len)
    opts = dict(window=window, softcap=softcap)
    out, lse = ref.attention_lse_ref(q, k, v, qo, kl, **opts)
    assert torch.isfinite(lse).all()
    got = ref.attention_bwd_split_ref(
        q, k, v, out, do, lse, qo, kl,
        parts=_split_parts(plan, sq, skv, q_offset, kv_len, window), **opts)
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), head_dim=d,
                              attn_softcap=softcap)

    def loss(q, k, v):
        o = jax_layers.attention_core(cfg, q, k, v, jnp.asarray(q_offset),
                                      kv_len=jnp.asarray(kv_len),
                                      window=window)
        return jnp.sum(o * jnp.asarray(do.numpy()))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# q/k 192 with a V of 128 (deepseek-v3's MLA): the serving kernel's one
# split, and the backward's key tiles of 128
# ---------------------------------------------------------------------------

#: (b, sq, hq, hkv, skv, window, q_offset, kv_len) at (192, 128): MHA as
#: MLA is, a ragged length that ends inside a 128-key tile, offsets and
#: kv lengths the kernel clips to
QK192_BWD = [
    (2, 200, 4, 4, 200, 0, [0, 0], [200, 200]),
    (1, 2048, 8, 8, 2048, 0, [0], [2048]),
    (2, 96, 4, 4, 300, 0, [204, 0], [300, 130]),
    (1, 330, 2, 2, 330, 100, [0], [330]),
]


@pytest.mark.parametrize("b,sq,hq", [(b, sq, hq) for b in (1, 4)
                                     for sq in (1, 2, 16, 17, 64, 65, 127)
                                     for hq in (1, 4, 16, 128)])
def test_cache_free_qk192_v128_is_variant_0_with_one_split(b, sq, hq):
    """A cache-free MLA forward (q/k 192, V 128, skv = sq, MHA) below
    ``ref.TRAIN_TILE`` rows -- the MTP draft block's tick of 2 rows a slot,
    a prefill chunk, a short training sequence -- is variant 0 with one
    key split, as its instance (``flash_kernel<192>``) requires: at most
    two 64-key tiles, and a split wants four of them above 16 rows."""
    plan = ops.attention_plan(b, sq, hq, hq, sq, d=192)
    assert (plan.variant, plan.splits) == (0, 1)
    assert plan.row_tiles * plan.rows >= sq
    assert plan.key_ranges(sq) == [(0, sq)]


@pytest.mark.parametrize("b,sq,hq,hkv,skv,window,q_offset,kv_len", QK192_BWD)
def test_attention_bwd_plan_at_qk192_walks_128_key_tiles_once(
        b, sq, hq, hkv, skv, window, q_offset, kv_len):
    """At (192, 128) the backward's key tiles are 128 keys (``bwd_keys``),
    and the kernel's walk covers every visible (key tile, row tile) pair
    of 128 keys and 64 positions exactly once and no invisible one; other
    head dims keep 64."""
    plan = ops.attention_bwd_plan(b, sq, hq, hkv, skv, True, window, d=192,
                                  dv=128)
    assert plan.keys == 128 == ops.bwd_keys(192, 128)
    assert plan.key_tiles == -(-skv // 128)
    assert {ops.bwd_keys(d) for d in (64, 112, 128, 192, 256)} == {64}
    seen = collections.Counter()
    for bh, kt, _, tiles in plan.walk(sq, q_offset, kv_len, True, window):
        seen.update((bh, kt, t) for t in tiles)
    assert set(seen.values()) <= {1}
    assert set(seen) == _visible_pairs(b, sq, hq, hkv, skv, window,
                                       q_offset, kv_len, keys=128)
    assert 1 <= plan.blocks <= ops.SMS


@pytest.mark.parametrize("b,sq,hq,hkv,skv,window,q_offset,kv_len",
                         [c for c in QK192_BWD if c[1] < 1000])
@pytest.mark.parametrize("max_len", [None, 1])
def test_split_backward_plain_at_qk192_matches_attention_bwd_ref(
        monkeypatch, b, sq, hq, hkv, skv, window, q_offset, kv_len, max_len):
    """``ref.attention_bwd_split_ref`` at q/k 192 with a V of 128 on the
    plan's 128-key tiles (dV at V's width) against the unsplit plain
    backward: fp32, only the order of summation differs (1e-5).
    ``max_len`` 1: one row tile an item, the most partials."""
    if max_len is not None:
        monkeypatch.setattr(ops, "BWD_MIN_ITEM", max_len)
        monkeypatch.setattr(ops, "BWD_ITEMS_PER_BLOCK", 10 ** 6)
    ops.attention_bwd_plan.cache_clear()
    try:
        plan = ops.attention_bwd_plan(b, sq, hq, hkv, skv, True, window,
                                      d=192, dv=128)
    finally:
        ops.attention_bwd_plan.cache_clear()
    parts = _split_parts(plan, sq, skv, q_offset, kv_len, window)
    assert all(k1 - k0 <= 128 for _, k0, k1 in parts)
    assert any(k1 - k0 > 64 for _, k0, k1 in parts)
    rng = np.random.default_rng(sq + 3 * skv)
    q, k, v, do = _bwd_inputs(rng, b, sq, hq, hkv, skv, d=192, dv=128)
    qo, kl = torch.tensor(q_offset), torch.tensor(kv_len)
    out, lse = ref.attention_lse_ref(q, k, v, qo, kl, window=window)
    want = ref.attention_bwd_ref(q, k, v, out, do, lse, qo, kl,
                                 window=window)
    got = ref.attention_bwd_split_ref(q, k, v, out, do, lse, qo, kl,
                                      parts=parts, window=window)
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
