"""The CUDA kernels' launch plans and the plain versions of their splits.

``ops.matmul_plan``, ``ops.attention_plan`` and ``ops.ssd_plan`` choose
tiles and splits from the shapes alone; here they are checked at every serving shape that
``chip_smoke.py`` times: each must give the card's 132 SMs a block, and the
splits must cover K (or the keys) exactly.  ``ref.matmul_split_ref`` and
``ref.attention_split_ref`` compute what the split kernels compute (fp32
partials summed in split order, the epilogue once; partial outputs with
their log-sum-exp, merged) and are held against the unsplit plain
versions.  fp32 inputs: only the order of summation differs (1e-5).
"""
import collections
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CS = _chip_smoke()
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
