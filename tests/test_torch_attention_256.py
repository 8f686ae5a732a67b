"""The training attention at head dim 256 (gemma2-2b) on the CPU: the launch
plan of ``csrc/flash_attention_train.cu``'s 64-key instance and of the
backward's two-warpgroup blocks, the schedule, and the plain mirror of the
forward's order.

``ops.attention_plan`` gives variant 1, in row tiles of 128 and key tiles of
64, at gemma2-2b's training shape and at its path check's; its serving
shapes (a prefill chunk, a decode tick) stay on variant 0.
``ops.attention_train_schedule`` at head dim 256 deals every (batch row, q
head, row tile) once, and the items' key tiles (``ref.train_key_tiles`` with
64 keys) cover every (row tile, key tile) pair with a visible key once.
``ref.attention_train_ref`` in that order is held against the JAX package's
``models.layers.attention_core`` in fp32 within 1e-4 (softcap 50, causal, a
window of 512 that bites, GQA 8 / 4); ``ops.attention_bwd_plan`` at head dim
256 walks every visible (key tile, row tile) pair once.
``tests/test_torch_cuda.py`` holds the kernels themselves on the card.
"""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

GEMMA = dict(hq=8, hkv=4, d=256)
#: fp32 against fp32: only the order of the sums differs
CORE_TOL = dict(rtol=1e-4, atol=1e-4)

# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

GEMMA_TRAIN = {  # chip_smoke's train-gemma step and its path check
    "train-gemma s=2048": (1, 2048),
    "path check s=256": (1, 256),
}


@pytest.mark.parametrize("case", list(GEMMA_TRAIN))
def test_attention_plan_takes_the_64_key_instance_at_gemma_training(case):
    b, s = GEMMA_TRAIN[case]
    plan = ops.attention_plan(b, s, GEMMA["hq"], GEMMA["hkv"], s, d=256)
    assert plan.variant == 1 and plan.splits == 1
    assert plan.rows == ref.TRAIN_TILE and plan.bkv == ref.train_keys(256)
    assert plan.bkv == 64
    assert plan.row_tiles == -(-s // 128)
    assert plan.tiles_per_split == -(-s // 64)
    assert plan.key_ranges(s) == [(0, s)]
    # the other head dims keep their 128-key tiles
    for d in (112, 128):
        assert ref.train_keys(d) == ref.TRAIN_TILE
        assert ops.attention_plan(b, s, 32, 8, s, d=d).bkv == ref.TRAIN_TILE


GEMMA_SERVING = {  # (b, sq, skv, q_offset): chip_smoke's serve-gemma steps
    "prefill chunk": (1, 64, 272),
    "decode tick": (4, 1, 272),
    "a whole prompt's chunk": (1, 64, 4096),
}


@pytest.mark.parametrize("case", list(GEMMA_SERVING))
def test_gemma_serving_shapes_stay_on_variant_0(case):
    b, sq, skv = GEMMA_SERVING[case]
    plan = ops.attention_plan(b, sq, GEMMA["hq"], GEMMA["hkv"], skv, d=256)
    assert plan == ops.split_plan(b, sq, GEMMA["hq"], GEMMA["hkv"], skv)
    assert plan.variant == 0 and plan.rows == plan.bkv == 64


SCHEDULES_256 = [  # (b, sq, hq, hkv, skv, causal, window)
    (1, 2048, 8, 4, 2048, True, 0),      # train-gemma
    (1, 2048, 8, 4, 2048, True, 512),    # its window of 512
    (1, 256, 8, 4, 256, True, 0),        # the path check
    (2, 300, 4, 1, 420, True, 0),        # ragged, skv > sq
    (2, 260, 8, 2, 260, True, 64),
    (1, 200, 4, 4, 330, False, 0),
]


def _visible_tiles(b, sq, hq, skv, causal, window, keys):
    """(batch row, q head, row tile, key tile) of every 128-row x
    ``keys``-key tile with a visible (row, key) at q_offset 0 and kv_len
    skv, from the plain mask."""
    mask = ref.attention_mask(sq, skv, torch.zeros(b, dtype=torch.long),
                              torch.full((b,), skv), causal=causal,
                              window=window).expand(-1, sq, -1)
    rt, kt = -(-sq // ref.TRAIN_TILE), -(-skv // keys)
    padded = torch.zeros(b, rt * ref.TRAIN_TILE, kt * keys, dtype=torch.bool)
    padded[:, :sq, :skv] = mask
    tiles = padded.reshape(b, rt, ref.TRAIN_TILE, kt, keys).any(4).any(2)
    return {(bi, h, t, k) for bi, t, k in tiles.nonzero().tolist()
            for h in range(hq)}


@pytest.mark.parametrize("b,sq,hq,hkv,skv,causal,window", SCHEDULES_256)
def test_train_schedule_at_256_covers_every_tile_pair_once(
        b, sq, hq, hkv, skv, causal, window):
    """Every (batch row, q head, row tile) is dealt once; the key tiles of
    64 its rows walk are exactly the visible ones, each once; a block takes
    its items longest first, and no block ends more than one item after
    another."""
    sched = ops.attention_train_schedule(b, sq, hq, hkv, skv, causal, window,
                                         d=256)
    items = [i for block in sched.blocks for i in block]
    rt = -(-sq // ref.TRAIN_TILE)
    assert sorted(items) == list(range(b * hq * rt))
    assert len(sched.blocks) == min(ops.SMS, len(items))
    walked = collections.Counter()
    cost = {}
    for i in items:
        bi, h, t = sched.item(i)
        tiles = ref.train_key_tiles(t, 0, skv, sq, skv, causal, window, 64)
        walked.update((bi, h, t, k) for k in tiles)
        cost[i] = len(tiles) + 1
    assert set(walked.values()) == {1}
    assert set(walked) == _visible_tiles(b, sq, hq, skv, causal, window, 64)
    for block in sched.blocks:
        lengths = [cost[i] for i in block]
        # one L2 group at these shapes (4 kv heads of 2 MB fit 8 MB)
        assert lengths == sorted(lengths, reverse=True)
    loads = [sum(cost[i] for i in block) for block in sched.blocks]
    assert max(loads) - min(loads) <= max(cost.values())


def test_train_schedule_at_256_groups_kv_heads_by_their_own_bytes():
    """The L2 groups count the K/V of head dim 256 (2 MB a kv head at s =
    2048): 16 kv heads run in groups of 4, where counting them at 128
    would put 8 in a group."""
    sched = ops.attention_train_schedule(1, 2048, 16, 16, 2048, d=256)
    spread = 0
    for block in sched.blocks:
        groups = [sched.item(i)[1] // 4 for i in block]
        assert groups == sorted(groups)
        spread = max(spread, len(set(groups)))
    assert spread > 1
    # the first 64 items dealt (one to each of blocks 0-63) are group 0's
    heads = {sched.item(sched.blocks[c][0])[1] for c in range(64)}
    assert heads == set(range(4))


# ---------------------------------------------------------------------------
# the plain mirror against the JAX model's attention
# ---------------------------------------------------------------------------

# (b, sq, skv, q_offset, kv_len, window, softcap)
MIRROR_256 = {
    "gemma softcap 50, causal, window 512 bites": (1, 640, 640, [0], [640],
                                                   512, 50.0),
    "no window, s % 128 != 0": (1, 300, 300, [0], [300], 0, 50.0),
    "offsets, kv_len < skv, no softcap": (2, 200, 420, [120, 10],
                                          [320, 150], 0, 0.0),
}


def _inputs(case, seed):
    b, sq, skv, q_off, kv_len, window, softcap = MIRROR_256[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, GEMMA["hq"], 256)).astype(np.float32)
    k = rng.standard_normal((b, skv, GEMMA["hkv"], 256)).astype(np.float32)
    v = rng.standard_normal((b, skv, GEMMA["hkv"], 256)).astype(np.float32)
    return (q, k, v, np.array(q_off, np.int32), np.array(kv_len, np.int32),
            dict(causal=True, window=window, softcap=softcap))


@pytest.mark.parametrize("case", list(MIRROR_256))
def test_mirror_at_256_matches_attention_core(case):
    """``ref.attention_train_ref`` in the 64-key instance's order against
    ``repro.models.layers.attention_core`` with gemma2-2b's config (head dim
    256, its softcap or none), on the rows that see a key."""
    q, k, v, qo, kl, kw = _inputs(case, seed=5)
    cfg = jax_config("gemma2-2b")
    assert cfg.hd == 256 and cfg.attn_softcap == 50.0
    cfg = dataclasses.replace(cfg, attn_softcap=kw["softcap"])
    want = np.asarray(jax_layers.attention_core(
        cfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qo),
        kv_len=jnp.asarray(kl), window=kw["window"]))
    got, lse = ref.attention_train_ref(
        *(torch.from_numpy(a) for a in (q, k, v, qo, kl)), **kw)
    seen = torch.isfinite(lse).transpose(1, 2).numpy()
    assert seen.any()
    np.testing.assert_allclose(got.numpy()[seen], want[seen], **CORE_TOL)
    # the same order in 128-key tiles gives the same sums to rounding
    plain, plain_lse = ref.attention_lse_ref(
        *(torch.from_numpy(a) for a in (q, k, v, qo, kl)), **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **CORE_TOL)
    np.testing.assert_allclose(lse[torch.isfinite(lse)].numpy(),
                               plain_lse[torch.isfinite(lse)].numpy(),
                               **CORE_TOL)


def test_mirror_at_256_walks_64_key_tiles(monkeypatch):
    """The mirror takes its key tile from ``ref.train_keys``: at head dim
    256 it walks tiles of 64 (the bf16 rounding of P follows the running
    max of each tile, so the tile is part of the kernel's arithmetic)."""
    seen = []
    walk = ref.train_key_tiles

    def spy(*args):
        seen.append(args[-1])
        return walk(*args)

    monkeypatch.setattr(ref, "train_key_tiles", spy)
    q, k, v, qo, kl, kw = _inputs("no window, s % 128 != 0", seed=6)
    ref.attention_train_ref(*(torch.from_numpy(a)
                              for a in (q[:, :, :2], k[:, :, :1], v[:, :, :1],
                                        qo, kl)), **kw)
    assert seen and set(seen) == {64}


# ---------------------------------------------------------------------------
# the backward's plan
# ---------------------------------------------------------------------------

BWD_256 = [  # (b, sq, hq, hkv, skv, window, q_offset, kv_len)
    (1, 2048, 8, 4, 2048, 0, [0], [2048]),       # train-gemma
    (1, 2048, 8, 4, 2048, 512, [0], [2048]),     # its window of 512
    (1, 256, 8, 4, 256, 0, [0], [256]),          # the path check
    (2, 96, 4, 2, 128, 0, [32, 0], [128, 70]),   # offsets, lengths
]


@pytest.mark.parametrize("b,sq,hq,hkv,skv,window,q_offset,kv_len", BWD_256)
def test_attention_bwd_plan_at_256_walks_the_causal_square_once(
        b, sq, hq, hkv, skv, window, q_offset, kv_len):
    """At head dim 256 (one two-warpgroup block an SM) the plan's items,
    as the kernel clips them, cover every visible (key tile, row tile)
    pair once and no other, on at most one block an SM."""
    plan = ops.attention_bwd_plan(b, sq, hq, hkv, skv, True, window, d=256)
    assert 1 <= plan.blocks <= ops.SMS
    assert ops.bwd_blocks_per_sm(256) == 1
    grp = hq // hkv
    seen = collections.Counter()
    for bh, kt, _, tiles in plan.walk(sq, q_offset, kv_len, True, window):
        seen.update((bh, kt, t) for t in tiles)
    assert set(seen.values()) == {1}
    mask = ref.attention_mask(sq, skv, torch.tensor(q_offset),
                              torch.tensor(kv_len), window=window)
    pt, kt_n = -(-sq // 64), -(-skv // ops.BWD_KEYS)
    padded = torch.zeros(b, pt * 64, kt_n * ops.BWD_KEYS, dtype=torch.bool)
    padded[:, :sq, :skv] = mask
    tiles = padded.reshape(b, pt, 64, kt_n, ops.BWD_KEYS).any(4).any(2)
    want = {(bi * hkv + kvh, k, p * grp + g)
            for bi, p, k in tiles.nonzero().tolist()
            for kvh in range(hkv) for g in range(grp)}
    assert set(seen) == want
