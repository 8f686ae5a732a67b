"""The training regime's attention kernel (``csrc/flash_attention_train.cu``)
on the CPU: its launch plan, its schedule and the plain mirror of its
arithmetic.

``ops.attention_plan`` gives variant 1 (the training kernel) at every
training shape and variant 0 (``flash_attention.cu``, with its row tiles
and key splits unchanged) at every serving shape.
``ops.attention_train_schedule`` deals every (batch row, q head, row tile)
to one block, and ``ref.train_key_tiles`` walks exactly the key tiles its
rows can see.  ``ref.attention_train_ref`` (the kernel's order: 128 x 128
tiles, masks on crossing tiles only, an online softmax in the log2
domain) is held against ``ref.attention_lse_ref`` and against the JAX
package's ``models.layers.attention_core`` and ``kernels.ref.
attention_ref`` on the same numpy-made inputs: in fp32 (no rounding)
within 1e-5 (only the order of summation differs); in bf16 (P rounded)
within ``FA_TOL``, ``chip_smoke.py``'s limit for the kernel (bf16 output
and bf16 against fp32 probabilities).  ``tests/test_torch_cuda.py`` holds
the kernel itself against these on the card.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
FA_TOL = dict(atol=2e-2, rtol=2e-2)
#: the log-sum-exp with P rounded: the rounding does not reach it
LSE_ATOL = 1e-3

# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

TRAIN_SHAPES = [  # (model, b, s, hq, hkv, d)
    ("llama3-8b", 1, 2048, 32, 8, 128),
    ("gpt-m1", 1, 2048, 16, 16, 128),
    ("gpt-m2", 1, 2048, 32, 32, 128),
    ("gpt-m3", 1, 2048, 64, 64, 128),
    ("zamba2-7b", 1, 2048, 32, 32, 112),
    # chip_smoke's training path checks
    ("llama3-8b path check", 1, 256, 32, 8, 128),
    ("gpt-m2 path check", 1, 512, 32, 32, 128),
    ("zamba2-7b path check", 1, 128, 32, 32, 112),
]


@pytest.mark.parametrize("model,b,s,hq,hkv,d", TRAIN_SHAPES,
                         ids=[m for m, *_ in TRAIN_SHAPES])
def test_attention_plan_takes_the_training_kernel_at_training_shapes(
        model, b, s, hq, hkv, d):
    plan = ops.attention_plan(b, s, hq, hkv, s, d=d)
    assert plan.variant == 1, plan
    assert plan.splits == 1 and plan.rows == plan.bkv == ref.TRAIN_TILE
    assert plan.row_tiles * plan.rows >= s
    assert plan.key_ranges(s) == [(0, s)]
    # what variant 0 would take there needs no key split
    assert ops.split_plan(b, s, hq, hkv, s).splits == 1


SERVING_SHAPES = [  # (model, step, b, sq, hq, hkv, skv, d): chip_smoke serving
    (m, step, b, sq, hq, hkv, 272, d)
    for m, hq, hkv, d in (("llama3-8b", 32, 8, 128),
                          ("zamba2-7b", 32, 32, 112),
                          ("qwen1.5-0.5b", 16, 16, 64))
    for step, b, sq in (("prefill", 1, 64), ("decode", 4, 1))
]


@pytest.mark.parametrize("model,step,b,sq,hq,hkv,skv,d", SERVING_SHAPES,
                         ids=[f"{m}-{s}" for m, s, *_ in SERVING_SHAPES])
def test_attention_plan_keeps_the_serving_kernel_at_serving_shapes(
        model, step, b, sq, hq, hkv, skv, d):
    plan = ops.attention_plan(b, sq, hq, hkv, skv, d=d)
    assert plan == ops.split_plan(b, sq, hq, hkv, skv)
    assert plan.variant == 0 and plan.rows == plan.bkv == 64
    # the default head dim is the same plan
    assert ops.attention_plan(b, sq, hq, hkv, skv) == plan


@pytest.mark.parametrize("b,sq,hq,hkv,skv,d", [
    (1, 2048, 16, 16, 2048, 64),    # head dim 64 stays on variant 0
    (1, 127, 32, 8, 2048, 128),     # fewer rows than a training tile
    (1, 128, 1, 1, 8192, 128),      # 2 row tiles over 8192 keys: a split
])
def test_attention_plan_keeps_variant_0_elsewhere(b, sq, hq, hkv, skv, d):
    plan = ops.attention_plan(b, sq, hq, hkv, skv, d=d)
    assert plan.variant == 0 and plan == ops.split_plan(b, sq, hq, hkv, skv)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

SCHEDULES = [  # (b, sq, hq, hkv, skv, causal, window)
    (1, 2048, 32, 8, 2048, True, 0),
    (1, 2048, 64, 64, 2048, True, 0),
    (1, 2048, 32, 32, 2048, True, 0),
    (2, 300, 4, 1, 420, True, 0),
    (2, 260, 8, 2, 260, True, 64),
    (1, 200, 4, 4, 330, False, 0),
]


def _order_key(sched, i, hkv, skv, sq, causal, window):
    bi, h, t = sched.item(i)
    grp = sched.hq // hkv
    per_group = max(1, ops.TRAIN_L2_BYTES // (2 * skv * ref.TRAIN_TILE * 2))
    cost = len(ref.train_key_tiles(t, 0, skv, sq, skv, causal, window))
    return ((bi * hkv + h // grp) // per_group, -cost, bi, t, h)


@pytest.mark.parametrize("b,sq,hq,hkv,skv,causal,window", SCHEDULES)
def test_train_schedule_deals_every_item_once_longest_first(
        b, sq, hq, hkv, skv, causal, window):
    sched = ops.attention_train_schedule(b, sq, hq, hkv, skv, causal, window)
    items = [i for block in sched.blocks for i in block]
    rt = -(-sq // ref.TRAIN_TILE)
    assert sorted(items) == list(range(b * hq * rt))
    assert sorted(map(sched.item, items)) == list(itertools.product(
        range(b), range(hq), range(rt)))
    assert len(sched.blocks) == min(ops.SMS, len(items))
    cost = {i: len(ref.train_key_tiles(sched.item(i)[2], 0, skv, sq, skv,
                                       causal, window)) + 1 for i in items}
    for block in sched.blocks:
        keys = [_order_key(sched, i, hkv, skv, sq, causal, window)
                for i in block]
        assert keys == sorted(keys)
    # dealt to the least-loaded block: no block ends more than one item
    # after another
    loads = [sum(cost[i] for i in block) for block in sched.blocks]
    assert max(loads) - min(loads) <= max(cost.values())
    # the kernel's sched: offsets, then the items in block order
    flat = sched.flat()
    n = len(sched.blocks)
    assert flat[n + 1:] == items and flat[0] == 0 and flat[n] == len(items)
    for c, block in enumerate(sched.blocks):
        assert flat[n + 1 + flat[c]:n + 1 + flat[c + 1]] == list(block)


def test_train_schedule_groups_kv_heads_by_the_l2():
    """At gpt-m3's 64 MHA heads (1 MB of K/V a head at s = 2048) the items
    run in groups of 8 heads; llama3-8b's 8 kv heads are one group, its
    q heads of a kv group next to each other within a row tile."""
    sched = ops.attention_train_schedule(1, 2048, 64, 64, 2048)
    block = [sched.item(i) for i in sched.blocks[0]]
    groups = [h // 8 for _, h, _ in block]
    assert groups == sorted(groups) and len(set(groups)) > 1
    sched = ops.attention_train_schedule(1, 2048, 32, 8, 2048)
    order = sorted((_order_key(sched, i, 8, 2048, 2048, True, 0), i)
                   for block in sched.blocks for i in block)
    first = [sched.item(i) for _, i in order[:32]]
    assert first == [(0, h, 15) for h in range(32)]


@pytest.mark.parametrize("sq,skv,q_off,kv_len,causal,window", [
    (300, 420, [0, 120, 299, 5], [300, 420, 250, 0], True, 0),
    (260, 260, [0, 40, 0, 100], [260, 260, 30, 200], True, 64),
    (200, 330, [0, 130, 7, 0], [330, 200, 100, 1], False, 0),
    (256, 256, [0, 0, 128, 9], [256, 129, 256, 256], True, 1),
])
def test_train_key_tiles_are_those_the_rows_can_see(sq, skv, q_off, kv_len,
                                                    causal, window):
    """The key tiles a row tile walks (``ref.train_key_tiles``, as the
    kernel computes them) are exactly those holding a key that one of its
    rows sees: none is loaded for nothing, none is missed."""
    tile = ref.TRAIN_TILE
    mask = ref.attention_mask(sq, skv, torch.tensor(q_off),
                              torch.tensor(kv_len), causal=causal,
                              window=window).expand(-1, sq, -1)
    for bi, (qo, kl) in enumerate(zip(q_off, kv_len)):
        for t in range(-(-sq // tile)):
            rows = mask[bi, t * tile:(t + 1) * tile]
            seen = {kt for kt in range(-(-skv // tile))
                    if rows[:, kt * tile:(kt + 1) * tile].any()}
            walked = ref.train_key_tiles(t, qo, kl, sq, skv, causal, window)
            assert set(walked) == seen and len(walked) == len(seen), (bi, t)


# ---------------------------------------------------------------------------
# the plain mirror
# ---------------------------------------------------------------------------

# (b, sq, skv, hq, hkv, d, q_offset, kv_len, causal, window, softcap)
MIRROR = {
    "causal GQA d=128": (1, 256, 256, 4, 2, 128, [0], [256], True, 0, 0.0),
    "causal MHA d=112, s % 128 != 0": (2, 300, 300, 2, 2, 112, [0, 0],
                                       [300, 300], True, 0, 0.0),
    "q_offset > 0, kv_len < skv": (2, 200, 420, 4, 1, 128, [120, 10],
                                   [320, 150], True, 0, 0.0),
    "window": (1, 260, 260, 2, 2, 128, [0], [260], True, 64, 0.0),
    "softcap": (1, 200, 200, 4, 2, 112, [0], [200], True, 0, 30.0),
    "window + softcap, a row that sees no key": (
        2, 150, 150, 2, 1, 128, [0, 0], [0, 150], True, 32, 30.0),
    "not causal, ragged kv": (2, 130, 330, 2, 2, 128, [0, 0], [330, 129],
                              False, 0, 0.0),
}


def _inputs(case, seed=0):
    b, sq, skv, hq, hkv, d, q_off, kv_len, causal, window, softcap = \
        MIRROR[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    return (q, k, v, np.array(q_off, np.int32), np.array(kv_len, np.int32),
            dict(causal=causal, window=window, softcap=softcap))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", list(MIRROR))
def test_mirror_matches_the_plain_attention_in_fp32(case):
    q, k, v, qo, kl, kw = _inputs(case)
    got, lse = ref.attention_train_ref(*_torch(q, k, v, qo, kl), **kw)
    want, want_lse = ref.attention_lse_ref(*_torch(q, k, v, qo, kl), **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    seen = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), seen)
    np.testing.assert_allclose(lse[seen].numpy(), want_lse[seen].numpy(),
                               **TOL)


@pytest.mark.parametrize("case", list(MIRROR))
def test_mirror_with_bf16_probabilities_is_within_the_kernel_limit(case):
    q, k, v, qo, kl, kw = _inputs(case, seed=1)
    qb, kb, vb = (t.bfloat16() for t in _torch(q, k, v))
    qo_t, kl_t = _torch(qo, kl)
    got, lse = ref.attention_train_ref(qb, kb, vb, qo_t, kl_t, **kw)
    want, want_lse = ref.attention_lse_ref(qb, kb, vb, qo_t, kl_t, **kw)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    assert bool((err <= FA_TOL["atol"] + FA_TOL["rtol"]
                 * want.float().abs()).all()), float(err.max())
    seen = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), seen)
    assert float((lse - want_lse)[seen].abs().max()) <= LSE_ATOL
    dead = ~seen.transpose(1, 2)
    assert float(got[dead].float().abs().sum()) == 0.0


@pytest.mark.parametrize("case", [c for c in MIRROR if MIRROR[c][8]])
def test_mirror_matches_attention_core(case):
    """The JAX model's attention (``attention_core``, per-slot offsets and
    lengths) on the rows that see a key: a row that sees none is zeros in
    the port and a uniform average under JAX's -1e30 mask."""
    q, k, v, qo, kl, kw = _inputs(case, seed=2)
    d = q.shape[-1]
    cfg = jax_config("llama3-8b" if d == 128 else "zamba2-7b")
    cfg = dataclasses.replace(cfg, attn_softcap=kw["softcap"])
    assert cfg.hd == d
    want = np.asarray(jax_layers.attention_core(
        cfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qo),
        kv_len=jnp.asarray(kl), window=kw["window"]))
    got, lse = ref.attention_train_ref(*_torch(q, k, v, qo, kl), **kw)
    seen = torch.isfinite(lse).transpose(1, 2).numpy()
    np.testing.assert_allclose(got.numpy()[seen], want[seen], **TOL)


@pytest.mark.parametrize("causal,window,softcap", [(True, 0, 0.0),
                                                   (True, 48, 0.0),
                                                   (True, 0, 30.0),
                                                   (False, 0, 0.0)])
def test_mirror_matches_the_pallas_reference(causal, window, softcap):
    """``repro.kernels.ref.attention_ref`` (the Pallas kernel's reference:
    ``[b * h, s, d]``, q_offset 0 and kv_len s) at a ragged s and MHA."""
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 200, 2, 112
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))

    def heads_first(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))

    want = np.asarray(jax_ref.attention_ref(
        heads_first(q), heads_first(k), heads_first(v), causal=causal,
        window=window, softcap=softcap)).reshape(b, h, s, d).transpose(
            0, 2, 1, 3)
    got, _ = ref.attention_train_ref(
        *_torch(q, k, v, np.zeros(b, np.int32), np.full(b, s, np.int32)),
        causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
