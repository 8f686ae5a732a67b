"""The serving attention's decode instance at head dim 256 on the CPU: its
plan and the plain mirror of its order.

``csrc/flash_attention.cu``'s ``flash_decode_kernel`` takes variant 0's
tiles of at most 16 rows (q rows x q heads of a GQA group) at head dim
256: every gemma2-2b decode tick.  Its four warps walk the quarters of
each 64-key tile, each with its own online softmax; the block merges the
quarters at the end of its split and the splits merge across blocks.
``ref.attention_decode_ref`` follows that order and is held here in fp32
within 1e-4 against the JAX package's ``models.layers.attention_core``
with gemma2-2b's config (softcap 50, 8 q / 4 kv heads of 256) at
serve-gemma's decode tick, with a window that bites, a row with kv_len 0
and a row whose splits but one are empty.  ``ops.decode_instance`` names
the shapes that take it; ``ops.attention_plan`` is unchanged at every
serving shape.  ``tests/test_torch_cuda.py`` holds the kernel on the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

#: fp32 against fp32: only the order of the sums differs
CORE_TOL = dict(rtol=1e-4, atol=1e-4)
GEMMA = dict(hq=8, hkv=4, d=256)
SKV = 272   # serve-gemma's s_max
TICK = [138, 65, 251, 10]   # serve-gemma's kv_len at a decode tick

# (b, sq, q_offset, kv_len, window, softcap)
DECODE = {
    "serve-gemma tick, local layer": (4, 1, [x - 1 for x in TICK], TICK,
                                      4096, 50.0),
    "serve-gemma tick, global layer": (4, 1, [x - 1 for x in TICK], TICK,
                                       0, 50.0),
    "window 48 bites": (4, 1, [x - 1 for x in TICK], TICK, 48, 50.0),
    "a row with kv_len 0": (3, 1, [0, 99, 199], [0, 100, 200], 0, 50.0),
    "splits but one empty (kv_len 9)": (2, 1, [8, 270], [9, 271], 0, 0.0),
    "16 rows: sq 2 x a group of 8": (2, 2, [40, 200], [42, 202], 48, 30.0),
}


def _inputs(case, seed):
    b, sq, q_off, kv_len, window, softcap = DECODE[case]
    hq = 16 if sq == 2 else GEMMA["hq"]
    hkv = 2 if sq == 2 else GEMMA["hkv"]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, 256)).astype(np.float32)
    k = rng.standard_normal((b, SKV, hkv, 256)).astype(np.float32)
    v = rng.standard_normal((b, SKV, hkv, 256)).astype(np.float32)
    return (q, k, v, np.array(q_off, np.int32), np.array(kv_len, np.int32),
            dict(causal=True, window=window, softcap=softcap))


@pytest.mark.parametrize("case", list(DECODE))
def test_decode_mirror_matches_attention_core(case):
    """``ref.attention_decode_ref`` over ``split_plan``'s key ranges
    against ``attention_core`` with gemma2-2b's config, on the rows that
    see a key; rows that see none give zeros."""
    q, k, v, qo, kl, kw = _inputs(case, seed=11)
    b, sq, hq, _ = q.shape
    hkv = k.shape[2]
    assert ops.decode_instance(sq, hq, hkv, 256)
    plan = ops.attention_plan(b, sq, hq, hkv, SKV, d=256)
    assert plan.variant == 0 and plan.row_tiles == 1
    cfg = dataclasses.replace(jax_config("gemma2-2b"),
                              attn_softcap=kw["softcap"])
    assert cfg.hd == 256
    want = np.asarray(jax_layers.attention_core(
        cfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qo),
        kv_len=jnp.asarray(kl), window=kw["window"]))
    args = [torch.from_numpy(a) for a in (q, k, v, qo, kl)]
    got = ref.attention_decode_ref(*args, key_ranges=plan.key_ranges(SKV),
                                   **kw).numpy()
    seen = ref.attention_mask(sq, SKV, args[3], args[4],
                              window=kw["window"]).any(-1).numpy()
    assert seen.any()
    np.testing.assert_allclose(got[seen], want[seen], **CORE_TOL)
    assert not got[~seen].any()
    # the split kernel's order gives the same sums to rounding
    split = ref.attention_split_ref(*args, key_ranges=plan.key_ranges(SKV),
                                    **kw).numpy()
    np.testing.assert_allclose(got, split, **CORE_TOL)


def test_decode_mirror_has_the_splits_it_is_named_for():
    """The cases cover what they are named for: serve-gemma's tick has five
    one-tile splits (80 blocks), the window of 48 hides keys a tick's
    rows would otherwise see, and the kv_len 9 row sees keys in one split
    of five."""
    plan = ops.split_plan(4, 1, 8, 4, SKV)
    assert (plan.row_tiles, plan.splits, plan.tiles_per_split) == (1, 5, 1)
    assert plan.splits * 4 * 4 == 80
    _, sq, qo, kl, window, _ = DECODE["window 48 bites"]
    narrow = ref.attention_mask(sq, SKV, torch.tensor(qo), torch.tensor(kl),
                                window=window)
    wide = ref.attention_mask(sq, SKV, torch.tensor(qo), torch.tensor(kl))
    assert narrow.sum() < wide.sum()
    ranges = ops.split_plan(2, 1, 8, 4, SKV).key_ranges(SKV)
    assert sum(k0 < 9 for k0, _ in ranges) == 1 and len(ranges) == 5


def test_decode_mirror_walks_quarters(monkeypatch):
    """The mirror's bf16 rounding of P follows each quarter's running max:
    in bf16 it differs from the split kernel's order, whose one warp takes
    a whole tile; in fp32 (P exact) they agree to rounding."""
    q, k, v, qo, kl, kw = _inputs("serve-gemma tick, global layer", seed=3)
    args = [torch.from_numpy(a) for a in (q, k, v, qo, kl)]
    bf = [a.to(torch.bfloat16) for a in args[:3]] + args[3:]
    ranges = ops.split_plan(4, 1, 8, 4, SKV).key_ranges(SKV)
    quarters = ref.attention_decode_ref(*bf, key_ranges=ranges, **kw)
    monkeypatch.setattr(ref, "DECODE_QUARTER", 64)
    tiles = ref.attention_decode_ref(*bf, key_ranges=ranges, **kw)
    split = ref.attention_split_ref(*bf, key_ranges=ranges, **kw)
    assert not torch.equal(quarters, tiles)
    np.testing.assert_allclose(tiles.float().numpy(), split.float().numpy(),
                               atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

# (b, sq, hq, hkv, skv, d) -> whether the decode instance runs
INSTANCE = {
    "gemma2-2b decode tick": ((4, 1, 8, 4, 272, 256), True),
    "gemma2-2b decode, one slot": ((1, 1, 8, 4, 272, 256), True),
    "gemma2-2b decode, long cache": ((4, 1, 8, 4, 4096, 256), True),
    "16 rows: sq 2, group 8": ((2, 2, 16, 2, 272, 256), True),
    "17 rows: sq 17, group 1": ((1, 17, 4, 4, 272, 256), False),
    "gemma2-2b prefill chunk": ((1, 64, 8, 4, 272, 256), False),
    "gemma2-2b speculative tick (sq 2)": ((4, 2, 8, 4, 272, 256), True),
    "llama3-8b decode tick (d 128)": ((4, 1, 32, 8, 272, 128), False),
    "zamba2-7b decode tick (d 112)": ((4, 1, 32, 32, 272, 112), False),
    "qwen1.5-0.5b decode tick (d 64)": ((4, 1, 16, 16, 272, 64), False),
    "dbrx-132b decode tick (d 128)": ((4, 1, 48, 8, 272, 128), False),
}


@pytest.mark.parametrize("case", list(INSTANCE))
def test_decode_instance_takes_tiles_of_16_rows_at_256(case):
    (b, sq, hq, hkv, skv, d), want = INSTANCE[case]
    assert ops.decode_instance(sq, hq, hkv, d) == want
    plan = ops.attention_plan(b, sq, hq, hkv, skv, d=d)
    # every serving shape keeps split_plan's tiles and splits
    assert plan == ops.split_plan(b, sq, hq, hkv, skv)
    assert plan.variant == 0 and plan.rows == plan.bkv == 64
    if want:
        assert plan.row_tiles == 1
        assert sq * (hq // hkv) <= ref.DECODE_ROWS


def test_decode_plan_at_serve_gemma_is_the_parent_plan():
    """serve-gemma's tick keeps the plan the split kernel had: one row tile
    of (batch row, kv head), five splits of one 64-key tile; its prefill
    chunk two row tiles and one split."""
    assert ops.attention_plan(4, 1, 8, 4, SKV, d=256) == ops.AttentionPlan(
        1, 5, 1)
    assert ops.attention_plan(1, 64, 8, 4, SKV, d=256) == ops.AttentionPlan(
        2, 1, 5)
