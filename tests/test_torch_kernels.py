"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper in ``repro_torch.kernels.ops`` takes its plain
version (``repro_torch.kernels.ref``); those are held here against the
Pallas kernels run in interpret mode (as ``tests/test_kernels.py`` runs
them) and against ``repro.kernels.ref``, on the same numpy-made inputs.
fp32 tolerance 1e-4: only the order of summation differs.

``test_torch_cuda.py`` holds the hand-written kernels themselves against
these plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import mamba2 as jax_mamba2  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n,act,bias", [
    (37, 100, 77, None, False),    # ragged M, N and K
    (37, 100, 77, "gelu", True),
    (5, 136, 200, "silu", True),   # decode-sized M
    (64, 128, 96, None, True),
])
def test_matmul_plain_matches_pallas(m, k, n, act, bias):
    rng = np.random.default_rng(m * 1000 + n)
    a, b = _randn(rng, m, k), _randn(rng, k, n, scale=k ** -0.5)
    bv = _randn(rng, n) if bias else None
    want = jax_ops.matmul(jnp.asarray(a), jnp.asarray(b),
                          None if bv is None else jnp.asarray(bv),
                          activation=act, block_m=32, block_n=64, block_k=64,
                          interpret=True)
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                     None if bv is None else torch.from_numpy(bv),
                     activation=act)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    if not bias:
        np.testing.assert_allclose(
            _np(got), np.asarray(jax_ref.matmul_ref(a, b, activation=act)),
            **TOL)


@pytest.mark.parametrize("m,k,n,act,bias,out", [
    (64, 96, 48, "gelu", True, "f32"),     # the reference's own test case
    (37, 1040, 77, "silu", True, "bf16"),  # K at the f32-exact limit
    (5, 256, 200, None, False, "f32"),     # decode-sized M
    (40, 512, 64, "gelu", False, "bf16"),
])
def test_int8_matmul_plain_matches_pallas(m, k, n, act, bias, out):
    """The int8 ``scale`` mode: int8 operands, the dequant scale before the
    bias and the activation.  At K <= 1040 both sides' sums are exact
    (K * 127^2 < 2^24), so only the activation's f32 rounding differs:
    1e-6 in f32, one bf16 ulp in bf16."""
    from repro.kernels.matmul import matmul as pallas_matmul

    rng = np.random.default_rng(m * 7 + k)
    a = rng.integers(-127, 128, (m, k), dtype=np.int8)
    b = rng.integers(-127, 128, (k, n), dtype=np.int8)
    bv = _randn(rng, n) if bias else None
    scale = np.float32(0.37 / (127 * 127 * k ** 0.5))
    jdt, tdt = ((jnp.float32, torch.float32) if out == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(pallas_matmul(
        jnp.asarray(a), jnp.asarray(b),
        None if bv is None else jnp.asarray(bv), scale=scale, activation=act,
        out_dtype=jdt, block_m=32, block_n=64, block_k=64,
        interpret=True)).astype(np.float32)
    ops.reset_launches()
    got = ops.matmul_int8(torch.from_numpy(a), torch.from_numpy(b),
                          None if bv is None else torch.from_numpy(bv),
                          scale=float(scale), activation=act, out_dtype=tdt)
    assert got.dtype == tdt and ops.QUANT_LAUNCHES == {"matmul_int8": 0}
    if out == "f32":
        np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=2 ** -8, atol=1e-6)


def test_quantize_for_matmul_matches_the_reference_bit_for_bit():
    """q and scale of ``ops.quantize_for_matmul`` equal the reference's
    compiled ``quantize_for_matmul`` (XLA multiplies by the constant's
    reciprocal, as the port does) bit for bit; the quantized product
    through ``matmul_int8`` stays within 2% of the float one's range."""
    from repro.kernels.matmul import quantize_for_matmul as jax_quantize

    rng = np.random.default_rng(3)
    for shape, scale in (((64, 96), 1.0), ((96, 48), 0.2), ((7, 5), 300.0)):
        x = _randn(rng, *shape, scale=scale)
        qj, sj = jax.jit(jax_quantize)(jnp.asarray(x))
        q, s = ops.quantize_for_matmul(torch.from_numpy(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        assert s.numpy().tobytes() == np.asarray(sj).tobytes()
    a, b = _randn(rng, 16, 64), _randn(rng, 64, 32, scale=0.2)
    (qa, sa), (qb, sb) = (ops.quantize_for_matmul(torch.from_numpy(t))
                          for t in (a, b))
    got = ops.matmul_int8(qa, qb, scale=sa * sb, out_dtype=torch.float32)
    exact = torch.from_numpy(a @ b)
    assert float((got - exact).abs().max()) < 0.02 * float(exact.abs().max())


def test_matmul_reads_a_transposed_weight_and_counts_no_cpu_launch():
    """A tied head passes the embedding transposed (a view, no copy); on
    the CPU the plain version runs and no kernel launch is counted."""
    rng = np.random.default_rng(0)
    a, emb = _randn(rng, 6, 32), _randn(rng, 50, 32)
    ops.reset_launches()
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(emb).t())
    np.testing.assert_allclose(_np(got), a @ emb.T, **TOL)
    assert ops.LAUNCHES == {"matmul": 0, "flash_attention": 0, "rmsnorm": 0,
                            "ssd_scan": 0}
    with pytest.raises(ValueError, match="activation"):
        ops.matmul(torch.from_numpy(a), torch.from_numpy(emb).t(),
                   activation="relu")


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,h,dtype", [(37, 128, "float32"),
                                          (4, 512, "float32"),
                                          (37, 128, "bfloat16")])
def test_rmsnorm_plain_matches_pallas(rows, h, dtype):
    rng = np.random.default_rng(rows + h)
    x, g = _randn(rng, rows, h), _randn(rng, h)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jax_ops.rmsnorm(jx, jnp.asarray(g), eps=1e-5,
                                      block_rows=16, interpret=True),
                      np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = _np(ops.rmsnorm(tx, torch.from_numpy(g), eps=1e-5))
    # bf16: both sides compute in fp32 and round once; allow one bf16 ulp
    tol = TOL if dtype == "float32" else dict(rtol=8e-3, atol=1e-6)
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(
        got, np.asarray(jax_ref.rmsnorm_ref(jx, jnp.asarray(g), 1e-5),
                        np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [False, True])
def test_group_rmsnorm_plain_matches_jax(dtype, gated):
    """The Mamba2 grouped norm with a per-head scale, and its SiLU gate,
    against the JAX block's ``_group_rmsnorm(y, gamma) * silu(z)``.  fp32:
    1e-4.  bf16: both round the norm and the product once, but JAX's silu
    rounds sigmoid(z) and then z * sigmoid(z) where torch's rounds silu(z)
    once, so the gated product may differ by up to three units in the last
    place (3 * 2^-7 relative)."""
    b, s, nh, hd = 2, 5, 4, 16
    rng = np.random.default_rng(31)
    y, g = _randn(rng, b, s, nh, hd), _randn(rng, nh, hd)
    z = _randn(rng, b, s, nh * hd)
    jy, jz = (jnp.asarray(a, getattr(jnp, dtype)) for a in (y, z))
    want = jax_mamba2._group_rmsnorm(jy, jnp.asarray(g)).reshape(b, s, -1)
    if gated:
        want = want * jax.nn.silu(jz)
    ty, tz = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (y, z))
    got = ops.group_rmsnorm(ty, torch.from_numpy(g),
                            gate=tz.unflatten(-1, (nh, hd)) if gated else None)
    assert got.dtype == ty.dtype and got.shape == ty.shape
    tol = TOL if dtype == "float32" else dict(rtol=3 * 2 ** -7, atol=1e-6)
    np.testing.assert_allclose(_np(got).reshape(b, s, -1),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def _qkv(rng, b, sq, sk, hq, hkv, d):
    return (_randn(rng, b, sq, hq, d), _randn(rng, b, sk, hkv, d),
            _randn(rng, b, sk, hkv, d))


@pytest.mark.parametrize("sq,sk,hq,hkv,causal,window,softcap", [
    (48, 48, 4, 2, True, 0, 0.0),      # GQA, causal
    (40, 40, 2, 2, True, 16, 0.0),     # sliding window
    (40, 40, 4, 1, True, 0, 30.0),     # tanh softcap, GQA 4:1
    (24, 40, 2, 2, False, 0, 0.0),     # kv longer than q, padded kv tile
])
def test_flash_attention_plain_matches_pallas(sq, sk, hq, hkv, causal, window,
                                              softcap):
    """The Pallas kernel is the special case q_offset = 0, kv_len = sk; its
    kv padding (sk not a multiple of block_k) masks ``kpos < sk``."""
    b, d = 2, 32
    rng = np.random.default_rng(sq * 7 + sk)
    q, k, v = _qkv(rng, b, sq, sk, hq, hkv, d)
    want = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, softcap=softcap, block_q=16,
                                   block_k=32, interpret=True)
    zeros = torch.zeros(b, dtype=torch.int32)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), zeros,
                              torch.full((b,), sk, dtype=torch.int32),
                              causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch,window", [("llama3-8b", 0),
                                         ("gemma2-2b", 0),   # softcap
                                         ("gemma2-2b", 12)])  # + window
def test_flash_attention_offsets_match_attention_core(arch, window):
    """Per-slot ``q_offset [b]`` and ``kv_len [b]`` (a prefill chunk at an
    offset, a decode row, a short slot) against the JAX model's own
    ``attention_core``, which is what the paged path computes."""
    cfg = get_config(arch).reduced()
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    b, sq, sk = 3, 8, 40
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, b, sq, sk, hq, hkv, d)
    q_off = np.array([0, 17, 30], np.int32)
    kv_len = q_off + sq
    kv_len[2] = 33  # a slot whose last rows see keys only up to 32
    want = jax_layers.attention_core(cfg, jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(q_off),
                                     kv_len=jnp.asarray(kv_len),
                                     window=window)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(q_off),
                              torch.from_numpy(kv_len), window=window,
                              softcap=cfg.attn_softcap)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_flash_attention_fully_masked_rows_are_zero():
    """The kernel's rule for a row that sees no key (kv_len 0): zeros, not
    NaN.  Pallas clamps its denominator the same way."""
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 2, 3, 8, 2, 1, 16)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              torch.tensor([0, 2], dtype=torch.int32),
                              torch.tensor([0, 8], dtype=torch.int32))
    assert torch.isfinite(got).all()
    assert float(got[0].abs().max()) == 0.0
    assert float(got[1].abs().max()) > 0.0


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------


def _ssd_inputs(rng, b, s, nh, hd, ds):
    """Model-like inputs: dt = softplus(randn), A_log = 0.5 randn."""
    dt = np.log1p(np.exp(_randn(rng, b, s, nh)))
    return (_randn(rng, b, s, nh, hd), dt, _randn(rng, nh, scale=0.5),
            _randn(rng, b, s, ds), _randn(rng, b, s, ds), _randn(rng, nh),
            _randn(rng, b, nh, hd, ds, scale=0.5))


def _ssd_port(args, chunk, state=None):
    t = [torch.from_numpy(a) for a in args]
    st = None if state is None else torch.from_numpy(state)
    y, st_out = ops.ssd_scan(*t, chunk=chunk, state_in=st)
    return _np(y), _np(st_out)


@pytest.mark.parametrize("b,s,nh,hd,ds,chunk", [(2, 32, 4, 16, 8, 16),
                                                (1, 64, 3, 8, 16, 16)])
def test_ssd_plain_matches_pallas(b, s, nh, hd, ds, chunk):
    """The Pallas kernel is the special case state_in = 0 with the final
    state dropped and s % chunk == 0."""
    rng = np.random.default_rng(s + nh)
    *args, _ = _ssd_inputs(rng, b, s, nh, hd, ds)
    want = jax_ops.ssd_scan(*map(jnp.asarray, args), chunk=chunk,
                            interpret=True)
    y, _ = _ssd_port(args, chunk)
    np.testing.assert_allclose(y, np.asarray(want), **TOL)


@pytest.mark.parametrize("s", [48, 5])   # 5 < chunk: one chunk of 5
def test_ssd_plain_matches_ssd_chunked_with_state(s):
    """y and state_out from a nonzero state_in, against the JAX block's own
    chunked oracle, including its rule for s shorter than the chunk."""
    rng = np.random.default_rng(s)
    *args, state = _ssd_inputs(rng, 2, s, 4, 8, 6)
    want_y, want_st = jax_mamba2.ssd_chunked(
        *map(jnp.asarray, args), 16, state_in=jnp.asarray(state))
    y, st = _ssd_port(args, 16, state)
    np.testing.assert_allclose(y, np.asarray(want_y), **TOL)
    np.testing.assert_allclose(st, np.asarray(want_st), **TOL)


def test_ssd_plain_one_token_matches_ssd_step():
    rng = np.random.default_rng(9)
    *args, state = _ssd_inputs(rng, 3, 1, 4, 8, 6)
    want_y, want_st = jax_mamba2.ssd_step(*map(jnp.asarray, args),
                                          jnp.asarray(state))
    y, st = _ssd_port(args, 16, state)
    np.testing.assert_allclose(y, np.asarray(want_y), **TOL)
    np.testing.assert_allclose(st, np.asarray(want_st), **TOL)


def test_ssd_plain_ragged_chunks_carry_the_state():
    """s = 35 splits into no s // 16 = 2 equal chunks, so it runs as the
    kernel runs it: chunks of 16, 16 and a ragged 3.  That equals the same
    tokens fed in two calls that carry the state across: the chunking
    changes only the rounding."""
    rng = np.random.default_rng(10)
    *args, state = _ssd_inputs(rng, 1, 35, 2, 8, 6)
    assert ref._ssd_chunks(35, 16) == [(0, 16), (16, 16), (32, 3)]
    y, st = _ssd_port(args, 16, state)
    first = [a[:, :20] if a.ndim > 1 else a for a in args]
    second = [a[:, 20:] if a.ndim > 1 else a for a in args]
    y1, st1 = _ssd_port(first, 16, state)
    y2, st2 = _ssd_port(second, 16, st1)
    np.testing.assert_allclose(y, np.concatenate([y1, y2], axis=1), **TOL)
    np.testing.assert_allclose(st, st2, **TOL)


def _pool_case(rng, s, nh=4, hd=8, ds=6, slots=5):
    """4 batch rows on a pool of 5 slots, in a permuted order: live slots 3
    and 0, a sentinel row (id 5), and slot 2 fresh (a recycled slot)."""
    *args, _ = _ssd_inputs(rng, 4, s, nh, hd, ds)
    pool = _randn(rng, slots, nh, hd, ds, scale=0.5)
    slot = np.array([3, slots, 0, 2], np.int32)
    fresh = np.array([False, False, False, True])
    return args, pool, slot, fresh


@pytest.mark.parametrize("s", [1, 5, 48])
def test_ssd_pool_plain_matches_take_scan_put(s):
    """The slot-addressed form against gather -> ``ssd_ref`` -> put by hand
    and against the JAX block's ``ssd_step`` / ``ssd_chunked`` on the same
    gathered rows: a fresh or sentinel row starts from zeros, the sentinel
    writes nothing, and the pool rows no live row addresses stay
    bit-identical."""
    rng = np.random.default_rng(20 + s)
    args, pool, slot, fresh = _pool_case(rng, s)
    t = [torch.from_numpy(a) for a in args]
    got_pool = torch.from_numpy(pool.copy())
    y, out = ops.ssd_scan(*t, chunk=16, pool=got_pool,
                          slot=torch.from_numpy(slot),
                          fresh=torch.from_numpy(fresh))
    assert out is got_pool
    live = [0, 2, 3]
    state = np.zeros((4,) + pool.shape[1:], np.float32)
    state[[0, 2]] = pool[slot[[0, 2]]]
    want_y, want_st = ref.ssd_ref(*t, 16, torch.from_numpy(state))
    want_pool = pool.copy()
    want_pool[slot[live]] = want_st.numpy()[live]
    np.testing.assert_array_equal(got_pool.numpy()[[1, 4]], pool[[1, 4]])
    np.testing.assert_allclose(got_pool.numpy(), want_pool, **TOL)
    np.testing.assert_allclose(_np(y), _np(want_y), **TOL)
    jargs = [jnp.asarray(a) for a in args]
    if s == 1:
        jy, jst = jax_mamba2.ssd_step(*jargs, jnp.asarray(state))
    else:
        jy, jst = jax_mamba2.ssd_chunked(*jargs, 16,
                                         state_in=jnp.asarray(state))
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)
    np.testing.assert_allclose(got_pool.numpy()[slot[live]],
                               np.asarray(jst)[live], **TOL)


def test_ssd_pool_plain_refuses_a_live_slot_twice():
    """Two live rows on one slot would both write its pool row: the plain
    version raises and leaves the pool as it was; sentinel ids may
    repeat.  The two forms of the state do not mix."""
    rng = np.random.default_rng(40)
    args, pool, _, fresh = _pool_case(rng, 3)
    t = [torch.from_numpy(a) for a in args]
    tp = torch.from_numpy(pool.copy())
    with pytest.raises(ValueError, match="appears twice"):
        ops.ssd_scan(*t, chunk=16, pool=tp,
                     slot=torch.tensor([2, 5, 2, 0], dtype=torch.int32),
                     fresh=torch.from_numpy(fresh))
    np.testing.assert_array_equal(tp.numpy(), pool)
    ops.ssd_scan(*t, chunk=16, pool=tp,
                 slot=torch.tensor([5, 5, 1, 0], dtype=torch.int32),
                 fresh=torch.from_numpy(fresh))
    np.testing.assert_array_equal(tp.numpy()[2:], pool[2:])
    with pytest.raises(ValueError, match="no state_in"):
        ops.ssd_scan(*t, chunk=16, pool=tp, state_in=tp[:4],
                     slot=torch.tensor([0, 1, 2, 3], dtype=torch.int32),
                     fresh=torch.from_numpy(fresh))
    with pytest.raises(ValueError, match="pool="):
        ops.ssd_scan(*t, chunk=16,
                     slot=torch.tensor([0, 1, 2, 3], dtype=torch.int32))
