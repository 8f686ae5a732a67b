"""Each hand-written kernel against its plain version, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX (the machine with the card has none), so run it there
without the suite's JAX conftest:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are bf16's: the output is rounded to bf16 (relative spacing
2^-8), so |kernel - plain| <= atol + rtol * |plain| allows about two units
in the last place at |x| ~ 1.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

BF16_TOL = dict(atol=1e-2, rtol=1.6e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only "
                    "on the card")
    return torch.device("cuda")


def _close(got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    assert bool((err <= atol + rtol * want.float().abs()).all()), \
        float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,act,bias,trans", [
    (64, 4096, 6144, None, False, False),   # a prefill chunk's fused q/k/v
    (4, 4096, 4104, "silu", True, False),   # decode rows, ragged N tile
    (37, 100, 77, "gelu", True, False),     # ragged M, N, K: element loads
    (70, 1024, 1000, None, False, True),    # a tied head, B read transposed
    (64, 3584, 3584, "silu", True, False),  # shared tiles, bias + silu once
    (4, 3584, 3584, "gelu", True, False),   # shared 16-row tiles
    (4, 3584, 240, "gelu", True, False),    # N = 240: 33 blocks a tile
    (64, 3584, 240, "silu", True, False),   # N = 240 on 16-row tiles
    (4, 3592, 4096, None, True, False),     # K not a multiple of the runs
    (4, 1024, 4104, None, False, True),     # a tied head at M = 4, shared
    (64, 3584, 4000, "silu", True, True),   # a tied head at M = 64, shared
])
def test_matmul_kernel_matches_plain(cuda, m, k, n, act, bias, trans):
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(m, k, generator=gen, device=cuda).bfloat16()
    w = torch.randn(n, k, generator=gen, device=cuda) if trans else \
        torch.randn(k, n, generator=gen, device=cuda)
    w = (w * k ** -0.5).bfloat16()
    w = w.t() if trans else w
    bv = torch.randn(n, generator=gen, device=cuda).bfloat16() if bias else None
    before = ops.LAUNCHES["matmul"]
    got = ops.matmul(a, w, bv, activation=act)
    assert ops.LAUNCHES["matmul"] == before + 1
    _close(got, ref.matmul_ref(a, w, bv, act), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,act,bias,out", [
    (64, 4096, 6144, None, False, torch.bfloat16),   # q|k|v, a chunk
    (2048, 4096, 512, "gelu", True, torch.bfloat16),  # 128-row tiles
    (37, 160, 84, "silu", True, torch.float32),      # ragged M, N and K
    (5, 14336, 4096, None, True, torch.float32),     # decode rows, down
])
def test_int8_matmul_kernel_matches_plain(cuda, m, k, n, act, bias, out):
    """The int8 ``scale`` mode: the int32 sum and the f32 scale bit for bit
    (no activation: equal outputs), the activation within the bf16
    tolerance (tanhf against torch's gelu and silu in f32); one launch
    counted in ``QUANT_LAUNCHES``, none in ``LAUNCHES``."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randint(-127, 128, (m, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, device=cuda,
                      dtype=torch.int8)
    bv = torch.randn(n, generator=gen, device=cuda).bfloat16() if bias \
        else None
    scale = 1.0 / (127 * 127 * k ** 0.5)
    ops.reset_launches()
    got = ops.matmul_int8(a, b, bv, scale=scale, activation=act,
                          out_dtype=out)
    assert ops.QUANT_LAUNCHES == {"matmul_int8": 1}
    assert sum(ops.LAUNCHES.values()) == 0 and got.dtype == out
    want = ref.matmul_int8_ref(a, b, bv, scale=scale, activation=act,
                               out_dtype=out)
    if act is None:
        assert torch.equal(got, want)
    else:
        _close(got, want, **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(64, 14336, 3584), (4, 3584, 240)])
def test_matmul_kernel_is_deterministic(cuda, m, k, n):
    """The partials of a shared tile are summed in block order by
    whichever block arrives last: two identical calls give the same bits."""
    assert ops.matmul_plan(m, n, k).max_share > 1
    gen = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(m, k, generator=gen, device=cuda).bfloat16()
    w = (torch.randn(k, n, generator=gen, device=cuda) * k ** -0.5).bfloat16()
    bv = torch.randn(n, generator=gen, device=cuda).bfloat16()
    first = ops.matmul(a, w, bv, activation="silu")
    for _ in range(3):
        assert torch.equal(ops.matmul(a, w, bv, activation="silu"), first)


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    """A CUDA tensor goes to the kernel or the wrapper raises: fp32
    operands are not quietly sent to the plain version."""
    a = torch.randn(4, 64, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        ops.matmul(a, torch.randn(64, 32, device=cuda))
    q = torch.randn(1, 4, 2, 32, device=cuda).bfloat16()
    lens = torch.tensor([4], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q, lens * 0, lens)
    x, dt, A_log, B, C, D, state = _ssd_inputs(cuda, 1, 8, 2)
    with pytest.raises(TypeError, match="fp32 dt"):
        ops.ssd_scan(x, dt.bfloat16(), A_log, B, C, D, chunk=64)
    with pytest.raises(ValueError, match="state_in"):
        ops.ssd_scan(x, dt, A_log, B, C, D, chunk=64, state_in=state[:, :1])
    with pytest.raises(ValueError, match="head dim 64"):
        ops.ssd_scan(x[..., :32], dt, A_log, B, C, D, chunk=64)
    pool = torch.zeros(3, 2, 64, 64, device=cuda)
    slot = torch.zeros(1, dtype=torch.int32, device=cuda)
    fresh = torch.zeros(1, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="pool must be"):
        ops.ssd_scan(x, dt, A_log, B, C, D, chunk=64, pool=pool[:, :1],
                     slot=slot, fresh=fresh)
    with pytest.raises(TypeError, match="int32"):
        ops.ssd_scan(x, dt, A_log, B, C, D, chunk=64, pool=pool,
                     slot=slot.long(), fresh=fresh)
    with pytest.raises(TypeError, match="bool"):
        ops.ssd_scan(x, dt, A_log, B, C, D, chunk=64, pool=pool, slot=slot,
                     fresh=fresh.int())
    xn, g, z = _norm_inputs(cuda, 1, 64, 4, True)
    with pytest.raises(TypeError, match="bf16"):
        ops.rmsnorm(xn[:, 0].float(), g[0])
    with pytest.raises(TypeError, match="fp32 gamma"):
        ops.rmsnorm(xn[:, 0], g[0].bfloat16())
    with pytest.raises(ValueError, match="8192"):
        ops.rmsnorm(torch.zeros(2, 8200, device=cuda).bfloat16(),
                    torch.ones(8200, device=cuda))
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.rmsnorm(torch.zeros(2, 36, device=cuda).bfloat16(),
                    torch.ones(36, device=cuda))
    with pytest.raises(ValueError, match="gamma must be"):
        ops.group_rmsnorm(xn, g[:, :32], gate=z)


@pytest.mark.cuda
@pytest.mark.parametrize("d,hq,hkv,window,softcap", [(128, 32, 8, 0, 0.0),
                                                     (64, 16, 16, 48, 30.0),
                                                     (112, 32, 32, 0, 0.0)])
def test_flash_attention_kernel_matches_plain(cuda, d, hq, hkv, window,
                                              softcap):
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, sq, sk = 3, 20, 150
    q = torch.randn(b, sq, hq, d, generator=gen, device=cuda).bfloat16()
    k = torch.randn(b, sk, hkv, d, generator=gen, device=cuda).bfloat16()
    v = torch.randn(b, sk, hkv, d, generator=gen, device=cuda).bfloat16()
    qo = torch.tensor([0, 60, 130], dtype=torch.int32, device=cuda)
    kl = torch.tensor([20, 80, 140], dtype=torch.int32, device=cuda)
    kw = dict(window=window, softcap=softcap)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, qo, kl, **kw)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    # both round the probabilities to bf16 before the PV product, the
    # kernel before normalising them and the plain version after
    _close(got, ref.attention_ref(q, k, v, qo, kl, **kw), **FA_TOL)


FA_TOL = dict(atol=2e-2, rtol=2e-2)


def _attention_inputs(dev, b, sq, skv, hq, hkv, d, q_off, kv_len, seed=4):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, sq, hq, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, skv, hkv, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, skv, hkv, d, generator=gen, device=dev).bfloat16()
    return (q, k, v, torch.tensor(q_off, dtype=torch.int32, device=dev),
            torch.tensor(kv_len, dtype=torch.int32, device=dev))


SPLIT_KV = {  # (b, sq, skv, hq, hkv, d, q_offset, kv_len, window, softcap)
    # one row over 2048 keys: 32 splits, the last 16 of which see no key
    "many splits, empty splits": (1, 1, 2048, 4, 1, 128, [999], [1000], 0, 0.0),
    # a decode tick of llama3-8b: GQA 4:1, 4 q heads of a kv head in a tile
    "gqa 4:1 decode d=128": (4, 1, 272, 32, 8, 128, [137, 64, 250, 9],
                             [138, 65, 251, 10], 0, 0.0),
    # a llama3-8b prefill chunk deep in a long prompt: 64 rows x 4 heads in
    # 4 row tiles, splits of 4 key tiles
    "gqa 4:1 prefill d=128": (1, 64, 1024, 32, 8, 128, [900], [964], 0, 0.0),
    # head dim 112 (7 k steps, 14 output n8 blocks), as zamba2-7b's
    "d=112 decode": (2, 1, 1024, 8, 8, 112, [700, 40], [701, 41], 0, 0.0),
    "d=112 prefill": (1, 64, 1024, 4, 4, 112, [900], [964], 0, 0.0),
    # qwen1.5: head dim 64, hq = hkv, a fully masked row (kv_len 0)
    "d=64 hq=hkv, fully masked row": (2, 3, 512, 2, 2, 64, [0, 5], [0, 8],
                                      0, 0.0),
    # window + softcap: the window hides the early splits
    "window + softcap": (2, 1, 1024, 8, 2, 128, [700, 40], [701, 41], 48,
                         30.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SPLIT_KV))
def test_flash_attention_split_kv_kernel_matches_plain(cuda, case):
    b, sq, skv, hq, hkv, d, q_off, kv_len, window, softcap = SPLIT_KV[case]
    plan = ops.attention_plan(b, sq, hq, hkv, skv)
    assert plan.splits > 1, plan
    q, k, v, qo, kl = _attention_inputs(cuda, b, sq, skv, hq, hkv, d, q_off,
                                        kv_len)
    kw = dict(window=window, softcap=softcap)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, qo, kl, **kw)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    _close(got, ref.attention_ref(q, k, v, qo, kl, **kw), **FA_TOL)
    dead = ~ref.attention_mask(sq, skv, qo, kl, window=window).any(-1)
    assert float(got[dead].float().abs().sum()) == 0.0


@pytest.mark.cuda
def test_flash_attention_kernel_is_deterministic(cuda):
    """Split-KV partials are merged in split order by whichever block
    arrives last: two identical calls give the same bits."""
    b, sq, skv, hq, hkv, d, q_off, kv_len, *_ = SPLIT_KV["gqa 4:1 decode d=128"]
    q, k, v, qo, kl = _attention_inputs(cuda, b, sq, skv, hq, hkv, d, q_off,
                                        kv_len)
    first = ops.flash_attention(q, k, v, qo, kl)
    for _ in range(3):
        assert torch.equal(ops.flash_attention(q, k, v, qo, kl), first)


def _norm_inputs(dev, groups, width, n, gated, seed=2):
    """groups = 1: n rows of ``width``; groups = 112 (zamba2-7b's SSD heads):
    min(n, 64) tokens of 112 rows (7168 rows at most, a prefill chunk's).
    The gate is the first half of a [tokens, 2 * groups * width] tensor,
    as the z|x GEMM output's z is."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = n if groups == 1 else min(n, 64)
    x = torch.randn(tokens, groups, width, generator=gen,
                    device=dev).bfloat16()
    g = torch.randn(groups, width, generator=gen, device=dev)
    zx = torch.randn(tokens, 2 * groups * width, generator=gen,
                     device=dev).bfloat16()
    z = zx[:, :groups * width].unflatten(-1, (groups, width)) if gated else None
    return x, g, z


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("n", [1, 4, 37, 7168])
@pytest.mark.parametrize("width", [64, 1024, 3584, 4096])
@pytest.mark.parametrize("groups", [1, 112])
def test_rmsnorm_kernel_matches_plain(cuda, groups, width, n, gated):
    """The block norm (one scale row, through ``ops.rmsnorm`` where there
    is no gate) and the grouped norm (a scale row per group, gated as the
    Mamba2 block gates it) against their plain versions; bf16 output."""
    x, g, z = _norm_inputs(cuda, groups, width, n, gated)
    before = ops.LAUNCHES["rmsnorm"]
    if groups == 1 and not gated:
        got = ops.rmsnorm(x[:, 0], g[0], eps=1e-5)
        want = ref.rmsnorm_ref(x[:, 0], g[0], 1e-5)
    else:
        got = ops.group_rmsnorm(x, g, 1e-5, gate=z)
        want = ref.group_rmsnorm_ref(x, g, 1e-5, z)
    assert ops.LAUNCHES["rmsnorm"] == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _close(got, want, **BF16_TOL)


@pytest.mark.cuda
def test_rmsnorm_kernel_is_deterministic(cuda):
    x, g, z = _norm_inputs(cuda, 112, 64, 64, True)
    first = ops.group_rmsnorm(x, g, gate=z)
    for _ in range(3):
        assert torch.equal(ops.group_rmsnorm(x, g, gate=z), first)


def _ssd_inputs(dev, b, s, nh, hd=64, ds=64, seed=3):
    """Model-like SSD inputs: dt = softplus(randn), A_log = 0.5 randn, B and
    C as the split halves of one [b, s, 2 ds] tensor (strided, as in the
    Mamba2 block)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    x = randn(b, s, nh, hd).bfloat16()
    dt = torch.nn.functional.softplus(randn(b, s, nh))
    bc = randn(b, s, 2 * ds).bfloat16()
    return (x, dt, randn(nh) * 0.5, bc[..., :ds], bc[..., ds:], randn(nh),
            randn(b, nh, hd, ds) * 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,nh,with_state", [
    (1, 64, 112, True),     # a prefill chunk, carrying a slot's state
    (4, 1, 112, True),      # a decode tick: ssd_step
    (1, 1024, 16, False),   # 16 chunks carried inside one block
    (2, 100, 16, True),     # a ragged last chunk
])
def test_ssd_scan_kernel_matches_plain(cuda, b, s, nh, with_state):
    """y is bf16 (tolerance as above); the fp32 state allows 1e-3 + 1e-3
    relative: the kernel sums in another order, and its expf may differ
    from torch's exp by an ulp."""
    x, dt, A_log, B, C, D, state = _ssd_inputs(cuda, b, s, nh)
    state = state if with_state else None
    before = ops.LAUNCHES["ssd_scan"]
    y, st = ops.ssd_scan(x, dt, A_log, B, C, D, chunk=64, state_in=state)
    assert ops.LAUNCHES["ssd_scan"] == before + 1
    y_ref, st_ref = ref.ssd_ref(x, dt, A_log, B, C, D, 64, state)
    _close(y, y_ref, **BF16_TOL)
    _close(st, st_ref, atol=1e-3, rtol=1e-3)


SSD_PLANS = [(s, splits) for s in (1, 37, 64, 100, 1024)
             for splits in ((4,) if s == 1 else ops.SSD_SPLITS)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,splits", SSD_PLANS)
def test_ssd_scan_kernel_matches_plain_at_every_plan(cuda, monkeypatch, s,
                                                     splits):
    """Both kernels (s = 1: one-token; else chunked, at each split of the
    head dim, forced through the plan) against the plain version, at
    zamba2-7b's 112 heads; tolerances as in the test above."""
    if s > 1:
        monkeypatch.setattr(ops, "ssd_plan", lambda b, s, nh, hd=64:
                            ops.SsdPlan(b, nh, splits, False, hd))
    b = 4 if s == 1 else 2
    x, dt, A_log, B, C, D, state = _ssd_inputs(cuda, b, s, 112)
    y, st = ops.ssd_scan(x, dt, A_log, B, C, D, chunk=64, state_in=state)
    y_ref, st_ref = ref.ssd_ref(x, dt, A_log, B, C, D, 64, state)
    _close(y, y_ref, **BF16_TOL)
    _close(st, st_ref, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 64, 100])
def test_ssd_scan_pool_form_matches_plain_on_the_whole_pool(cuda, s):
    """The slot-addressed form in place: rows in a permuted slot order, a
    sentinel row (id = the slot count) that reads zeros and writes
    nothing, a fresh row; every pool row compared after the call, and the
    rows no live row addresses bit-identical to before."""
    x, dt, A_log, B, C, D, _ = _ssd_inputs(cuda, 4, s, 16)
    gen = torch.Generator(device=cuda).manual_seed(6)
    pool = torch.randn(6, 16, 64, 64, generator=gen, device=cuda) * 0.5
    slot = torch.tensor([3, 6, 0, 2], dtype=torch.int32, device=cuda)
    fresh = torch.tensor([False, False, False, True], device=cuda)
    want = pool.clone()
    y_ref, _ = ref.ssd_pool_ref(x, dt, A_log, B, C, D, 64, want, slot, fresh)
    got = pool.clone()
    before = ops.LAUNCHES["ssd_scan"]
    y, out = ops.ssd_scan(x, dt, A_log, B, C, D, chunk=64, pool=got,
                          slot=slot, fresh=fresh)
    assert ops.LAUNCHES["ssd_scan"] == before + 1
    assert out is got
    assert torch.equal(got[[1, 4, 5]], pool[[1, 4, 5]])
    _close(got, want, atol=1e-3, rtol=1e-3)
    _close(y, y_ref, **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 64, 1024])
def test_ssd_scan_kernel_is_deterministic(cuda, s):
    x, dt, A_log, B, C, D, state = _ssd_inputs(cuda, 1, s, 112)
    y0, st0 = ops.ssd_scan(x, dt, A_log, B, C, D, chunk=64, state_in=state)
    for _ in range(3):
        y, st = ops.ssd_scan(x, dt, A_log, B, C, D, chunk=64, state_in=state)
        assert torch.equal(y, y0) and torch.equal(st, st0)


# ---------------------------------------------------------------------------
# The backward kernels (training) against their plain backward versions.
# Each output is held to a per-tensor relative L2 error: the kernels' bf16
# outputs round at 2^-8, and their fp32 sums run in another order.
# ---------------------------------------------------------------------------

#: per-tensor relative L2 error of a bf16 gradient (dx, dq/dk/dv, dA, dB)
BWD_REL = 2e-2
#: the same for rmsnorm's fp32 dgamma (a sum over rows in fp32)
DGAMMA_REL = 1e-3
#: rmsnorm's bf16 dx, relative L2: kernel and plain version round the same
#: fp32 arithmetic to bf16 (1e-5 to 5e-5 measured).  dx's mean term
#: ``xhat mean(xhat gamma dy)`` is about 1/sqrt(h) of dx on random inputs
#: (1.2e-2 at 7168 wide, under ``BWD_REL``); a dx without it fails this
RMSNORM_DX_REL = 1e-3


def _rel(got, want):
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def _dx_without_mean_term(x, gamma, dy, eps):
    """rmsnorm's dx with its mean term left out, ``rstd gamma dy`` in bf16:
    a planted fault for the dx checks."""
    r = torch.rsqrt(x.float().pow(2).mean(-1, keepdim=True) + eps)
    return (r * gamma.float() * dy.float()).to(x.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,tied", [
    (256, 512, 640, False),
    (300, 1024, 384, False),    # ragged rows
    (128, 1024, 1000, True),    # a tied head: B is the embedding, transposed
    (2048, 4096, 6144, False),  # llama3-8b's fused q/k/v at s = 2048
])
def test_matmul_backward_kernels_match_plain(cuda, m, k, n, tied):
    gen = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn(m, k, generator=gen, device=cuda).bfloat16()
    w = torch.randn(n, k, generator=gen, device=cuda) if tied else \
        torch.randn(k, n, generator=gen, device=cuda)
    w = (w * k ** -0.5).bfloat16()
    w = w.t() if tied else w
    dz = torch.randn(m, n, generator=gen, device=cuda).bfloat16()
    before = ops.BACKWARD_LAUNCHES["matmul_bwd"]
    da, db = ops.matmul_backward(a, w, dz)
    torch.cuda.synchronize()
    assert ops.BACKWARD_LAUNCHES["matmul_bwd"] == before + 2
    want_a, want_b = ref.matmul_bwd_ref(a, w, dz)
    assert da.shape == a.shape and db.shape == w.shape
    assert _rel(da, want_a) <= BWD_REL
    assert _rel(db, want_b) <= BWD_REL


def _force_training_variant(monkeypatch):
    """Every matmul plan on variant 2 (128x256, warp-specialized,
    persistent), whatever the plan would pick at the shape."""
    plan = functools.lru_cache(maxsize=None)(
        lambda M, N, K, sms=ops.SMS, *, a_trans=False:
        ops._persistent_plan(M, N, K, sms))
    monkeypatch.setattr(ops, "matmul_plan", plan)


def _matmul_operands(dev, m, k, n, tied, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(m, k, generator=gen, device=dev).bfloat16()
    w = torch.randn(n, k, generator=gen, device=dev) if tied else \
        torch.randn(k, n, generator=gen, device=dev)
    w = (w * k ** -0.5).bfloat16()
    dz = (torch.randn(m, n, generator=gen, device=dev) * n ** -0.5).bfloat16()
    return a, (w.t() if tied else w), dz


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,tied,act", [
    (2100, 520, 1000, False, None),   # ragged M, N and K
    (2100, 520, 1000, False, "gelu"),  # the epilogue's activation
    (2048, 1024, 4000, True, None),   # a tied head: B K-major
    (2048, 3584, 14336, False, None),  # zamba2-7b's z|x
    (2048, 3584, 240, False, "silu"),  # zamba2-7b's B|C|dt
    (1000, 2100, 1000, False, None),  # 32 tiles: every one split
    (2048, 1024, 2304, False, None),  # 144 tiles: 132 whole, 12 split
    (301, 517, 999, False, None),     # rows TMA cannot read: variant 1
])
def test_matmul_training_variant_matches_plain(cuda, monkeypatch, m, k, n,
                                               tied, act):
    """Forward (with bias and the activation where given) and backward on
    variant 2 at every layout it takes: A K-major or (wgrad) MN-major, B
    MN-major or (dgrad, a tied head) K-major; operands whose rows TMA
    cannot read go to variant 1's element loads instead."""
    _force_training_variant(monkeypatch)
    a, w, dz = _matmul_operands(cuda, m, k, n, tied, seed=7)
    bv = torch.randn(n, device=cuda).bfloat16() if act else None
    before = dict(ops.LAUNCHES), dict(ops.BACKWARD_LAUNCHES)
    got = ops.matmul(a, w, bv, activation=act)
    da, db = ops.matmul_backward(a, w, dz)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["matmul"] == before[0]["matmul"] + 1
    assert ops.BACKWARD_LAUNCHES["matmul_bwd"] == \
        before[1]["matmul_bwd"] + 2
    _close(got, ref.matmul_ref(a, w, bv, act), **BF16_TOL)
    want_a, want_b = ref.matmul_bwd_ref(a, w, dz)
    assert da.shape == a.shape and db.shape == w.shape
    assert _rel(da, want_a) <= BWD_REL
    assert _rel(db, want_b) <= BWD_REL


@pytest.mark.cuda
@pytest.mark.parametrize("label,k,n", [("mamba z|x", 3584, 14336),
                                       ("mamba B|C|dt", 3584, 240),
                                       ("lm_head, tied", 3584, 32000)])
def test_matmul_at_zamba_training_shapes_on_its_plans(cuda, label, k, n):
    """zamba2-7b's projections at M = 2048 through the plans the step
    takes: forward and backward against the plain versions."""
    a, w, dz = _matmul_operands(cuda, 2048, k, n, "tied" in label, seed=8)
    _close(ops.matmul(a, w), ref.matmul_ref(a, w), **BF16_TOL)
    da, db = ops.matmul_backward(a, w, dz)
    want_a, want_b = ref.matmul_bwd_ref(a, w, dz)
    assert _rel(da, want_a) <= BWD_REL
    assert _rel(db, want_b) <= BWD_REL


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1000, 2100, 1000), (2048, 1024, 2304),
                                   (2048, 4096, 4096)])
def test_matmul_training_variant_is_deterministic(cuda, monkeypatch, m, k,
                                                  n):
    """Split tiles' partials are summed in block order: two identical
    calls give the same bits, forward and backward."""
    _force_training_variant(monkeypatch)
    a, w, dz = _matmul_operands(cuda, m, k, n, False, seed=9)
    first = ops.matmul(a, w), *ops.matmul_backward(a, w, dz)
    again = ops.matmul(a, w), *ops.matmul_backward(a, w, dz)
    for x, y in zip(first, again):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_matmul_backward_makes_no_copy_of_a_transposed(cuda):
    """wgrad reads ``a^T`` from the row-major activation: beyond its two
    outputs, the backward at llama3-8b's wo (M = 2048, no split tile, so
    no workspace) allocates less than ``a^T`` would take."""
    m, k, n = 2048, 4096, 4096
    assert ops.matmul_plan(m, k, n).max_share == 1
    assert ops.matmul_plan(k, n, m, a_trans=True).max_share == 1
    a, w, dz = _matmul_operands(cuda, m, k, n, False, seed=10)
    ops.matmul_backward(a, w, dz)   # builds and loads the kernel first
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    da, db = ops.matmul_backward(a, w, dz)
    torch.cuda.synchronize()
    outputs = da.numel() * da.element_size() + db.numel() * db.element_size()
    extra = torch.cuda.max_memory_allocated() - base - outputs
    assert extra < a.numel() * a.element_size(), extra


FA_BWD_CASES = [
    dict(b=1, s=256, hq=8, hkv=2, d=128),                  # GQA 4:1
    dict(b=2, s=130, hq=4, hkv=4, d=112),                  # ragged tiles
    dict(b=1, s=200, hq=4, hkv=1, d=64),
    dict(b=1, s=256, hq=4, hkv=2, d=128, window=64, softcap=30.0),
    dict(b=2, s=96, hq=4, hkv=2, d=128, q_offset=(32, 0),
         kv_len=(128, 70), skv=128),                       # offsets, lengths
    dict(b=1, s=2048, hq=32, hkv=8, d=128),                # llama3-8b
    dict(b=2, s=96, hq=4, hkv=2, d=128, window=32,
         kv_len=(0, 50)),                                  # rows see no key
    dict(b=1, s=2100, hq=32, hkv=8, d=128),                # s % 64 != 0
    # head dim 256: two warpgroups a block, each half of dK/dV and dQ
    dict(b=1, s=2048, hq=8, hkv=4, d=256, softcap=50.0),   # gemma2-2b
    dict(b=2, s=640, hq=8, hkv=4, d=256, window=256,
         softcap=50.0),                                    # the window bites
    dict(b=2, s=96, hq=4, hkv=2, d=256, q_offset=(32, 0),
         kv_len=(128, 70), skv=128),                       # offsets, lengths
]


def _fa_inputs(cuda, c):
    c = {"window": 0, "softcap": 0.0, "q_offset": None, "kv_len": None,
         "skv": None, **c}
    b, s, skv = c["b"], c["s"], c["skv"] or c["s"]
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(b, s, c["hq"], c["d"], generator=gen, device=cuda)
    k = torch.randn(b, skv, c["hkv"], c["d"], generator=gen, device=cuda)
    v = torch.randn(b, skv, c["hkv"], c["d"], generator=gen, device=cuda)
    do = torch.randn(b, s, c["hq"], c["d"], generator=gen, device=cuda)
    qo = torch.tensor(c["q_offset"] or (0,) * b, device=cuda)
    kl = torch.tensor(c["kv_len"] or (skv,) * b, device=cuda)
    opts = dict(causal=True, window=c["window"], softcap=c["softcap"])
    return [t.bfloat16() for t in (q, k, v, do)], qo, kl, opts


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_BWD_CASES)
def test_flash_attention_backward_kernel_matches_plain(cuda, case):
    """The forward kernel's log-sum-exp against the plain one; then dQ, dK
    and dV of the backward kernel against the plain backward on the same
    inputs (the kernel's O and log-sum-exp)."""
    (q, k, v, do), qo, kl, opts = _fa_inputs(cuda, case)
    out, lse = ops.flash_attention_lse(q, k, v, qo, kl, **opts)
    want_out, want_lse = ref.attention_lse_ref(q, k, v, qo, kl, **opts)
    seen = torch.isfinite(want_lse)
    assert bool((torch.isfinite(lse) == seen).all())
    assert float((lse - want_lse)[seen].abs().max()) <= 1e-3
    _close(out, want_out, atol=2e-2, rtol=2e-2)
    before = ops.BACKWARD_LAUNCHES["flash_attention_bwd"]
    got = ops.flash_attention_backward(q, k, v, out, do, lse, qo, kl, **opts)
    torch.cuda.synchronize()
    assert ops.BACKWARD_LAUNCHES["flash_attention_bwd"] == before + 1
    want = ref.attention_bwd_ref(q, k, v, out, do, lse, qo, kl, **opts)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= BWD_REL, name


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_BWD_CASES[:5] + FA_BWD_CASES[-3:])
def test_flash_attention_backward_merges_many_parts(cuda, monkeypatch, case):
    """Items of one row tile each: every key tile of several row tiles is
    summed from that many partials by its last item, in item order (at
    head dim 256 each of a block's two warpgroups writes and sums its own
    columns of a key tile's dK/dV)."""
    monkeypatch.setattr(ops, "BWD_MIN_ITEM", 1)
    monkeypatch.setattr(ops, "BWD_ITEMS_PER_BLOCK", 10 ** 6)
    ops.attention_bwd_plan.cache_clear()
    ops._bwd_items.cache_clear()
    try:
        (q, k, v, do), qo, kl, opts = _fa_inputs(cuda, case)
        out, lse = ops.flash_attention_lse(q, k, v, qo, kl, **opts)
        b, s, hq, d = q.shape
        plan = ops.attention_bwd_plan(b, s, hq, k.shape[2], k.shape[1],
                                      True, opts["window"], d=d)
        assert plan.max_len == 1 and plan.slots > 0
        assert plan.blocks <= ops.bwd_blocks_per_sm(d) * ops.SMS
        got = ops.flash_attention_backward(q, k, v, out, do, lse, qo, kl,
                                           **opts)
        again = ops.flash_attention_backward(q, k, v, out, do, lse, qo, kl,
                                             **opts)
        want = ref.attention_bwd_ref(q, k, v, out, do, lse, qo, kl, **opts)
        for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            assert torch.equal(g, a), name
            assert _rel(g, w) <= BWD_REL, name
    finally:
        ops.attention_bwd_plan.cache_clear()
        ops._bwd_items.cache_clear()


# the training kernel (attention_plan's variant 1): b, s, skv, hq, hkv, d,
# q_offset, kv_len, window, softcap
FA_TRAIN_CASES = {
    "llama3-8b s=2048": (1, 2048, 2048, 32, 8, 128, None, None, 0, 0.0),
    "gpt-m2 s=2048 MHA": (1, 2048, 2048, 32, 32, 128, None, None, 0, 0.0),
    "zamba2-7b s=2048 d=112": (1, 2048, 2048, 32, 32, 112, None, None, 0,
                               0.0),
    "s=2100, not a multiple of 128": (1, 2100, 2100, 8, 2, 128, None, None,
                                      0, 0.0),
    "offsets, kv_len < skv": (2, 300, 420, 4, 1, 128, (120, 0), (420, 250),
                              0, 0.0),
    "window + softcap d=112": (1, 260, 260, 4, 2, 112, None, None, 64, 30.0),
    "rows that see no key": (2, 200, 200, 4, 2, 128, None, (0, 150), 32,
                             0.0),
    # head dim 256 (gemma2-2b): the instance in key tiles of 64
    "gemma2-2b s=2048 softcap 50": (1, 2048, 2048, 8, 4, 256, None, None, 0,
                                    50.0),
    "d=256 window 512 softcap 50": (1, 2048, 2048, 8, 4, 256, None, None,
                                    512, 50.0),
    "d=256 no softcap, s=2100": (1, 2100, 2100, 8, 4, 256, None, None, 0,
                                 0.0),
    "d=256 window 512, s=1000, b=2": (2, 1000, 1000, 4, 2, 256, None, None,
                                      512, 0.0),
    "d=256 offsets, kv_len < skv": (2, 300, 420, 4, 1, 256, (120, 0),
                                    (420, 250), 0, 50.0),
    "d=256 rows that see no key": (2, 200, 200, 4, 2, 256, None, (0, 150),
                                   32, 30.0),
}
#: FA_TRAIN_CASES at head dim 256
FA_TRAIN_256 = [c for c, v in FA_TRAIN_CASES.items() if v[5] == 256]


def _fa_train_inputs(cuda, case, seed=6):
    b, s, skv, hq, hkv, d, q_off, kv_len, window, softcap = \
        FA_TRAIN_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, do = (torch.randn(b, s, hq, d, generator=gen, device=cuda).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b, skv, hkv, d, generator=gen, device=cuda).bfloat16()
            for _ in range(2))
    qo = torch.tensor(q_off or (0,) * b, dtype=torch.int32, device=cuda)
    kl = torch.tensor(kv_len or (skv,) * b, dtype=torch.int32, device=cuda)
    return q, k, v, do, qo, kl, dict(window=window, softcap=softcap)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FA_TRAIN_CASES))
def test_flash_attention_train_kernel_matches_plain(cuda, case):
    """One launch of ``flash_attention_train.cu``: O within ``FA_TOL`` of
    the plain attention and of the plain mirror of the kernel's order, the
    log-sum-exp within 1e-3 where a row sees a key and -inf (O zero) where
    it sees none; the same bits on every call."""
    q, k, v, _, qo, kl, kw = _fa_train_inputs(cuda, case)
    b, s, hq, d = q.shape
    assert ops.attention_plan(b, s, hq, k.shape[2], k.shape[1],
                              d=d).variant == 1
    before = ops.LAUNCHES["flash_attention"]
    trained = ops.ATTENTION_VARIANT_LAUNCHES[1]
    out, lse = ops.flash_attention_lse(q, k, v, qo, kl, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert ops.ATTENTION_VARIANT_LAUNCHES[1] == trained + 1
    want, want_lse = ref.attention_lse_ref(q, k, v, qo, kl, **kw)
    _close(out, want, **FA_TOL)
    _close(out, ref.attention_train_ref(q, k, v, qo, kl, **kw)[0], **FA_TOL)
    seen = torch.isfinite(want_lse)
    assert bool((torch.isfinite(lse) == seen).all())
    assert float((lse - want_lse)[seen].abs().max()) <= 1e-3
    assert float(out[~seen.transpose(1, 2)].float().abs().sum()) == 0.0
    for _ in range(2):
        again = ops.flash_attention_lse(q, k, v, qo, kl, **kw)
        assert torch.equal(again[0], out) and torch.equal(again[1], lse)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["llama3-8b s=2048", "zamba2-7b s=2048 d=112",
                                  "offsets, kv_len < skv",
                                  "window + softcap d=112",
                                  "rows that see no key"] + FA_TRAIN_256)
def test_flash_attention_backward_reads_the_train_kernels_lse(cuda, case):
    """dQ, dK and dV of the backward kernel from the training kernel's O
    and log-sum-exp, against the plain backward on the same inputs."""
    q, k, v, do, qo, kl, kw = _fa_train_inputs(cuda, case)
    out, lse = ops.flash_attention_lse(q, k, v, qo, kl, **kw)
    got = ops.flash_attention_backward(q, k, v, out, do, lse, qo, kl, **kw)
    want = ref.attention_bwd_ref(q, k, v, out, do, lse, qo, kl, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= BWD_REL, name


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width", [(1, 64), (37, 3584), (2048, 4096),
                                        (300, 1024), (4096, 4096)])
def test_rmsnorm_backward_kernel_matches_plain(cuda, rows, width):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.randn(rows, width, generator=gen, device=cuda) * 3).bfloat16()
    gamma = torch.rand(width, generator=gen, device=cuda) + 0.5
    dy = torch.randn(rows, width, generator=gen, device=cuda).bfloat16()
    before = ops.BACKWARD_LAUNCHES["rmsnorm_bwd"]
    dx, dgamma = ops.rmsnorm_backward(x, gamma, dy, eps=1e-5)
    torch.cuda.synchronize()
    assert ops.BACKWARD_LAUNCHES["rmsnorm_bwd"] == before + 1
    want_dx, want_dg = ref.rmsnorm_bwd_ref(x, gamma, dy, 1e-5)
    assert dx.dtype == torch.bfloat16 and dgamma.dtype == torch.float32
    assert _rel(dx, want_dx) <= RMSNORM_DX_REL
    assert _rel(dgamma, want_dg) <= DGAMMA_REL


#: the split dx, relative L2, against the plain apply on the same rstd and
#: dot and against the whole-row backward kernel (the same fp32 arithmetic
#: in another order, rounded to bf16).  The dot's term is about 1/sqrt(h)
#: of dx here, so a dx given one slice's dot for the all-reduced one is
#: 1e-2 off
SPLIT_DX_REL = 1e-3


def _split(cuda, rows, h, d2, eps=1e-5, seed=11, local_dot=False):
    """The split rmsnorm of ``x [rows, h]`` on ``d2`` slices through its
    four wrappers, the tp2 all-reduce played in one process (the slices'
    row sums added): every slice's forward first, then every backward.
    ``local_dot``: the backward apply reads slice 0's own dot (a planted
    fault); ``dot`` is the all-reduced one all the same."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(rows, h, generator=gen, device=cuda) * 3).bfloat16()
    g = torch.rand(h, generator=gen, device=cuda) + 0.5
    dy = torch.randn(rows, h, generator=gen, device=cuda).bfloat16()
    w = h // d2
    xs = [x[:, i * w:(i + 1) * w].contiguous() for i in range(d2)]
    gs = [g[i * w:(i + 1) * w].contiguous() for i in range(d2)]
    dys = [dy[:, i * w:(i + 1) * w].contiguous() for i in range(d2)]
    ss = [ops.rmsnorm_ss(xi) for xi in xs]
    total = torch.stack(ss).sum(0)
    applied = [ops.rmsnorm_apply(xi, gi, total, h, eps)
               for xi, gi in zip(xs, gs)]
    back = [ops.rmsnorm_bwd_partial(xi, gi, di, r)
            for xi, gi, di, (_, r) in zip(xs, gs, dys, applied)]
    dot = torch.stack([d for d, _ in back]).sum(0)
    dxs = [ops.rmsnorm_bwd_apply(xi, gi, di, r,
                                 back[0][0] if local_dot else dot, h)
           for xi, gi, di, (_, r) in zip(xs, gs, dys, applied)]
    return dict(x=x, g=g, dy=dy, xs=xs, gs=gs, dys=dys, ss=ss, total=total,
                applied=applied, back=back, dot=dot, dxs=dxs)


def _ulp(x):
    xf = x.float()
    return torch.ldexp(torch.ones_like(xf), torch.frexp(xf)[1] - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,h,d2", [(2048, 4096, 2), (37, 3584, 4),
                                       (4, 2304, 2)])
def test_split_rmsnorm_kernels_match_plain_and_the_whole_row(cuda, rows, h,
                                                            d2):
    """The four split kernels against their plain versions on the same
    inputs (the fp32 partial sums within 1e-5 relative, y within one bf16
    ulp, dx within ``SPLIT_DX_REL``), and the slices together against the
    whole-row kernels: y within one bf16 ulp, dx and dgamma within 1e-3
    relative L2.  Each wrapper call is one launch."""
    eps = 1e-5
    before = dict(ops.SPLIT_LAUNCHES)
    run = _split(cuda, rows, h, d2, eps)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in ops.SPLIT_LAUNCHES.items()} == \
        dict.fromkeys(ops.SPLIT_LAUNCHES, d2)
    for xi, gi, di, s, (y, r), (dot, dg), dxi in zip(
            run["xs"], run["gs"], run["dys"], run["ss"], run["applied"],
            run["back"], run["dxs"]):
        assert s.shape == (rows,) and s.dtype == torch.float32
        assert float(((s - ref.rmsnorm_ss_ref(xi)).abs()
                      / ref.rmsnorm_ss_ref(xi)).max()) <= 1e-5
        py, pr = ref.rmsnorm_apply_ref(xi, gi, run["total"], h, eps)
        assert bool(((y.float() - py.float()).abs() <= _ulp(py)).all())
        assert float(((r - pr).abs() / pr).max()) <= 1e-5
        pdot, pdg = ref.rmsnorm_bwd_partial_ref(xi, gi, di, r)
        assert _rel(dot, pdot) <= 1e-5 and _rel(dg, pdg) <= 1e-5
        assert _rel(dxi, ref.rmsnorm_bwd_apply_ref(xi, gi, di, r, run["dot"],
                                                   h)) <= SPLIT_DX_REL
    whole = ops.rmsnorm(run["x"], run["g"], eps=eps)
    y = torch.cat([y for y, _ in run["applied"]], -1)
    assert bool(((y.float() - whole.float()).abs() <= _ulp(whole)).all())
    wdx, wdg = ops.rmsnorm_backward(run["x"], run["g"], run["dy"], eps=eps)
    assert _rel(torch.cat(run["dxs"], -1), wdx) <= SPLIT_DX_REL
    assert _rel(torch.cat([dg for _, dg in run["back"]], -1), wdg) <= \
        DGAMMA_REL


@pytest.mark.cuda
def test_split_rmsnorm_function_runs_the_kernels_under_autograd(cuda):
    """``ops.split_rmsnorm`` at d2 = 1 (``reduce`` the identity: one slice
    is the whole row) forward and backward through the four kernels,
    against the whole-row kernels; ``reduce`` sees the fp32 row sums twice
    (sum x^2, then sum dy gamma x)."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    x = (torch.randn(64, 2048, generator=gen, device=cuda) * 2).bfloat16()
    g = torch.rand(2048, generator=gen, device=cuda) + 0.5
    dy = torch.randn(64, 2048, generator=gen, device=cuda).bfloat16()
    seen = []
    xl, gl = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    before = dict(ops.SPLIT_LAUNCHES)
    y = ops.split_rmsnorm(xl, gl, width=2048, eps=1e-5,
                          reduce=lambda t: seen.append(t.shape))
    dx, dg = torch.autograd.grad(y, (xl, gl), dy)
    torch.cuda.synchronize()
    assert seen == [(64,), (64,)]
    assert all(ops.SPLIT_LAUNCHES[k] == v + 1 for k, v in before.items())
    whole = ops.rmsnorm(x, g, eps=1e-5)
    assert bool(((y.float() - whole.float()).abs() <= _ulp(whole)).all())
    wdx, wdg = ops.rmsnorm_backward(x, g, dy, eps=1e-5)
    assert _rel(dx, wdx) <= SPLIT_DX_REL and _rel(dg, wdg) <= DGAMMA_REL


@pytest.mark.cuda
def test_split_rmsnorm_planted_fault_and_refusals(cuda):
    """Two planted faults, each far from the whole row: the apply kernel
    given slice 0's own sum of squares (no all-reduce) fails the one-ulp
    check; the backward apply given slice 0's own dot fails the 1e-3
    check on dx, against the plain apply and against the whole-row
    backward, at each width and d2.  The wrappers refuse a width that is
    not a multiple of 8 or above ``RMSNORM_MAX_WIDTH``, fp32 rows and a
    bf16 gamma."""
    run = _split(cuda, 256, 4096, 2)
    x0, g0 = run["xs"][0], run["gs"][0]
    bad, _ = ops.rmsnorm_apply(x0, g0, run["ss"][0], 4096, 1e-5)
    good = ops.rmsnorm(run["x"], run["g"], eps=1e-5)[:, :2048]
    assert not bool(((bad.float() - good.float()).abs()
                     <= _ulp(good)).all())
    for h, d2 in ((4096, 2), (3584, 4), (2304, 2)):
        bad = _split(cuda, 256, h, d2, local_dot=True)
        wdx, _ = ops.rmsnorm_backward(bad["x"], bad["g"], bad["dy"], eps=1e-5)
        assert _rel(torch.cat(bad["dxs"], -1), wdx) > SPLIT_DX_REL, (h, d2)
        for xi, gi, di, (_, r), dxi in zip(bad["xs"], bad["gs"], bad["dys"],
                                           bad["applied"], bad["dxs"]):
            assert _rel(dxi, ref.rmsnorm_bwd_apply_ref(
                xi, gi, di, r, bad["dot"], h)) > SPLIT_DX_REL, (h, d2)
    for shape in ((4, 1020), (4, 4104)):
        with pytest.raises(ValueError, match="multiple of 8"):
            ops.rmsnorm_ss(torch.zeros(shape, dtype=torch.bfloat16,
                                       device=cuda))
    with pytest.raises(TypeError, match="bf16"):
        ops.rmsnorm_ss(torch.zeros(4, 1024, device=cuda))
    with pytest.raises(ValueError, match="fp32 gamma"):
        ops.rmsnorm_apply(x0, g0.bfloat16(), run["total"], 4096, 1e-5)


@pytest.mark.cuda
def test_backward_kernels_are_deterministic(cuda):
    """No float atomics: two runs give the same bits."""
    (q, k, v, do), qo, kl, opts = _fa_inputs(cuda, FA_BWD_CASES[0])
    out, lse = ops.flash_attention_lse(q, k, v, qo, kl)
    first = ops.flash_attention_backward(q, k, v, out, do, lse, qo, kl)
    again = ops.flash_attention_backward(q, k, v, out, do, lse, qo, kl)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    x, dy = q.reshape(-1, 128), do.reshape(-1, 128)
    gamma = torch.ones(128, device=cuda)
    assert all(torch.equal(a, b) for a, b in zip(
        ops.rmsnorm_backward(x, gamma, dy), ops.rmsnorm_backward(x, gamma, dy)))


@pytest.mark.cuda
def test_autograd_through_the_kernels_matches_plain(cuda):
    """One attention block's worth of the Functions on the card: the
    gradients that autograd collects through the kernels against the plain
    versions' gradients on fp32 copies (CPU)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2, 64, 256, generator=gen, device=cuda).bfloat16()
    gamma = torch.rand(256, generator=gen, device=cuda) + 0.5
    w = (torch.randn(256, 3 * 128, generator=gen, device=cuda) / 16).bfloat16()
    qo = torch.zeros(2, dtype=torch.int32, device=cuda)
    kl = torch.full((2,), 64, dtype=torch.int32, device=cuda)

    def run(x, gamma, w):
        h = ops.rmsnorm(x, gamma, eps=1e-6)
        q, k, v = ops.matmul(h, w).reshape(2, 64, 3, 1, 128).unbind(2)
        o = ops.flash_attention(q, k, v, qo.to(x.device), kl.to(x.device))
        return o.float().square().sum()

    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, w)]
    got = torch.autograd.grad(run(*leaves), leaves)
    plain = [t.detach().cpu().float().requires_grad_(True)
             for t in (x, gamma, w)]
    want = torch.autograd.grad(run(*plain), plain)
    for name, g, wt in zip(("x", "gamma", "w"), got, want):
        assert _rel(g.cpu(), wt) <= 5e-2, name


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,variant,act,bias", [
    (16, 1024, 2048, 0, "gelu", True),    # 16-row tiles (a small B)
    (64, 2048, 4096, 1, "gelu", False),   # 64x128 wgmma, shared tiles
    (64, 3584, 3584, 1, "silu", True),    # shared tiles merged, then bias
    (512, 1024, 2048, 2, "gelu", False),  # the training tile (variant 2)
    (2048, 4096, 16384, 2, "gelu", False),  # gpt-m2's up projection
    (520, 1024, 1000, 2, "silu", True),   # ragged edges on variant 2
])
def test_fused_activation_under_autograd_runs_the_kernels(cuda, m, k, n,
                                                          variant, act, bias):
    """The forward under autograd is one launch that also writes the
    pre-activation z: z bit for bit the output of the same plan without an
    activation, y bit for bit the output without z.  The backward takes the
    activation's derivative with ``csrc/act_bwd.cu`` (one launch) and then
    the matmul backward; the gradients of a, w and the bias within 5e-2
    relative L2 of the plain backward on the card from the same z."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    a = torch.randn(m, k, generator=gen, device=cuda).bfloat16()
    w = (torch.randn(k, n, generator=gen, device=cuda) * k ** -0.5).bfloat16()
    bv = torch.randn(n, generator=gen, device=cuda).bfloat16() if bias \
        else None
    dy = torch.randn(m, n, generator=gen, device=cuda).bfloat16()
    assert ops.matmul_plan(m, n, k).variant == variant
    y, z = ops._matmul(a, w, bv, act, z_out=True)
    assert torch.equal(z, ops._matmul(a, w, bv, None))
    assert torch.equal(y, ops._matmul(a, w, bv, act))
    want_y, want_z = ref.matmul_aux_ref(a, w, bv, act)
    _close(y, want_y, **BF16_TOL)
    _close(z, want_z, **BF16_TOL)

    leaves = [t.clone().requires_grad_(True) for t in (a, w, bv)
              if t is not None]
    fwd, act_bwd = ops.LAUNCHES["matmul"], ops.BACKWARD_LAUNCHES[
        "matmul_act_bwd"]
    out = ops.matmul(*leaves[:2], leaves[2] if bias else None,
                     activation=act)
    assert torch.equal(out, y) and ops.LAUNCHES["matmul"] == fwd + 1
    got = torch.autograd.grad(out, leaves, dy)
    torch.cuda.synchronize()
    assert ops.BACKWARD_LAUNCHES["matmul_act_bwd"] == act_bwd + 1
    dz = ref.epilogue_bwd(z, dy, act)
    want = [*ref.matmul_bwd_ref(a, w, dz), dz.float().sum(0)][:len(leaves)]
    for name, g, wt in zip(("a", "w", "bias"), got, want):
        assert g.shape == wt.shape, name
        assert _rel(g, wt) <= 5e-2, name


def _bf16_ulp(x):
    """The spacing of bf16 values at ``x`` (8 significant bits)."""
    xf = x.float()
    return torch.ldexp(torch.ones_like(xf),
                       torch.frexp(xf)[1] - 8).clamp_min(2.0 ** -133)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["gelu", "silu"])
@pytest.mark.parametrize("shape,offset", [
    ((2048, 16384), 0),   # gpt-m2's up projection
    ((3, 1001), 0),       # 3003 elements: a tail of 3 past the vectors
    ((37, 77), 1),        # bases off 16 bytes: every element scalar
    ((7, 4099), 0),       # ragged: 28693 elements, vectors past the unroll
    ((129, 33), 1),       # an unaligned base over several blocks: scalar
])
def test_activation_backward_kernel_matches_plain(cuda, act, shape, offset):
    """``csrc/act_bwd.cu`` within one bf16 ulp of ``ref.epilogue_bwd`` on
    the same inputs (z spread to |z| = 12, where tanh saturates), one launch
    counted, and against ``aten.gelu_backward`` / ``aten.silu_backward``
    (one PyTorch call for the same function, in its own order of
    operations) within ``BF16_TOL``.  One ulp, not zero: the kernel takes
    tanh and the sigmoid by ex2 and rcp and contracts its products into
    FMAs, so its fp32 derivative differs from the plain version's by
    rounding, which can move the bf16 result to the neighbouring value."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    n = shape[0] * shape[1]
    z = (torch.randn(n + offset, generator=gen, device=cuda) * 4).clamp(
        -12, 12).bfloat16()[offset:].view(shape)
    dy = torch.randn(n + offset, generator=gen, device=cuda).bfloat16()[
        offset:].view(shape)
    before = ops.BACKWARD_LAUNCHES["matmul_act_bwd"]
    got = ops.activation_backward(dy, z, act)
    torch.cuda.synchronize()
    assert ops.BACKWARD_LAUNCHES["matmul_act_bwd"] == before + 1
    assert got.shape == shape and got.dtype == torch.bfloat16
    want = ref.epilogue_bwd(z, dy, act)
    err = (got.float() - want.float()).abs()
    assert bool((err <= _bf16_ulp(want)).all()), float(err.max())
    lib = torch.ops.aten.gelu_backward(dy, z, approximate="tanh") \
        if act == "gelu" else torch.ops.aten.silu_backward(dy, z)
    _close(got, lib, **BF16_TOL)
    assert ops.activation_backward(dy, z, None) is dy


def _ssd_bwd_inputs(cuda, b, s, nh, seed=6):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)

    x, dy = randn(b, s, nh, 64).bfloat16(), randn(b, s, nh, 64).bfloat16()
    dt = torch.nn.functional.softplus(randn(b, s, nh))
    A_log, D = randn(nh) * 0.5, randn(nh)
    bc = randn(b, s, 128).bfloat16()     # B and C are halves of one tensor
    return x, dt, A_log, bc[..., :64], bc[..., 64:], D, dy


SSD_BWD_NAMES = ("dx", "ddt", "dA_log", "dB", "dC", "dD")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,nh,chunk", [
    (1, 64, 4, 64),        # one chunk
    (2, 100, 8, 64),       # a ragged second chunk
    (2, 128, 16, 64),      # two chunks: the state's gradient crosses
    (1, 50, 4, 16),        # chunks of 16
    (1, 2048, 112, 64),    # zamba2-7b's training shape
])
def test_ssd_scan_backward_kernel_matches_plain(cuda, b, s, nh, chunk):
    """dx, dB, dC (bf16) within ``BWD_REL`` and ddt, dA_log, dD (fp32 sums
    in another order) within ``DGAMMA_REL`` of the plain backward on the
    same inputs; one launch counted."""
    inputs = _ssd_bwd_inputs(cuda, b, s, nh)
    before = ops.BACKWARD_LAUNCHES["ssd_scan_bwd"]
    got = ops.ssd_scan_backward(*inputs, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.BACKWARD_LAUNCHES["ssd_scan_bwd"] == before + 1
    want = ref.ssd_bwd_ref(*inputs, chunk)
    for name, g, w in zip(SSD_BWD_NAMES, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        limit = BWD_REL if g.dtype == torch.bfloat16 else DGAMMA_REL
        assert _rel(g, w) <= limit, name


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,groups,width,gated", [
    (2048, 112, 64, True),   # zamba2-7b's training shape
    (5, 3, 64, True),
    (64, 112, 64, False),
    (33, 4, 32, True),       # a narrower group: half the lanes idle
])
def test_group_rmsnorm_backward_kernel_matches_plain(cuda, tokens, groups,
                                                     width, gated):
    """dy and dgate (bf16) within ``BWD_REL``, dgamma (fp32) within
    ``DGAMMA_REL``, the gate read through its stride (a slice of the z|x
    output); one launch counted."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    y = (torch.randn(tokens, groups, width, generator=gen, device=cuda)
         * 2).bfloat16()
    gamma = torch.rand(groups, width, generator=gen, device=cuda) + 0.5
    dout = torch.randn(tokens, groups, width, generator=gen,
                       device=cuda).bfloat16()
    z = torch.randn(tokens, 2 * groups * width, generator=gen,
                    device=cuda).bfloat16()
    gate = z[:, :groups * width].unflatten(-1, (groups, width)) if gated \
        else None
    before = ops.BACKWARD_LAUNCHES["group_rmsnorm_bwd"]
    got = ops.group_rmsnorm_backward(y, gamma, dout, 1e-6, gate=gate)
    torch.cuda.synchronize()
    assert ops.BACKWARD_LAUNCHES["group_rmsnorm_bwd"] == before + 1
    want = ref.group_rmsnorm_bwd_ref(y, gamma, dout, 1e-6, gate)
    assert _rel(got[0], want[0]) <= BWD_REL
    assert got[1].dtype == torch.float32
    assert _rel(got[1], want[1]) <= DGAMMA_REL
    if gated:
        assert _rel(got[2], want[2]) <= BWD_REL
    else:
        assert got[2] is None


@pytest.mark.cuda
def test_mamba_backward_kernels_are_deterministic(cuda):
    """No float atomics in the SSD scan's or the grouped norm's backward:
    two runs give the same bits."""
    inputs = _ssd_bwd_inputs(cuda, 2, 192, 8)
    first = ops.ssd_scan_backward(*inputs, chunk=64)
    again = ops.ssd_scan_backward(*inputs, chunk=64)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    y, dy = inputs[0], inputs[-1]
    gamma, gate = torch.rand(8, 64, device=cuda) + 0.5, inputs[0].flip(1)
    first = ops.group_rmsnorm_backward(y, gamma, dy, gate=gate)
    again = ops.group_rmsnorm_backward(y, gamma, dy, gate=gate)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_autograd_through_the_mamba_kernels_matches_plain(cuda):
    """The SSD scan and the grouped, gated norm as a Mamba2 block chains
    them, on the card: the gradients autograd collects through the
    kernels against the plain versions' on fp32 copies (CPU)."""
    x, dt, A_log, B, C, D, _ = _ssd_bwd_inputs(cuda, 2, 160, 8, seed=8)
    gn = torch.rand(8, 64, device=cuda) + 0.5
    z = torch.randn(2, 160, 8, 64, device=cuda).bfloat16()

    def run(x, dt, A_log, B, C, D, gn, z):
        y, _ = ops.ssd_scan(x, dt, A_log, B, C, D, chunk=64)
        return ops.group_rmsnorm(y, gn, gate=z).float().square().sum()

    inputs = (x, dt, A_log, B.contiguous(), C.contiguous(), D, gn, z)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    before = dict(ops.BACKWARD_LAUNCHES)
    got = torch.autograd.grad(run(*leaves), leaves)
    assert ops.BACKWARD_LAUNCHES["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1
    assert ops.BACKWARD_LAUNCHES["group_rmsnorm_bwd"] == \
        before["group_rmsnorm_bwd"] + 1
    plain = [t.detach().cpu().float().requires_grad_(True) for t in inputs]
    want = torch.autograd.grad(run(*plain), plain)
    names = ("x", "dt", "A_log", "B", "C", "D", "gn", "z")
    for name, g, w in zip(names, got, want):
        assert _rel(g.cpu(), w) <= 5e-2, name


def _ssd_bwd_holds(inputs, chunk):
    """The SSD backward kernel against the plain backward on ``inputs``:
    dx, dB, dC within ``BWD_REL``, ddt, dA_log, dD within ``DGAMMA_REL``;
    one launch counted."""
    before = ops.BACKWARD_LAUNCHES["ssd_scan_bwd"]
    got = ops.ssd_scan_backward(*inputs, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.BACKWARD_LAUNCHES["ssd_scan_bwd"] == before + 1
    want = ref.ssd_bwd_ref(*inputs, chunk)
    for name, g, w in zip(SSD_BWD_NAMES, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        limit = BWD_REL if g.dtype == torch.bfloat16 else DGAMMA_REL
        assert _rel(g, w) <= limit, name


def _with_heads(monkeypatch, heads):
    """``ops.ssd_bwd_plan`` patched to take ``heads`` heads a block."""
    plan = ops.ssd_bwd_plan

    def patched(b, s, nh, chunk, sms=ops.SMS):
        return ops.SsdBwdPlan(b, plan(b, s, nh, chunk, sms).nc, nh, heads)

    monkeypatch.setattr(ops, "ssd_bwd_plan", patched)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [None, 1, 2, 4, 8])
def test_ssd_scan_backward_kernel_two_rows_every_head_group(cuda, monkeypatch,
                                                            heads):
    """Two batch rows at zamba2-7b's training shape (2 x 32 chunks, 112
    heads), with the plan's head groups and with each size a block can
    take: every row's partial dB and dC rows and the (row, chunk) partials
    of dA_log and dD land in their sums."""
    if heads is not None:
        _with_heads(monkeypatch, heads)
    _ssd_bwd_holds(_ssd_bwd_inputs(cuda, 2, 2048, 112), 64)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,nh,chunk,heads", [
    (1, 256, 13, 64, 4),   # 13 heads: the last group of 4 has one
    (2, 200, 13, 64, 8),   # and of 8, five; a ragged last chunk
    (1, 65, 8, 64, None),  # a one-position last chunk
    (2, 65, 13, 16, 2),    # chunks of 16, the last one position
])
def test_ssd_scan_backward_kernel_uneven_groups_and_chunks(cuda, monkeypatch,
                                                           b, s, nh, chunk,
                                                           heads):
    """Head groups that do not divide the heads, and a last chunk of one
    position, against the plain backward."""
    if heads is not None:
        _with_heads(monkeypatch, heads)
    _ssd_bwd_holds(_ssd_bwd_inputs(cuda, b, s, nh), chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,groups,width,gated", [
    (1000, 112, 64, True),   # 1000 over 264 shares: 3 or 4 tokens each
    (2047, 112, 64, False),
    (300, 40, 24, True),     # 160 threads of 2 slots; 3 of 8 slots live
    (77, 200, 64, True),     # 1600 slots: 8 a thread
])
def test_group_rmsnorm_backward_kernel_uneven_shares(cuda, tokens, groups,
                                                     width, gated):
    """Token counts that split unevenly over the shares, and rows of other
    group counts and widths, against the plain backward: dy and dgate
    within ``BWD_REL``, dgamma within ``DGAMMA_REL``; one launch counted."""
    plan = ops.group_rmsnorm_bwd_plan(tokens, groups, width)
    assert tokens % plan.shares or plan.shares == tokens
    gen = torch.Generator(device=cuda).manual_seed(9)
    y = (torch.randn(tokens, groups, width, generator=gen, device=cuda)
         * 2).bfloat16()
    gamma = torch.rand(groups, width, generator=gen, device=cuda) + 0.5
    dout = torch.randn(tokens, groups, width, generator=gen,
                       device=cuda).bfloat16()
    z = torch.randn(tokens, 2 * groups * width, generator=gen,
                    device=cuda).bfloat16()
    gate = z[:, :groups * width].unflatten(-1, (groups, width)) if gated \
        else None
    before = ops.BACKWARD_LAUNCHES["group_rmsnorm_bwd"]
    got = ops.group_rmsnorm_backward(y, gamma, dout, 1e-6, gate=gate)
    torch.cuda.synchronize()
    assert ops.BACKWARD_LAUNCHES["group_rmsnorm_bwd"] == before + 1
    want = ref.group_rmsnorm_bwd_ref(y, gamma, dout, 1e-6, gate)
    assert _rel(got[0], want[0]) <= BWD_REL
    assert _rel(got[1], want[1]) <= DGAMMA_REL
    if gated:
        assert _rel(got[2], want[2]) <= BWD_REL
    else:
        assert got[2] is None


# ---------------------------------------------------------------------------
# The paged serving step captured as CUDA graphs (launch.steps.CapturedStep)
# at published widths, depth cut: llama3-8b at 2 layers, zamba2-7b at 7
# (a super-block of the shared block and 5 Mamba2 blocks, 1 tail block).
# ---------------------------------------------------------------------------

GRAPH_LAYERS = {"llama3-8b": 2, "zamba2-7b": 7}


def _card_server(arch, cuda, seed=4, requests=3):
    """A server at ``GRAPH_LAYERS`` depth, 2 slots (so they recycle), chunk
    64, and seeded prompts of 32-128 tokens."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config(arch), num_layers=GRAPH_LAYERS[arch])
    prompts = serve.sample_prompts(cfg, requests, 128, seed)
    scfg = serve.paged_server_config(
        [len(p) for p in prompts], slots=2, prefill_chunk=64, page_size=16,
        max_seq=160, max_new=6)
    server, _ = serve.make_paged_server(
        cfg, scfg, lm.init_params(cfg, seed=seed, device=cuda), device=cuda)
    return cfg, server, prompts


def _serve_all(server, prompts, rid0=0):
    from repro_torch.runtime.server import Request

    for rid, p in enumerate(prompts):
        server.submit(Request(rid=rid0 + rid, prompt=p, max_new=6))
    server.run_until_drained()
    return {r.rid - rid0: r.out for r in server.completed if r.rid >= rid0}


def _idle_inputs(server, rows, s):
    """Step inputs of shape [rows, s] that write nothing live: every row on
    the garbage page at position 0, every slot id the sentinel."""
    import numpy as np

    from repro_torch.models.paging import GARBAGE_PAGE

    b, mp = server.cfg.batch_slots, server.cfg.paged.pages_per_slot
    args = [np.zeros((rows, s), np.int32), np.zeros(rows, np.int32),
            np.full((rows, mp), GARBAGE_PAGE, np.int32)]
    if server.cfg.recurrent:
        args.append(np.full(rows, b, np.int32))
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(GRAPH_LAYERS))
def test_captured_serving_gives_the_uncaptured_tokens(cuda, arch):
    """The same prompts through the captured step and then through the
    uncaptured body (``info.plain``) on the same server: identical greedy
    tokens for every request, and exactly two graphs."""
    _, server, prompts = _card_server(arch, cuda)
    got = _serve_all(server, prompts)
    step = server.step_fn
    assert step.step.captures == 2 and len(step.step.shapes) == 2
    server.step_fn = step.uncaptured()
    want = _serve_all(server, prompts, rid0=100)
    assert len(got) == len(prompts) and all(len(o) == 6 for o in got.values())
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(GRAPH_LAYERS))
def test_capture_leaves_every_pool_row_but_the_garbage_page(cuda, arch):
    """Serve through the uncaptured body so that the pools hold live pages
    and slot states, then warm up and capture both shapes: every page but
    the garbage page and every state row stays bit-identical."""
    from repro_torch.models.paging import GARBAGE_PAGE

    _, server, prompts = _card_server(arch, cuda)
    step = server.step_fn
    server.step_fn = step.uncaptured()
    _serve_all(server, prompts[:2])
    before = {k: t.clone() for k, t in _named_leaves(server.caches)}
    for rows, s in ((1, server.cfg.prefill_chunk),
                    (server.cfg.batch_slots, 1)):
        step.step(step.params, *_idle_inputs(server, rows, s), server.caches)
    torch.cuda.synchronize()
    assert step.step.captures == 2
    for k, t in _named_leaves(server.caches):
        if k.endswith("/k") or k.endswith("/v"):
            keep = [p for p in range(t.shape[1]) if p != GARBAGE_PAGE]
            assert torch.equal(t[:, keep], before[k][:, keep]), k
        else:
            assert torch.equal(t, before[k]), k


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(GRAPH_LAYERS))
def test_replays_count_the_captured_launches(cuda, arch):
    """``ops.LAUNCHES`` after n replays is n times what the capture
    recorded, and the capture recorded every kernel of the path."""
    _, server, _ = _card_server(arch, cuda)
    step = server.step_fn
    args = _idle_inputs(server, server.cfg.batch_slots, 1)
    step(*args, server.caches)                     # warm-up and capture
    (shape,) = step.step.shapes.values()
    kernels = {"matmul", "flash_attention", "rmsnorm"} | (
        {"ssd_scan"} if server.cfg.recurrent else set())
    assert {k for k, v in shape.launches.items() if v > 0} == kernels
    ops.reset_launches()
    for _ in range(3):
        step(*args, server.caches)
    assert ops.LAUNCHES == {k: 3 * v for k, v in shape.launches.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(GRAPH_LAYERS))
def test_capture_raises_on_a_host_sync_and_does_not_fall_back(cuda, arch,
                                                               monkeypatch):
    """A host sync planted in the step's body (zamba2: the host-synced
    ``lm.slot_map`` in place of ``fixed_slot_map``; llama3: a ``.item()``
    on the logits) fails the capture, which raises; no shape is kept, and
    a second call raises again instead of running the body uncaptured."""
    from repro_torch.models import lm

    _, server, _ = _card_server(arch, cuda)
    if server.cfg.recurrent:
        monkeypatch.setattr(lm, "fixed_slot_map", lm.slot_map)
    else:
        paged_step = lm.paged_step

        def synced(*a, **kw):
            logits, caches = paged_step(*a, **kw)
            logits.float().sum().item()
            return logits, caches

        monkeypatch.setattr(lm, "paged_step", synced)
    step = server.step_fn
    args = _idle_inputs(server, server.cfg.batch_slots, 1)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            step(*args, server.caches)
        assert step.step.shapes == {}
    assert step.step.warmups == 2 and step.step.captures == 0
    monkeypatch.undo()
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The wave's decode step over contiguous caches captured as CUDA graphs
# (launch.steps.build_decode_step), at the same widths and depths.
# ---------------------------------------------------------------------------


def _card_wave(arch, cuda, seed=5, batch=3, prompt_len=96):
    """A wave server at ``GRAPH_LAYERS`` depth for ``batch`` prompts of
    ``prompt_len`` tokens and 6 new ones, and two waves of seeded
    prompts."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config(arch), num_layers=GRAPH_LAYERS[arch])
    server = serve.make_wave_server(
        cfg, batch, prompt_len + 6, lm.init_params(cfg, seed=seed,
                                                   device=cuda), device=cuda)
    waves = [serve.wave_prompts(cfg, batch, prompt_len, seed + i)
             for i in range(2)]
    return server, waves


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(GRAPH_LAYERS))
def test_captured_wave_gives_the_uncaptured_tokens(cuda, arch):
    """Two waves in the same caches through the captured step (two graphs,
    a prefill and a tick, captured once: the warm-ups give back the
    caches' lengths and recurrent state), then through the uncaptured
    body: identical greedy tokens, and every kernel of the path counted
    per replay."""
    server, waves = _card_wave(arch, cuda)
    ops.reset_launches()
    got = [server.serve(p, 6) for p in waves]
    step = server.step
    assert step.captures == 2 and len(step.shapes) == 2
    kernels = {"matmul", "flash_attention", "rmsnorm"} | (
        {"ssd_scan"} if arch == "zamba2-7b" else set())
    for shape in step.shapes.values():
        assert {k for k, v in shape.launches.items() if v > 0} == kernels
    want = [server.uncaptured().serve(p, 6) for p in waves]
    for g, w in zip(got, want):
        assert g.shape == (3, 6)
        assert (g == w).all(), (g, w)
    assert not (got[0] == got[1]).all()


# ---------------------------------------------------------------------------
# The paged server's three modes on the card: the attention at head dim 256
# (gemma2-2b), quantized page pools, and the speculative step.
# ---------------------------------------------------------------------------

HEAD_DIM_256 = {  # (b, sq, skv, hq, hkv, q_offset, kv_len, window, softcap)
    # gemma2-2b's prefill chunk on a local layer, softcap 50
    "prefill chunk, softcap": (1, 64, 272, 8, 4, [128], [192], 4096, 50.0),
    # a 4-slot decode tick: split over the keys
    "decode tick, splits": (4, 1, 272, 8, 4, [137, 64, 250, 9],
                            [138, 65, 251, 10], 0, 50.0),
    # a window that hides the early key tiles
    "window 128": (2, 40, 272, 8, 4, [10, 200], [50, 240], 128, 0.0),
    # a row that sees no key gives zeros
    "kv_len 0": (2, 3, 272, 8, 4, [0, 5], [0, 8], 0, 0.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(HEAD_DIM_256))
def test_flash_attention_head_dim_256_matches_plain(cuda, case):
    b, sq, skv, hq, hkv, q_off, kv_len, window, softcap = HEAD_DIM_256[case]
    q, k, v, qo, kl = _attention_inputs(cuda, b, sq, skv, hq, hkv, 256,
                                        q_off, kv_len)
    kw = dict(window=window, softcap=softcap)
    before = ops.ATTENTION_VARIANT_LAUNCHES[0]
    got = ops.flash_attention(q, k, v, qo, kl, **kw)
    assert ops.ATTENTION_VARIANT_LAUNCHES[0] == before + 1
    _close(got, ref.attention_ref(q, k, v, qo, kl, **kw), **FA_TOL)
    assert torch.equal(ops.flash_attention(q, k, v, qo, kl, **kw), got)
    if 0 in kv_len:
        assert not got[kv_len.index(0)].any()


@pytest.mark.cuda
def test_attention_backward_refuses_head_dim_256(cuda):
    """Head dim 256 is taken now (gemma2-2b trains on the card): the
    backward runs and matches plain; a head dim it has no instance for
    (192) is refused."""
    q, k, v, qo, kl = _attention_inputs(cuda, 1, 4, 4, 2, 2, 256, [0], [4])
    out, lse = ops.flash_attention_lse(q, k, v, qo, kl)
    got = ops.flash_attention_backward(q, k, v, out, q, lse, qo, kl)
    want = ref.attention_bwd_ref(q, k, v, out, q, lse, qo, kl)
    for g, w in zip(got, want):
        assert _rel(g, w) <= BWD_REL
    q, k, v, qo, kl = _attention_inputs(cuda, 1, 4, 4, 2, 2, 192, [0], [4])
    lse = torch.zeros(1, 2, 4, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention_backward(q, k, v, q, q, lse, qo, kl)


#: the decode instance at head dim 256 (``ops.decode_instance``: at most 16
#: rows, q rows x q heads of a GQA group): (b, skv, kv_len) by case; a
#: row's q_offset is its kv_len - 1 (a decode tick), 0 where kv_len is 0
DECODE_256 = {
    "one slot": (1, 272, [200]),
    "serve-gemma's 4 slots": (4, 272, [138, 65, 251, 10]),
    "a long cache, several key tiles a split": (3, 4096, [4000, 70, 2500]),
    "a row with kv_len 0": (3, 272, [0, 140, 272]),
    # 9 x 8 kv heads fill the card unsplit at a group of 1 or 2: one split
    "nine slots": (9, 272, [1, 30, 64, 65, 100, 128, 129, 200, 272]),
}
#: (window, softcap): gemma2-2b's local and global layers, and windows that
#: bite with and without the softcap
DECODE_256_MASKS = [(4096, 50.0), (0, 50.0), (48, 50.0), (48, 0.0), (0, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("window,softcap", DECODE_256_MASKS)
@pytest.mark.parametrize("case", list(DECODE_256))
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_flash_attention_decode_instance_matches_plain(cuda, group, case,
                                                       window, softcap):
    """``flash_decode_kernel`` (four warps over the quarters of each key
    tile, merged in the block, then across the splits) against the plain
    version within ``FA_TOL``; a row that sees no key gives zeros; one
    launch, counted on variant 0; two calls give the same bits."""
    b, skv, kv_len = DECODE_256[case]
    hkv = 8 // group if group < 8 else 2
    hq = hkv * group
    assert ops.decode_instance(1, hq, hkv, 256)
    q_off = [max(0, x - 1) for x in kv_len]
    q, k, v, qo, kl = _attention_inputs(cuda, b, 1, skv, hq, hkv, 256,
                                        q_off, kv_len)
    kw = dict(window=window, softcap=softcap)
    before = ops.ATTENTION_VARIANT_LAUNCHES[0]
    got = ops.flash_attention(q, k, v, qo, kl, **kw)
    assert ops.ATTENTION_VARIANT_LAUNCHES[0] == before + 1
    _close(got, ref.attention_ref(q, k, v, qo, kl, **kw), **FA_TOL)
    assert torch.equal(ops.flash_attention(q, k, v, qo, kl, **kw), got)
    for i, x in enumerate(kv_len):
        if x == 0:
            assert not got[i].any()


@pytest.mark.cuda
@pytest.mark.parametrize("sq,group", [(2, 8), (4, 4), (16, 1)])
def test_flash_attention_decode_instance_takes_16_rows(cuda, sq, group):
    """Sixteen rows (sq x the group) fill the instance's one m16 tile; with
    its log-sum-exp too (a short training call at head dim 256), against
    ``ref.attention_lse_ref``."""
    hkv = 2
    hq = hkv * group
    assert ops.decode_instance(sq, hq, hkv, 256)
    q, k, v, qo, kl = _attention_inputs(cuda, 2, sq, 272, hq, hkv, 256,
                                        [100, 250], [100 + sq, 250 + sq])
    kw = dict(window=48, softcap=30.0)
    got = ops.flash_attention(q, k, v, qo, kl, **kw)
    _close(got, ref.attention_ref(q, k, v, qo, kl, **kw), **FA_TOL)
    out, lse = ops.flash_attention_lse(q, k, v, qo, kl, **kw)
    want, want_lse = ref.attention_lse_ref(q, k, v, qo, kl, **kw)
    _close(out, want, **FA_TOL)
    assert float((lse - want_lse).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_flash_attention_decode_instance_replays_in_a_graph(cuda):
    """Captured in a CUDA graph (its workspace and counters made before
    the capture, on the capture stream), the decode instance replays on
    new q/k/v and kv_len with no host work and matches the plain version
    each time; the arrival counters are clean between replays."""
    b, skv, hq, hkv = 4, 272, 8, 4
    kw = dict(window=0, softcap=50.0)
    q, k, v, qo, kl = _attention_inputs(cuda, b, 1, skv, hq, hkv, 256,
                                        [137, 64, 250, 9], [138, 65, 251, 10])
    stream = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        ops.flash_attention(q, k, v, qo, kl, **kw)
        stream.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            out = ops.flash_attention(q, k, v, qo, kl, **kw)
    for seed, lens in ((5, [10, 272, 1, 100]), (6, [0, 33, 200, 271])):
        q2, k2, v2, qo2, kl2 = _attention_inputs(
            cuda, b, 1, skv, hq, hkv, 256, [max(0, x - 1) for x in lens],
            lens, seed=seed)
        for dst, src in ((q, q2), (k, k2), (v, v2), (qo, qo2), (kl, kl2)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        _close(out, ref.attention_ref(q2, k2, v2, qo2, kl2, **kw), **FA_TOL)
        assert torch.equal(out, ops.flash_attention(q2, k2, v2, qo2, kl2,
                                                    **kw))


GROUP_6 = {  # (b, sq, skv, hq, hkv, q_offset, kv_len): dbrx-132b, d = 128
    # a prefill chunk of 64 rows: 384 rows of the group in 6 row tiles
    "prefill chunk": (1, 64, 320, 48, 8, [192], [256]),
    # a 4-slot decode tick: 6 rows a kv head, split over the keys
    "decode tick": (4, 1, 320, 48, 8, [137, 64, 250, 9], [138, 65, 251, 10]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GROUP_6))
def test_flash_attention_group_of_6_matches_plain(cuda, case):
    """dbrx-132b's 48 q heads on 8 kv heads: a group of 6, which does not
    divide the kernel's 64-row tile."""
    b, sq, skv, hq, hkv, q_off, kv_len = GROUP_6[case]
    q, k, v, qo, kl = _attention_inputs(cuda, b, sq, skv, hq, hkv, 128,
                                        q_off, kv_len)
    before = ops.ATTENTION_VARIANT_LAUNCHES[0]
    got = ops.flash_attention(q, k, v, qo, kl)
    assert ops.ATTENTION_VARIANT_LAUNCHES[0] == before + 1
    _close(got, ref.attention_ref(q, k, v, qo, kl), **FA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("page_dtype", ["int8", "fp8"])
def test_quantized_pages_on_the_card_are_the_cpus(cuda, page_dtype):
    """``append_tokens_q`` then ``gather_pages_q`` on CUDA tensors give the
    pools and the dequantized reads of the same calls on the CPU, bit for
    bit (the fp8 pool scatters and gathers through its bytes)."""
    from repro_torch.models import paging

    gen = torch.Generator().manual_seed(2)
    vals = (torch.randn(2, 7, 4, 128, generator=gen)
            * torch.rand(2, 7, 4, 1, generator=gen) * 20).bfloat16()
    table = torch.tensor([[3, 1, 6, 0], [2, 5, 4, 0]], dtype=torch.int32)
    start = torch.tensor([1, 5], dtype=torch.int32)
    out = {}
    for dev in ("cpu", cuda):
        pages = torch.zeros(8, 4, 4, 128,
                            dtype=paging.page_store_dtype(page_dtype),
                            device=dev)
        scales = torch.zeros(8, 4, 4, dtype=torch.float16, device=dev)
        paging.append_tokens_q(pages, scales, table.to(dev), start.to(dev),
                               vals.to(dev), page_dtype)
        read = paging.gather_pages_q(pages, scales, table.to(dev))
        out[str(dev)] = [t.cpu() for t in (pages, scales, read)]
    for got, want in zip(out[str(cuda)], out["cpu"]):
        if got.dtype == torch.float8_e4m3fn:
            got, want = got.view(torch.uint8), want.view(torch.uint8)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_captured_speculative_step_gives_the_uncaptured_tokens(cuda):
    """llama3-8b at 2 layers with a random MTP head, served speculatively
    through the captured step (two graphs: the prefill chunk (1, 64) and
    the tick (slots, 2)) and through the uncaptured body: identical greedy
    tokens; and one step's tokens and drafts from the graph equal the
    body's on the same inputs and caches."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=2,
                              mtp=True)
    prompts = serve.sample_prompts(cfg, 3, 128, 4)
    scfg = serve.paged_server_config(
        [len(p) for p in prompts], slots=2, prefill_chunk=64, page_size=16,
        max_seq=160, max_new=6, speculate=True)
    server, _ = serve.make_paged_server(
        cfg, scfg, lm.init_params(cfg, seed=4, device=cuda), device=cuda)
    assert server.cfg.speculate
    got = _serve_all(server, prompts)
    step = server.step_fn
    assert step.step.captures == 2
    assert sorted(k[0] for k in step.step.shapes) == [(1, 64), (2, 2)]
    server.step_fn = step.uncaptured()
    assert _serve_all(server, prompts, rid0=100) == got
    # one tick: the graph's tokens and drafts against the body's, from the
    # same caches
    pcfg = scfg.paged
    pages = np.arange(pcfg.pages_per_slot) % (pcfg.num_pages - 1) + 1
    args = (np.array([[5, 9], [7, 3]], np.int32), np.array([16, 40], np.int32),
            np.tile(pages.astype(np.int32), (2, 1)))
    twin = lm.tree_map(lambda t: t.clone(), server.caches)
    toks, drafts, _ = step(*args, server.caches)
    want = step.uncaptured()(*args, twin)
    assert np.array_equal(toks, want[0]) and np.array_equal(drafts, want[1])


# ---------------------------------------------------------------------------
# The MoE segment kind (dbrx-132b) through the kernels.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [64, 4])
def test_moe_block_through_the_kernels_matches_fp32_with_pinned_routes(
        cuda, tokens):
    """One dbrx-132b MoE layer at its widths (16 experts, top-4, 6144 wide,
    d_ff 10752) over a prefill chunk's and a decode tick's tokens: the bf16
    kernels against the fp32 plain path on the CPU from the same weights,
    routed by the card's expert ids (bf16 rounding may flip a choice),
    within the path check's 5e-2 relative L2 a row; every expert's two
    matmuls launched."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.atp import make_context
    from repro_torch.core.mesh import atp_topo
    from repro_torch.models import lm, moe

    cfg = get_config("dbrx-132b")
    gen = torch.Generator(device=cuda).manual_seed(3)
    p = moe.shard_moe(make_context(atp_topo(1, 1, 1), device_type="cpu"),
                      cfg, moe.moe_params(gen, cfg, torch.bfloat16, cuda),
                      lead=0)
    x = torch.randn(1, tokens, cfg.d_model, generator=gen,
                    device=cuda).bfloat16()
    routes = []
    route = moe.route

    def recording(ctx, cfg, router, t):
        out = route(ctx, cfg, router, t)
        routes.append(out[0])
        return out

    def pinned(ctx, cfg, router, t):
        gates = torch.softmax(t.float() @ router, dim=-1)
        v = gates.gather(1, routes[0].cpu())
        return routes[0].cpu(), v / (v.sum(-1, keepdim=True) + 1e-9), \
            route(ctx, cfg, router, t)[2]

    card_ctx = make_context(atp_topo(1, 1, 1), device_type="cuda")
    before = ops.LAUNCHES["matmul"]
    moe.route = recording
    try:
        y, _ = moe.moe_block(card_ctx, cfg, p, x)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["matmul"] == before + 2 * cfg.moe.num_experts
        moe.route = pinned
        want, _ = moe.moe_block(
            make_context(atp_topo(1, 1, 1), device_type="cpu"), cfg,
            lm.tree_map(lambda t: t.cpu().float(), p), x.cpu().float())
    finally:
        moe.route = route
    got = y.float().cpu()[0]
    # a token whose every choice was dropped gives a zero row on both sides
    rel = (got - want[0]).norm(dim=-1) / want[0].norm(dim=-1).clamp_min(
        1e-30)
    assert torch.isfinite(got).all() and float(rel.max()) <= 5e-2, \
        float(rel.max())


@pytest.mark.cuda
def test_paged_append_writes_the_last_value_where_positions_collide(cuda):
    """A decode tick's idle rows all land on the garbage page's position
    0 with values that differ (an MoE layer's capacity makes them differ):
    the pool holds the last row's value, every time, as on the CPU."""
    from repro_torch.models import paging

    gen = torch.Generator(device=cuda).manual_seed(5)
    table = torch.tensor([[1, 2], [0, 0], [0, 0], [0, 0]], dtype=torch.int32,
                         device=cuda)
    start = torch.tensor([9, 0, 0, 0], dtype=torch.int32, device=cuda)
    values = torch.randn(4, 1, 8, 128, generator=gen, device=cuda).bfloat16()
    cpu = paging.append_tokens(torch.zeros(3, 16, 8, 128, dtype=torch.bfloat16),
                               table.cpu(), start.cpu(), values.cpu())
    for _ in range(20):
        pages = paging.append_tokens(
            torch.zeros(3, 16, 8, 128, dtype=torch.bfloat16, device=cuda),
            table, start, values)
        assert torch.equal(pages[0, 0], values[3, 0])
        assert torch.equal(pages[1, 9], values[0, 0])
        assert torch.equal(pages.cpu(), cpu)


# ---------------------------------------------------------------------------
# q/k of head dim 192 with a V of 128 (deepseek-v3's MLA), training
# (``flash_attention_train.cu``'s ``fa_train_dv_kernel``, variant 1) and its
# backward (``flash_attention_bwd.cu``'s ``dkdv_dv_kernel``, ``dq_dv_kernel``);
# and the rmsnorm's rows wider than 4096 (deepseek-v3's 7168), both ways.
# ---------------------------------------------------------------------------

#: (b, s, heads) of each case: deepseek-v3's training shape (128 heads, MHA)
#: and ragged lengths over two batch rows, one ending inside a 128-key tile
#: of the backward
QK192 = {"deepseek s=2048": (1, 2048, 128), "ragged s=1000": (2, 1000, 4),
         "ragged s=200": (2, 200, 4)}
#: the serving kernel's (192, 128) instance (variant 0), cache-free (skv =
#: s): (b, s, heads) of the MTP draft block's tick (4 slots x 2 rows), a
#: 64-row prefill chunk and a ragged 127-row chunk, at deepseek-v3's 128
#: heads
QK192_SERVE = {"draft tick": (4, 2, 128), "chunk s=64": (1, 64, 128),
               "ragged s=127": (1, 127, 128)}


def _qk192_inputs(dev, b, s, h, seed=7):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    q, k, v, do = (randn(b, s, h, 192), randn(b, s, h, 192),
                   randn(b, s, h, 128), randn(b, s, h, 128))
    qo = torch.zeros(b, dtype=torch.int32, device=dev)
    kl = torch.full((b,), s, dtype=torch.int32, device=dev)
    return q, k, v, do, qo, kl


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(QK192))
def test_flash_attention_qk192_v128_matches_plain(cuda, case):
    """One launch of the training kernel (variant 1) with its log-sum-exp:
    the output [b, s, h, 128] against the plain attention and the plain
    mirror of the kernel's order, the log-sum-exp within 1e-3."""
    q, k, v, _, qo, kl = _qk192_inputs(cuda, *QK192[case])
    before = ops.ATTENTION_VARIANT_LAUNCHES[1]
    out, lse = ops.flash_attention_lse(q, k, v, qo, kl)
    assert ops.ATTENTION_VARIANT_LAUNCHES[1] == before + 1
    assert out.shape == v.shape[:3] + (128,)
    want, want_lse = ref.attention_lse_ref(q, k, v, qo, kl)
    _close(out, want, **FA_TOL)
    _close(out, ref.attention_train_ref(q, k, v, qo, kl)[0], **FA_TOL)
    assert float((lse - want_lse).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(QK192))
def test_attention_backward_qk192_v128_matches_plain(cuda, case):
    """dQ and dK [.., 192] and dV [.., 128] from the kernel's O and
    log-sum-exp, one launch counted, against the plain backward."""
    q, k, v, do, qo, kl = _qk192_inputs(cuda, *QK192[case])
    out, lse = ops.flash_attention_lse(q, k, v, qo, kl)
    before = ops.BACKWARD_LAUNCHES["flash_attention_bwd"]
    got = ops.flash_attention_backward(q, k, v, out, do, lse, qo, kl)
    assert ops.BACKWARD_LAUNCHES["flash_attention_bwd"] == before + 1
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    want = ref.attention_bwd_ref(q, k, v, out, do, lse, qo, kl)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= BWD_REL, name
    again = ops.flash_attention_backward(q, k, v, out, do, lse, qo, kl)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
def test_qk192_v128_planted_faults_break_the_checks(cuda):
    """Each check above must catch a wrong answer: the output with V's
    upper 64 columns read as zeros, dK set to zero, dV of the neighbouring
    key."""
    q, k, v, do, qo, kl = _qk192_inputs(cuda, *QK192["ragged s=1000"])
    out, lse = ops.flash_attention_lse(q, k, v, qo, kl)
    v_cut = v.clone()
    v_cut[..., 64:] = 0
    with pytest.raises(AssertionError):
        _close(out, ref.attention_lse_ref(q, k, v_cut, qo, kl)[0], **FA_TOL)
    dq, dk, dv = ops.flash_attention_backward(q, k, v, out, do, lse, qo, kl)
    _, wk, wv = ref.attention_bwd_ref(q, k, v, out, do, lse, qo, kl)
    assert _rel(torch.zeros_like(dk), wk) > BWD_REL
    assert _rel(dv.roll(1, dims=1), wv) > BWD_REL


@pytest.mark.cuda
def test_qk192_v128_refuses_what_it_has_no_instance_for(cuda):
    """Both forward kernels (variant 0 below 128 q rows, variant 1 above)
    refuse a softcap at (192, 128), a V of 192 or 64 beside q/k of 192 is
    not a mode, and variant 0's instance refuses a key split (a cached
    decode row against many keys: no MLA path caches k and v)."""
    for s in (64, 256):
        q, k, v, do, qo, kl = _qk192_inputs(cuda, 1, s, 4)
        assert ops.attention_plan(1, s, 4, 4, s, d=192).variant == \
            (0 if s < 128 else 1)
        with pytest.raises(NotImplementedError, match="softcap"):
            ops.flash_attention(q, k, v, qo, kl, softcap=50.0)
        for dv in (192, 64):
            with pytest.raises(ValueError, match="attention shapes|head dim"):
                ops.flash_attention(q, k, v.new_zeros(v.shape[:3] + (dv,)),
                                    qo, kl)
    q, _, _, _, qo, _ = _qk192_inputs(cuda, 1, 1, 4)
    _, k, v, _, _, _ = _qk192_inputs(cuda, 1, 1024, 4)
    kl = torch.full((1,), 1024, dtype=torch.int32, device=cuda)
    assert ops.attention_plan(1, 1, 4, 4, 1024, d=192).splits > 1
    before = ops.LAUNCHES["flash_attention"]
    with pytest.raises(NotImplementedError, match="key split"):
        ops.flash_attention(q, k, v, qo + 1023, kl)
    assert ops.LAUNCHES["flash_attention"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(QK192_SERVE))
def test_serving_attention_qk192_v128_matches_plain(cuda, case):
    """Variant 0's (192, 128) instance (``flash_kernel<192>``), one launch
    counted under variant 0, with and without its log-sum-exp: the output
    [b, s, h, 128] against the plain attention within the bf16 tolerance,
    the log-sum-exp within 1e-3; a planted fault (V's last 64 columns read
    as zeros) must break the check."""
    q, k, v, _, qo, kl = _qk192_inputs(cuda, *QK192_SERVE[case])
    b, s, h, _ = q.shape
    plan = ops.attention_plan(b, s, h, h, s, d=192)
    assert (plan.variant, plan.splits) == (0, 1)
    before = list(ops.ATTENTION_VARIANT_LAUNCHES)
    out = ops.flash_attention(q, k, v, qo, kl)
    got, lse = ops.flash_attention_lse(q, k, v, qo, kl)
    assert ops.ATTENTION_VARIANT_LAUNCHES == [before[0] + 2, before[1]]
    assert out.shape == (b, s, h, 128) and torch.equal(out, got)
    want, want_lse = ref.attention_lse_ref(q, k, v, qo, kl)
    _close(out, want, **FA_TOL)
    assert float((lse - want_lse).abs().max()) <= 1e-3
    v_cut = v.clone()
    v_cut[..., 64:] = 0
    with pytest.raises(AssertionError):
        _close(out, ref.attention_ref(q, k, v_cut, qo, kl), **FA_TOL)


@pytest.mark.cuda
def test_attention_backward_qk192_v128_merges_many_parts(cuda, monkeypatch):
    """Items of one row tile each at (192, 128): every 128-key tile is
    summed from its partials by its last item, each consumer warpgroup its
    own 64 keys, in item order; two runs give the same bits."""
    monkeypatch.setattr(ops, "BWD_MIN_ITEM", 1)
    monkeypatch.setattr(ops, "BWD_ITEMS_PER_BLOCK", 10 ** 6)
    ops.attention_bwd_plan.cache_clear()
    ops._bwd_items.cache_clear()
    try:
        q, k, v, do, qo, kl = _qk192_inputs(cuda, *QK192["ragged s=1000"])
        out, lse = ops.flash_attention_lse(q, k, v, qo, kl)
        b, s, h, _ = q.shape
        plan = ops.attention_bwd_plan(b, s, h, h, s, d=192, dv=128)
        assert plan.max_len == 1 and plan.slots > 0 and plan.keys == 128
        got = ops.flash_attention_backward(q, k, v, out, do, lse, qo, kl)
        again = ops.flash_attention_backward(q, k, v, out, do, lse, qo, kl)
        want = ref.attention_bwd_ref(q, k, v, out, do, lse, qo, kl)
        for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            assert torch.equal(g, a), name
            assert _rel(g, w) <= BWD_REL, name
    finally:
        ops.attention_bwd_plan.cache_clear()
        ops._bwd_items.cache_clear()


#: rows of the block norm the 8-warp instance takes (up to 8192 wide), and
#: the 4096-wide rows of the earlier instance, unchanged
WIDE_NORMS = [(2048, 7168), (64, 7168), (4, 7168), (37, 8192), (2048, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width", WIDE_NORMS)
def test_rmsnorm_wide_rows_match_plain_both_ways(cuda, rows, width):
    """Forward within the bf16 tolerance, one launch; backward: dx within
    ``RMSNORM_DX_REL`` and dgamma within ``DGAMMA_REL`` relative L2, one
    launch, the same bits twice."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = (torch.randn(rows, width, generator=gen, device=cuda) * 3).bfloat16()
    gamma = torch.rand(width, generator=gen, device=cuda) + 0.5
    dy = torch.randn(rows, width, generator=gen, device=cuda).bfloat16()
    plan = ops.rmsnorm_plan(rows, width)
    assert plan.threads * plan.vectors * 8 >= width
    assert (plan.threads == 256) == (width > 4096)
    before = ops.LAUNCHES["rmsnorm"]
    y = ops.rmsnorm(x, gamma, eps=1e-6)
    assert ops.LAUNCHES["rmsnorm"] == before + 1
    _close(y, ref.rmsnorm_ref(x, gamma, 1e-6), **BF16_TOL)
    before = ops.BACKWARD_LAUNCHES["rmsnorm_bwd"]
    dx, dgamma = ops.rmsnorm_backward(x, gamma, dy, eps=1e-6)
    assert ops.BACKWARD_LAUNCHES["rmsnorm_bwd"] == before + 1
    want_dx, want_dg = ref.rmsnorm_bwd_ref(x, gamma, dy, 1e-6)
    assert _rel(dx, want_dx) <= RMSNORM_DX_REL
    assert _rel(dgamma, want_dg) <= DGAMMA_REL
    dx2, dg2 = ops.rmsnorm_backward(x, gamma, dy, eps=1e-6)
    assert torch.equal(dx2, dx) and torch.equal(dg2, dgamma)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [7168, 8192, 4096, 1536, 512])
def test_rmsnorm_wide_planted_faults_break_the_checks(cuda, width):
    """The norm's checks catch a wrong answer: y of the neighbouring row,
    dx without its mean term (about 1/sqrt(width) of dx, so it takes
    ``RMSNORM_DX_REL``, not ``BWD_REL``), dgamma of half the rows."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    rows = 64
    x = (torch.randn(rows, width, generator=gen, device=cuda) * 3).bfloat16()
    gamma = torch.rand(width, generator=gen, device=cuda) + 0.5
    dy = torch.randn(rows, width, generator=gen, device=cuda).bfloat16()
    y = ops.rmsnorm(x, gamma, eps=1e-6)
    with pytest.raises(AssertionError):
        _close(y.roll(1, dims=0), ref.rmsnorm_ref(x, gamma, 1e-6),
               **BF16_TOL)
    dx, dgamma = ops.rmsnorm_backward(x, gamma, dy, eps=1e-6)
    want_dx, want_dg = ref.rmsnorm_bwd_ref(x, gamma, dy, 1e-6)
    assert _rel(dx, want_dx) <= RMSNORM_DX_REL
    assert _rel(dx.roll(1, dims=0), want_dx) > RMSNORM_DX_REL
    assert _rel(_dx_without_mean_term(x, gamma, dy, 1e-6),
                want_dx) > RMSNORM_DX_REL
    half = ref.rmsnorm_bwd_ref(x[:rows // 2], gamma, dy[:rows // 2], 1e-6)[1]
    assert _rel(half, want_dg) > DGAMMA_REL
    with pytest.raises(ValueError, match="8192"):
        ops.rmsnorm_backward(torch.zeros(2, 8200, device=cuda).bfloat16(),
                             torch.ones(8200, device=cuda),
                             torch.zeros(2, 8200, device=cuda).bfloat16())
