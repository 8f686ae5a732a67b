"""Each hand-written kernel against its plain version, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX (the machine with the card has none), so run it there
without the suite's JAX conftest:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are bf16's: the output is rounded to bf16 (relative spacing
2^-8), so |kernel - plain| <= atol + rtol * |plain| allows about two units
in the last place at |x| ~ 1.
"""
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


@pytest.mark.cuda
@pytest.mark.parametrize("d,hq,hkv,window,softcap", [(128, 32, 8, 0, 0.0),
                                                     (64, 16, 16, 48, 30.0)])
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
    # the kernel keeps fp32 probabilities where the plain version rounds
    # them to bf16 before the PV product
    _close(got, ref.attention_ref(q, k, v, qo, kl, **kw), atol=2e-2,
           rtol=2e-2)


@pytest.mark.cuda
def test_rmsnorm_kernel_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(37, 4096, generator=gen, device=cuda).bfloat16()
    g = torch.randn(4096, generator=gen, device=cuda)
    before = ops.LAUNCHES["rmsnorm"]
    got = ops.rmsnorm(x, g, eps=1e-5)
    assert ops.LAUNCHES["rmsnorm"] == before + 1
    _close(got, ref.rmsnorm_ref(x, g, 1e-5), **BF16_TOL)
