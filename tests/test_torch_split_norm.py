"""The split RMSNorm of a d2 > 1 mesh on the CPU, in one process.

At d2 > 1 a row's features lie on the tp2 ranks, and ``models.layers.
rms_norm`` runs ``ops.split_rmsnorm``: a partial piece (each slice's row
sums), the all-reduce over tp2, an apply piece, forward and backward.
Here the four plain pieces (``kernels.ref``, what the CPU runs) are held
against the whole-row plain norm and its backward, the slices' row sums
added in one process as the all-reduce adds them: fp32, within 1e-6.  The
gloo meshes of ``test_torch_atp.py``, ``test_torch_train.py`` and
``test_torch_collectives.py`` run the same Function through real
all-reduces.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _randn(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


@pytest.mark.parametrize("width", [1024, 1536, 2048])
@pytest.mark.parametrize("d2", [2, 4])
def test_plain_split_pieces_match_the_whole_row(width, d2):
    """Forward: the slices' sums of squares, added, give each slice's y
    and rstd of the whole row; backward: the slices' dot sums, added, give
    each slice's dx, and the slices' dgamma are the whole row's."""
    rng = np.random.default_rng(width + d2)
    rows, eps = 9, 1e-5
    x, dy = _randn(rng, rows, width, scale=2.0), _randn(rng, rows, width)
    gamma = _randn(rng, width) * 0.2 + 1.0
    w = width // d2
    cut = [slice(i * w, (i + 1) * w) for i in range(d2)]
    ss = sum(ref.rmsnorm_ss_ref(x[:, c]) for c in cut)
    applied = [ref.rmsnorm_apply_ref(x[:, c], gamma[c], ss, width, eps)
               for c in cut]
    torch.testing.assert_close(torch.cat([y for y, _ in applied], -1),
                               ref.rmsnorm_ref(x, gamma, eps), **TOL)
    want_rstd = torch.rsqrt(x.pow(2).mean(-1) + eps)
    for _, rstd in applied:
        torch.testing.assert_close(rstd, want_rstd, **TOL)
    parts = [ref.rmsnorm_bwd_partial_ref(x[:, c], gamma[c], dy[:, c], r)
             for c, (_, r) in zip(cut, applied)]
    dot = sum(d for d, _ in parts)
    dx = torch.cat([ref.rmsnorm_bwd_apply_ref(x[:, c], gamma[c], dy[:, c], r,
                                              dot, width)
                    for c, (_, r) in zip(cut, applied)], -1)
    want_dx, want_dg = ref.rmsnorm_bwd_ref(x, gamma, dy, eps)
    torch.testing.assert_close(dx, want_dx, **TOL)
    torch.testing.assert_close(torch.cat([dg for _, dg in parts], -1),
                               want_dg, **TOL)


def test_split_function_at_one_slice_is_the_whole_row_norm():
    """``ops.split_rmsnorm`` with ``reduce`` the identity (one slice is the
    whole row) against autograd of the plain whole-row norm, forward and
    backward; ``reduce`` sees the fp32 row sums of the forward (sum x^2)
    and of the backward (sum dy gamma x), in place; no launch is counted
    on the CPU."""
    rng = np.random.default_rng(3)
    x, dy = _randn(rng, 2, 5, 64), _randn(rng, 2, 5, 64)
    gamma = _randn(rng, 64) * 0.1 + 1.0
    seen = []
    ops.reset_launches()
    xl, gl = x.clone().requires_grad_(True), gamma.clone().requires_grad_(True)
    y = ops.split_rmsnorm(xl, gl, width=64, eps=1e-6,
                          reduce=lambda t: seen.append(t.clone()))
    got = torch.autograd.grad(y, (xl, gl), dy)
    xw, gw = x.clone().requires_grad_(True), gamma.clone().requires_grad_(True)
    yw = ref.rmsnorm_ref(xw, gw, 1e-6)
    want = torch.autograd.grad(yw, (xw, gw), dy)
    torch.testing.assert_close(y, yw, **TOL)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    assert [t.shape for t in seen] == [(2, 5), (2, 5)]
    torch.testing.assert_close(seen[0], x.pow(2).sum(-1), **TOL)
    torch.testing.assert_close(seen[1], (dy * gamma * x).sum(-1), **TOL)
    with torch.no_grad():   # serving: the forward pieces only
        torch.testing.assert_close(
            ops.split_rmsnorm(x, gamma, width=64, eps=1e-6,
                              reduce=lambda t: None), yw.detach(), **TOL)
    assert set(ops.SPLIT_LAUNCHES) == {"rmsnorm_ss", "rmsnorm_apply",
                                       "rmsnorm_bwd_partial",
                                       "rmsnorm_bwd_apply"}
    assert set(ops.SPLIT_LAUNCHES.values()) == {0}
    assert ops.LAUNCHES == {"matmul": 0, "flash_attention": 0, "rmsnorm": 0,
                            "ssd_scan": 0}


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm_takes_the_split_function_at_d2_above_one(monkeypatch,
                                                           plus_one):
    """``layers.rms_norm`` at d2 = 1 runs the whole-row norm; at d2 = 2
    ``ops.split_rmsnorm`` over rows twice the slice's width, with gamma
    resolved first (gemma's 1 + gamma), and never the whole-row norm."""
    calls = []
    monkeypatch.setattr(ops, "split_rmsnorm", lambda x, g, **kw: calls.append(
        ("split", g, kw)) or x)
    monkeypatch.setattr(ops, "rmsnorm", lambda x, g, **kw: calls.append(
        ("whole", g, kw)) or x)
    x, gamma = torch.ones(3, 16), torch.full((16,), 0.5)
    layers.rms_norm(lm.layout_context(atp_topo(1, 1, 1), 0), x, gamma, 1e-5,
                    plus_one=plus_one)
    layers.rms_norm(lm.layout_context(atp_topo(1, 1, 2), 1), x, gamma, 1e-5,
                    plus_one=plus_one)
    assert [c[0] for c in calls] == ["whole", "split"]
    want_g = gamma + 1.0 if plus_one else gamma
    for _, g, _ in calls:
        torch.testing.assert_close(g, want_g)
    assert calls[1][2]["width"] == 32 and calls[1][2]["eps"] == 1e-5
