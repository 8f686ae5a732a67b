"""The chunk-parallel SSD backward and the token-major grouped norm
backward, checked on the CPU.

``csrc/ssd_scan_bwd.cu`` splits the SSD scan's backward into per-chunk
increments, two linear recurrences between chunks (the states forwards,
their gradients backwards) and per-chunk gradients that need nothing but
their chunk's state and state gradient.  ``chunk_parallel_bwd`` below
writes that decomposition out in plain torch (fp32); it is held against
``ref.ssd_bwd_ref`` and both against ``jax.vjp`` of the reference's
``mamba2.ssd_chunked`` on the same numpy-made inputs, the final state's
cotangent zero, everything in fp32 (the reference casts to fp32 itself).
Tolerance: 1e-5 of each tensor's largest magnitude.  Only the order of
summation differs, and an element of dA_log or ddt sums terms of both
signs far larger than itself, so fp32's rounding scales with the tensor,
not the element: elementwise, two orders differ by up to 1.2e-5 of the
element on these inputs, in float64 as in fp32 on the torch side.

The launch plans of the two kernels (``ops.ssd_bwd_plan``,
``ops.group_rmsnorm_bwd_plan``) are plain Python: every head and token
is covered once, and the grids at zamba2-7b's training shape are pinned.
``test_torch_cuda.py`` holds the kernels themselves on the card.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import mamba2 as jax_mamba2  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

#: the largest error allowed, as a share of the tensor's largest magnitude
REL = 1e-5


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (what, err, np.abs(want).max())


def chunk_parallel_bwd(x, dt, A_log, B, C, D, dy, chunks):
    """The SSD scan's backward from a zero state (final state dropped) as
    the CUDA kernel orders it, over the (start, length) ``chunks``:

    1. per chunk, independently: ``la_end``, the state increment
       ``Delta = sum_u (x_u wv_u) B_u^T`` and the gradient increment
       ``Gamma = sum_t (dy_t G_t) C_t^T``;
    2. the states entering each chunk, ``S_{c+1} = exp(la_end_c) S_c +
       Delta_c`` from zero, and the gradients of the states leaving each,
       ``dS_{c-1} = exp(la_end_c) dS_c + Gamma_c`` from zero;
    3. per chunk, independently, every gradient from its S and dS; dB and
       dC summed over heads, dA and dD over chunks.

    Returns (dx, ddt, dA_log, dB, dC, dD) in fp32."""
    b, s, nh, hd = x.shape
    A = -torch.exp(A_log)
    per_chunk = []
    for c0, cl in chunks:
        sl = slice(c0, c0 + cl)
        la = torch.cumsum(dt[:, sl] * A, 1)                     # [b, t, h]
        wv = torch.exp(la[:, -1:] - la) * dt[:, sl]
        G = torch.exp(la)
        per_chunk.append((
            la[:, -1],
            torch.einsum("buhp,bun->bhpn", x[:, sl] * wv[..., None], B[:, sl]),
            torch.einsum("bthp,btn->bhpn", dy[:, sl] * G[..., None], C[:, sl])))
    nc = len(chunks)
    S, dS = [None] * nc, [None] * nc
    run = torch.zeros_like(per_chunk[0][1])
    for c in range(nc):
        S[c] = run
        run = torch.exp(per_chunk[c][0])[..., None, None] * run + per_chunk[c][1]
    run = torch.zeros_like(run)
    for c in reversed(range(nc)):
        dS[c] = run
        run = torch.exp(per_chunk[c][0])[..., None, None] * run + per_chunk[c][2]

    dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
    dB, dC = torch.zeros_like(B), torch.zeros_like(C)
    dA_parts, dD_parts = [], []
    for (c0, cl), Sc, dSc in zip(chunks, S, dS):
        sl = slice(c0, c0 + cl)
        xc, dtc, Bc, Cc, dyc = x[:, sl], dt[:, sl], B[:, sl], C[:, sl], dy[:, sl]
        la = torch.cumsum(dtc * A, 1)
        la_end = la[:, -1]
        G = torch.exp(la)
        wv = torch.exp(la_end[:, None] - la) * dtc
        causal = torch.ones(cl, cl, dtype=torch.bool).tril()
        decay = torch.where(causal[None, :, :, None],
                            torch.exp(la[:, :, None] - la[:, None]),
                            torch.zeros(()))                    # [b, t, u, h]
        cb = torch.einsum("btn,bun->btu", Cc, Bc)
        M = torch.einsum("bthp,buhp->btuh", dyc, xc)
        W = cb[..., None] * decay * dtc[:, None]
        Z = M * decay * dtc[:, None]
        Q = cb[..., None] * decay * M
        dx[:, sl] = (torch.einsum("btuh,bthp->buhp", W, dyc)
                     + D[None, None, :, None] * dyc
                     + wv[..., None] * torch.einsum("bhpn,bun->buhp", dSc, Bc))
        YS = torch.einsum("bthp,bhpn->bthn", dyc, Sc)
        XdS = torch.einsum("buhp,bhpn->buhn", xc, dSc)
        dC[:, sl] = (torch.einsum("btuh,bun->btn", Z, Bc)
                     + torch.einsum("bth,bthn->btn", G, YS))
        dB[:, sl] = (torch.einsum("btuh,btn->bun", Z, Cc)
                     + torch.einsum("buh,buhn->bun", wv, XdS))
        r = torch.einsum("buhn,bun->buh", XdS, Bc)
        c = G * torch.einsum("bthn,btn->bth", YS, Cc)
        colQ = Q.sum(1)
        dla = (Q * dtc[:, None]).sum(2) - colQ * dtc + c - wv * r
        dla[:, -1] += (torch.exp(la_end) * (dSc * Sc).sum((-1, -2))
                       + (wv * r).sum(1))
        da = torch.flip(torch.cumsum(torch.flip(dla, [1]), 1), [1])
        ddt[:, sl] = colQ + torch.exp(la_end[:, None] - la) * r + A * da
        dA_parts.append((dtc * da).sum(1))                      # [b, h]
        dD_parts.append((dyc * xc).sum((1, 3)))
    dA = torch.stack(dA_parts).sum((0, 1))
    dD = torch.stack(dD_parts).sum((0, 1))
    return dx, ddt, A * dA, dB, dC, dD


def _inputs(s, seed=11, b=2, nh=3, hd=4, ds=5):
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x, B, C, dy = (randn(b, s, nh, hd), randn(b, s, ds), randn(b, s, ds),
                   randn(b, s, nh, hd))
    dt = np.log1p(np.exp(randn(b, s, nh)))                      # softplus
    A_log, D = randn(nh, scale=0.5), randn(nh)
    return x, dt, A_log, B, C, D, dy


NAMES = ("dx", "ddt", "dA_log", "dB", "dC", "dD")


@pytest.mark.parametrize("s,chunk,jax_rule", [
    (32, 32, True),    # one chunk: no state crosses
    (64, 16, True),    # four chunks of 16
    (40, 16, True),    # two chunks of 20 (mamba2.ssd_chunked's rule)
    (37, 16, False),   # the kernel's rule: 16, 16 and a ragged 5
])
def test_chunk_parallel_backward_matches_plain_and_jax(s, chunk, jax_rule):
    """The kernel's decomposition against ``ref.ssd_bwd_ref`` on the same
    chunks, and both against ``jax.vjp`` of ``mamba2.ssd_chunked`` (where
    that function takes ``s``) with a zero cotangent for the final
    state."""
    args = _inputs(s)
    t = [torch.from_numpy(a) for a in args]
    want = ref.ssd_bwd_ref(*t, chunk)
    got = chunk_parallel_bwd(*t, ref._ssd_chunks(s, chunk))
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, f"{name}: decomposition vs ssd_bwd_ref")
    if not jax_rule:
        return
    x, dt, A_log, B, C, D, dy = map(jnp.asarray, args)
    (_, state), vjp = jax.vjp(
        lambda *p: jax_mamba2.ssd_chunked(*p, chunk), x, dt, A_log, B, C, D)
    jgrads = vjp((dy, jnp.zeros_like(state)))
    for name, g, w, j in zip(NAMES, got, want, jgrads):
        _close(g, j, f"{name}: decomposition vs jax")
        _close(w, j, f"{name}: ssd_bwd_ref vs jax")


SSD_BWD = [  # (b, s, nh, chunk): zamba2-7b's training shape at 1 and 2 rows,
    # a one-position last chunk, heads that no group size divides, then odd
    # shapes
    (1, 2048, 112, 64), (2, 2048, 112, 64), (1, 65, 13, 64), (3, 100, 13, 16),
    (1, 1, 1, 64), (2, 50, 4, 16), (1, 128, 56, 64), (5, 7, 300, 4)]


@pytest.mark.parametrize("b,s,nh,chunk", SSD_BWD)
def test_ssd_bwd_plan_covers_each_row_chunk_and_head_once(b, s, nh, chunk):
    """Every (batch row, chunk, head) falls in exactly one block, in the
    kernels' grid order; a block takes at most the kernel's 8 heads."""
    plan = ops.ssd_bwd_plan(b, s, nh, chunk)
    assert plan.heads in ops.SSD_BWD_HEADS and plan.nc == -(-s // chunk)
    seen = collections.Counter()
    blocks = list(plan.block_heads())
    for bi, c, h0, h1 in blocks:
        assert 0 <= h0 < h1 <= nh and h1 - h0 <= plan.heads
        seen.update((bi, c, h) for h in range(h0, h1))
    assert len(blocks) == plan.blocks == b * plan.nc * plan.groups
    assert len(seen) == b * plan.nc * nh and set(seen.values()) == {1}


def test_ssd_bwd_plan_at_the_training_shape():
    """zamba2-7b's step (b = 1, s = 2048, 112 heads, chunk 64): 8 heads a
    block, 14 groups, 448 blocks, so the fp32 partial rows of dB and dC
    are an eighth of one per head; fewer chunks or heads take fewer heads
    a block until every SM has its blocks."""
    plan = ops.ssd_bwd_plan(1, 2048, 112, 64)
    assert (plan.heads, plan.groups, plan.blocks) == (8, 14, 448)
    assert ops.ssd_bwd_plan(2, 2048, 112, 64).heads == 8
    assert ops.ssd_bwd_plan(1, 1024, 112, 64).heads == 4
    assert ops.ssd_bwd_plan(1, 128, 112, 64).heads == 1
    for b, s, nh, chunk in SSD_BWD:
        plan = ops.ssd_bwd_plan(b, s, nh, chunk)
        assert (plan.heads == 1
                or plan.blocks >= ops.SSD_BWD_BLOCKS_PER_SM * ops.SMS)


GROUP_BWD = [  # (tokens, groups, width): zamba2-7b's training step, a
    # serving chunk, then odd shapes (uneven shares, narrow and odd widths)
    (2048, 112, 64), (64, 112, 64), (1000, 112, 64), (5, 3, 64), (33, 4, 32),
    (300, 40, 24), (7, 256, 8), (1, 1, 64), (4097, 200, 40)]


@pytest.mark.parametrize("tokens,groups,width", GROUP_BWD)
def test_group_bwd_plan_covers_each_token_and_column_once(tokens, groups,
                                                          width):
    """Each token falls in exactly one share, each (group, 8-column slice)
    of a row in exactly one thread's slots; the block is whole warps
    within the kernel's thread limit, its slots a variant it has."""
    plan = ops.group_rmsnorm_bwd_plan(tokens, groups, width)
    assert plan.vectors in ops.GROUP_BWD_VECTORS
    assert plan.threads % 32 == 0 and plan.threads <= ops.GROUP_BWD_MAX_THREADS
    toks = collections.Counter(t for i in range(plan.shares)
                               for t in plan.token_range(i))
    assert sorted(toks) == list(range(tokens)) and set(toks.values()) == {1}
    cols = collections.Counter(c for j in range(plan.threads)
                               for c in plan.thread_columns(j))
    assert sorted(cols) == [(g, c) for g in range(groups)
                            for c in range(0, width, 8)]
    assert set(cols.values()) == {1}
    sizes = {len(plan.token_range(i)) for i in range(plan.shares)}
    assert max(sizes) - min(sizes) <= 1


def test_group_bwd_plan_at_the_training_shape():
    """2048 tokens x 112 groups of 64: 224 threads of 4 slots (a row's 896
    16-byte slices, none idle), 264 shares of 7 or 8 tokens; past 256
    groups the kernel takes no row."""
    plan = ops.group_rmsnorm_bwd_plan(2048, 112, 64)
    assert (plan.threads, plan.vectors, plan.shares) == (224, 4, 264)
    assert {len(plan.token_range(i)) for i in range(plan.shares)} == {7, 8}
    assert ops.group_rmsnorm_bwd_plan(3, 112, 64).shares == 3
    with pytest.raises(ValueError, match="256 groups"):
        ops.group_rmsnorm_bwd_plan(8, 257, 64)
