"""Ring and quantized boundary collectives, and collective matmuls
(counterpart of ``repro.core.overlap``).

Every function takes the process group of one mesh axis and the axis name
(or names) the collective record notes it under, and runs on this rank's
local tensors:

  ring_all_reduce_raw / ring_reduce_scatter_raw / ring_all_gather_raw
      d-1 hop rings, one ``batch_isend_irecv`` of one send and one receive
      a hop (the all-reduce bidirectional where its dim splits into 2d:
      the second half circles the other way).  Rank i ends with block i
      (tiled), as ``reduce_scatter_tensor`` and ``all_gather_into_tensor``
      lay it out.  The all-reduce falls back to one monolithic all-reduce
      when no dim divides by the ring size; the scatter raises instead.
  wire_quantize / quant_psum / quant_ring_all_reduce / quant_reduce_scatter
      the shared-scale wire: every rank of the group quantizes with one
      scale (the all-reduced max of the local amax), so the grid values,
      held in f32, sum exactly on any schedule; one ``* scale``
      dequantizes the result.  int8 rounds half to even onto +-127; fp8
      takes the float8 e4m3 grid (amax onto 448).
  overlap_matmul_ar / overlap_matmul_rs
      collective matmuls: chunk k's collective is issued after chunk k+1's
      GEMM, each chunk on its own scale; the reduce-scatter form
      decomposes the GEMM over the ring's hops.  Every GEMM is
      ``ops.matmul``.

``core.atp`` composes the raw forms with :func:`op` (its boundaries'
identity backward, a conjugate's reduction, a gather's reduce-scatter),
and calls ``all_reduce_fn``, ``quant_reduce_scatter``,
``overlap_matmul_ar`` and ``overlap_matmul_rs``.  The differentiable
``ring_all_reduce``, ``quant_psum`` and ``quant_ring_all_reduce`` carry the
reference's mirrored backward (the same collective on the cotangent, a
quantized wire's on the same wire), the per-rank partial-cotangent
convention; they are the forms a measurement of the wire calls on its own
(ROADMAP A7's calibration).  The reference's all-gather matmul has no
caller in the port and is not here.

A ring peer is a global rank (``dist.get_global_rank``).  On NCCL, a group
whose first collective is a ``batch_isend_irecv`` needs every rank of the
group in it; ``core.atp.make_context`` issues one all-reduce on each axis
group of a ring plan first.
"""
from __future__ import annotations

import torch

from repro_torch.analysis import signature as sig
from repro_torch.kernels import ops

#: wire dtypes the boundary collectives understand: "bf16" is the
#: full-width boundary (whatever dtype the activations carry), "int8" and
#: "fp8" the quantized wire
WIRE_DTYPES = ("bf16", "int8", "fp8")

#: symmetric quantization ceilings: the int8 grid is +-127, fp8-e4m3 +-448
_INT8_QMAX = 127.0
_FP8_QMAX = 448.0


def _dist():
    import torch.distributed as dist

    return dist


def _note(op: str, axes, elems: int, dtype) -> None:
    if sig.ACTIVE is not None:
        sig.ACTIVE.note(op, axes, elems, dtype)


class _Op(torch.autograd.Function):
    """``fwd(x)`` forward (None: the identity), ``bwd(g)`` backward (None:
    the identity).  The backward's collectives are noted under the region
    the forward ran in."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd, ctx.region = bwd, sig.current_region()
        y = x if fwd is None else fwd(x)
        return x.view_as(x) if y is x else y

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd is None:
            return g, None, None
        with sig.region(ctx.region):
            return ctx.bwd(g.contiguous()), None, None


def op(x: torch.Tensor, fwd, bwd):
    """``fwd`` forward and ``bwd`` backward (each a function of one tensor,
    None for the identity) where ``x`` is on an autograd path; else
    ``fwd(x)``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Op.apply(x, fwd, bwd)
    return x if fwd is None else fwd(x)


# ---------------------------------------------------------------------------
# Monolithic collectives along any dim (noted by the reference's byte
# conventions: an all-reduce its operand, an all-gather its result, a
# reduce-scatter its operand).
# ---------------------------------------------------------------------------


def all_reduce_(x: torch.Tensor, group, axes) -> torch.Tensor:
    """Sum ``x`` over the group, in place."""
    _note("psum", axes, x.numel(), x.dtype)
    _dist().all_reduce(x, group=group)
    return x


def reduce_scatter(x: torch.Tensor, group, axes, dim: int) -> torch.Tensor:
    """The sum over the group of ``x``, rank i keeping block i of ``dim``."""
    dist = _dist()
    d = dist.get_world_size(group)
    _require_divisible(x.shape[dim], d, "reduce_scatter")
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // d,) + xm.shape[1:])
    _note("reduce_scatter", axes, x.numel(), x.dtype)
    dist.reduce_scatter_tensor(out, xm, group=group)
    return out.movedim(0, dim)


def all_gather(x: torch.Tensor, group, axes, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order."""
    dist = _dist()
    d = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((d * xm.shape[0],) + xm.shape[1:])
    _note("all_gather", axes, out.numel(), x.dtype)
    dist.all_gather_into_tensor(out, xm, group=group)
    return out.movedim(0, dim)


# ---------------------------------------------------------------------------
# Ring plumbing.
# ---------------------------------------------------------------------------


def _ppermute(x: torch.Tensor, group, axes, shift: int) -> torch.Tensor:
    """Send ``x`` to group rank i + shift and receive from i - shift: one
    ``batch_isend_irecv``, noted as one ppermute of its result."""
    dist = _dist()
    d, i = dist.get_world_size(group), dist.get_rank(group)
    send = x.contiguous()
    recv = torch.empty_like(send)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send,
                   dist.get_global_rank(group, (i + shift) % d), group),
        dist.P2POp(dist.irecv, recv,
                   dist.get_global_rank(group, (i - shift) % d), group)])
    for w in works:
        w.wait()
    _note("ppermute", axes, recv.numel(), recv.dtype)
    return recv


def _require_divisible(size: int, d: int, what: str) -> None:
    if size % d:
        raise ValueError(
            f"{what}: scatter dim size {size} must be divisible by the "
            f"ring size {d} (same constraint as a tiled reduce-scatter)")


def _pick_ring_dim(shape, d: int) -> int | None:
    """Largest dimension divisible by the ring size (None if none is)."""
    best, best_size = None, 0
    for i, s in enumerate(shape):
        if s % d == 0 and s > best_size:
            best, best_size = i, s
    return best


def ring_reduce_scatter_raw(x, group, axes, dim: int, reverse: bool = False):
    """Rank i of the ring ends with block i of the sum (tiled layout): the
    accumulator starts at block i - 1, travels to the next rank each hop
    and picks up that rank's matching block."""
    dist = _dist()
    d = dist.get_world_size(group)
    if d == 1:
        return x
    _require_divisible(x.shape[dim], d, "ring_reduce_scatter")
    xs = x.chunk(d, dim)
    idx = dist.get_rank(group)
    sgn = -1 if reverse else 1
    acc = xs[(idx - sgn) % d]
    for t in range(1, d):
        acc = _ppermute(acc, group, axes, sgn)
        acc = acc + xs[(idx - sgn * (1 + t)) % d]
    return acc


def ring_all_gather_raw(x, group, axes, dim: int, reverse: bool = False):
    """Rank i's shard ends in slot i of the concatenation; after t hops the
    payload came from t ranks behind (ahead, reversed)."""
    dist = _dist()
    d = dist.get_world_size(group)
    if d == 1:
        return x
    idx = dist.get_rank(group)
    sgn = -1 if reverse else 1
    buf = [None] * d
    buf[idx] = cur = x
    for t in range(1, d):
        cur = _ppermute(cur, group, axes, sgn)
        buf[(idx - sgn * t) % d] = cur
    return torch.cat(buf, dim=dim)


def ring_all_reduce_raw(x, group, axes, bidirectional: bool = True):
    """Reduce-scatter then all-gather ring; the halves circle opposite ways
    where the dim splits into 2d.  No divisible dim: one all-reduce."""
    d = _dist().get_world_size(group)
    if d == 1:
        return x
    dim = _pick_ring_dim(x.shape, d)
    if dim is None:
        return all_reduce_(x.clone(), group, axes)
    if bidirectional and x.shape[dim] % (2 * d) == 0:
        lo, hi = x.chunk(2, dim)
        lo = ring_reduce_scatter_raw(lo, group, axes, dim)
        hi = ring_reduce_scatter_raw(hi, group, axes, dim, reverse=True)
        lo = ring_all_gather_raw(lo, group, axes, dim)
        hi = ring_all_gather_raw(hi, group, axes, dim, reverse=True)
        return torch.cat([lo, hi], dim=dim)
    y = ring_reduce_scatter_raw(x, group, axes, dim)
    return ring_all_gather_raw(y, group, axes, dim)


def ring_all_reduce(x, group, axes):
    """The sum of ``x`` over the group by a (bidirectional) ring; backward,
    the same ring on the cotangent."""
    def f(t):
        return ring_all_reduce_raw(t, group, axes)
    return op(x, f, f)


# ---------------------------------------------------------------------------
# The quantized wire.
# ---------------------------------------------------------------------------


def wire_quantize(x: torch.Tensor, group, axes, wire_dtype: str):
    """``(q, scale)``: the grid values of ``x`` held in f32, on a scale
    shared by the group (the all-reduced max of the local amax; ``group``
    None: the local amax)."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(
            f"wire_dtype must be one of {WIRE_DTYPES}, got {wire_dtype!r}")
    xf = x.float()
    amax = xf.abs().amax().reshape(1)
    if group is not None:
        _note("pmax", axes, 1, amax.dtype)
        _dist().all_reduce(amax, op=_dist().ReduceOp.MAX, group=group)
    qmax = _FP8_QMAX if wire_dtype == "fp8" else _INT8_QMAX
    scale = torch.clamp_min(amax * reciprocal(qmax, amax.device), 1e-12)
    if wire_dtype == "fp8":
        q = (xf / scale).to(torch.float8_e4m3fn).float()
    else:
        q = torch.clamp(torch.round(xf / scale), -qmax, qmax)
    return q, scale


def reciprocal(c: float, device) -> torch.Tensor:
    """The f32 reciprocal of the constant ``c``: the reference's compiled
    step divides by a constant as a multiplication by it (XLA folds the
    division), so a scale computed this way has the reference's bits."""
    return torch.tensor(1.0 / c, dtype=torch.float32, device=device)


def quant_psum_raw(x, group, axes, wire_dtype, ring: bool = False):
    with sig.quant():
        q, scale = wire_quantize(x, group, axes, wire_dtype)
        y = (ring_all_reduce_raw(q, group, axes) if ring
             else all_reduce_(q, group, axes))
        return (y * scale).to(x.dtype)


def quant_rs_raw(x, group, axes, dim, wire_dtype, ring):
    with sig.quant():
        q, scale = wire_quantize(x, group, axes, wire_dtype)
        y = (ring_reduce_scatter_raw(q, group, axes, dim) if ring
             else reduce_scatter(q, group, axes, dim))
        return (y * scale).to(x.dtype)


def quant_ag_raw(x, group, axes, dim, wire_dtype, ring):
    """All-gather reduces nothing: quantize for the wire, gather the grid
    values, dequantize locally."""
    with sig.quant():
        q, scale = wire_quantize(x, group, axes, wire_dtype)
        g = (ring_all_gather_raw(q, group, axes, dim) if ring
             else all_gather(q, group, axes, dim))
        return (g * scale).to(x.dtype)


def all_reduce_fn(group, axes, wire_dtype: str = "bf16", ring: bool = False):
    """The sum over the group as a function of one tensor, off autograd: a
    ring or one all-reduce (on a copy), on the quantized wire where
    ``wire_dtype`` says so."""
    if wire_dtype != "bf16":
        return lambda t: quant_psum_raw(t, group, axes, wire_dtype, ring)
    if ring:
        return lambda t: ring_all_reduce_raw(t, group, axes)
    return lambda t: all_reduce_(t.clone(), group, axes)


def quant_psum(x, group, axes, wire_dtype: str):
    """~= the sum of ``x`` over the group, its payload on the quantized wire
    (one all-reduce); backward, the same wire on the cotangent (a
    straight-through estimator through the grid)."""
    def f(t):
        return quant_psum_raw(t, group, axes, wire_dtype)
    return op(x, f, f)


def quant_ring_all_reduce(x, group, axes, wire_dtype: str):
    """:func:`quant_psum` over a ring."""
    def f(t):
        return quant_psum_raw(t, group, axes, wire_dtype, ring=True)
    return op(x, f, f)


def quant_reduce_scatter(x, group, axes, dim: int, wire_dtype: str,
                         ring: bool = False):
    """~= ``reduce_scatter`` on the quantized wire (the sequence-parallel
    row boundary under quantization); backward, the all-gather of the
    quantized cotangent."""
    return op(x, lambda t: quant_rs_raw(t, group, axes, dim, wire_dtype,
                                         ring),
              lambda g: quant_ag_raw(g, group, axes, dim, wire_dtype, ring))


# ---------------------------------------------------------------------------
# Collective matmuls.
# ---------------------------------------------------------------------------


def overlap_matmul_ar(x, w, group, axes, chunks: int, b=None,
                      wire_dtype: str = "bf16", ring: bool = True,
                      mirror: bool = True):
    """Chunk-pipelined sum over the group of ``x @ w`` (+ ``b``).  The
    leading dim splits into ``chunks`` (uneven sizes allowed); chunk k's
    collective is issued after chunk k+1's GEMM, a ring (``ring``) or one
    all-reduce, on the quantized wire where ``wire_dtype`` says so, with a
    scale of its own.  ``mirror``: the collectives' backward is the
    mirrored one; else the identity (``core.atp``'s boundary convention,
    whose gradient reduction its conjugate carries)."""
    red = all_reduce_fn(group, axes, wire_dtype, ring)

    def ar(y):
        return op(y, red, red if mirror else None)

    def epilogue(y):
        return y + b if b is not None else y

    if group is None:
        return epilogue(ops.matmul(x, w))
    c = max(1, min(chunks, x.shape[0]))
    ys, pending = [], None
    for xc in torch.tensor_split(x, c, dim=0):
        g = ops.matmul(xc, w)
        if pending is not None:
            ys.append(epilogue(ar(pending)))
        pending = g
    ys.append(epilogue(ar(pending)))
    return ys[0] if c == 1 else torch.cat(ys, dim=0)


def _gemm_wgrad(x, c):
    """``x^T c`` over every leading dim: the weight gradient."""
    return ops.matmul(x.reshape(-1, x.shape[-1]).t(),
                      c.reshape(-1, c.shape[-1]).contiguous())


def _rs_matmul_raw(x, w, group, axes, dim):
    dist = _dist()
    d = dist.get_world_size(group)
    _require_divisible(x.shape[dim], d, "overlap_matmul_rs")
    xs = x.chunk(d, dim)
    idx = dist.get_rank(group)
    acc = ops.matmul(xs[(idx - 1) % d], w)
    for t in range(1, d):
        acc = _ppermute(acc, group, axes, 1)
        acc = acc + ops.matmul(xs[(idx - 1 - t) % d], w)
    return acc


def _ag_two_matmuls(ct, wt, group, axes, dim):
    """The ring all-gather of ``ct`` with both backward GEMMs of the
    reduce-scatter matmul: per arriving block j, ``dx_j = ct_j @ w^T``, and
    the gathered cotangent for the weight gradient.  ``(dx, ct_full)``."""
    dist = _dist()
    d, idx = dist.get_world_size(group), dist.get_rank(group)
    dxs, cts = [None] * d, [None] * d
    dxs[idx], cts[idx] = ops.matmul(ct, wt), ct
    cur = ct
    for t in range(1, d):
        cur = _ppermute(cur, group, axes, 1)
        j = (idx - t) % d
        dxs[j], cts[j] = ops.matmul(cur, wt), cur
    return torch.cat(dxs, dim=dim), torch.cat(cts, dim=dim)


class _RsMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, axes, dim):
        ctx.save_for_backward(x, w)
        ctx.args, ctx.region = (group, axes, dim), sig.current_region()
        return _rs_matmul_raw(x, w, group, axes, dim)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        with sig.region(ctx.region):
            dx, ct_full = _ag_two_matmuls(ct.contiguous(), w.t(), *ctx.args)
        return dx, _gemm_wgrad(x, ct_full), None, None, None


def overlap_matmul_rs(x, w, group, axes, dim: int):
    """``reduce_scatter(x @ w)`` along ``dim``, the GEMM decomposed over the
    ring's hops: hop t computes the block bound t hops downstream and adds
    it to the travelling accumulator.  Backward: the ring all-gather of the
    cotangent with both backward GEMMs per arriving block."""
    if group is None:
        return ops.matmul(x, w)
    return _RsMatmul.apply(x, w, group, axes, dim)
