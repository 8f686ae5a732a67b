"""ATP row/column-first tensor-parallel layers (counterpart of
``repro.core.atp``).

Each rank holds local shards and issues its collectives explicitly through
``torch.distributed`` on the process group of one mesh axis:

    column-first GEMM -> boundary all-reduce over mesh dim 2 (f1 / f3)
    row-first GEMM    -> boundary all-reduce over mesh dim 1 (f2 / f4)

Activations between blocks are replicated over tp1 and feature-sharded over
tp2 (local ``[..., d_model/d2]``).  A size-1 axis is ``None`` and its
collectives are skipped.  Ring boundaries, the quantized wire and the
sequence-parallel block I/O are ROADMAP A8.

Autograd follows the JAX package's varying-manual-axes typing.  A value is
either the same on every rank of an axis (invariant) or not (varying), and
the gradient of an invariant value is complete on every rank:
  - ``atp_boundary`` (varying -> invariant) all-reduces forward and passes
    the gradient through unchanged;
  - ``conjugate`` (invariant -> varying, JAX's ``pvary``) is the identity
    forward and all-reduces the gradient.  It sits wherever an invariant
    value meets rank-local work: the input of a column-first GEMM (over
    tp1, whose ranks hold different output columns), the input of a
    row-first GEMM (over tp2), the q/k/v heads before each rank takes its
    own, a norm's statistic before it scales the local features;
  - ``grad_sync`` is ``conjugate`` on a parameter: a replicated parameter
    used on rank-local heads (the qk-norm gains).  A norm scale needs none:
    the conjugate on the column input already completes its gradient, and
    a second reduction would count it d1 times (the JAX package's vma path
    drops its own ``grad_sync`` for the same reason);
  - ``all_gather`` (varying -> invariant) hands each rank its own slice of
    the complete gradient.
Every parameter is replicated over the data-parallel axes; its gradient is
summed over them once, by the optimizer (``optim.adamw``).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core.mesh import MeshTopo, dp_axis_names, tp_axis_names
from repro_torch.kernels import ops, ref

_A8 = "is not ported yet (ROADMAP A8: ring and quantized boundaries)"


@dataclasses.dataclass(frozen=True)
class ATPContext:
    """Static distribution context threaded through all model code, plus the
    process group of each mesh axis this rank belongs to."""

    topo: MeshTopo
    ax1: str | None          # device-mesh dim 1 (size d1)
    ax2: str | None          # device-mesh dim 2 (size d2)
    dp_axes: tuple[str, ...]  # data-parallel axes (pod, data)
    chunks: int = 1           # chunk-based overlapping factor (paper §4.1)
    boundary_mode: Literal["psum", "ring"] = "psum"
    seq_parallel: bool = False
    wire_dtype: str = "bf16"
    #: this rank's coordinate on every mesh axis
    coords: dict = dataclasses.field(default_factory=dict, compare=False)
    #: process group per axis name, plus "tp" for the flat (tp1, tp2) ranks
    groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    def __post_init__(self):
        if self.boundary_mode != "psum":
            raise NotImplementedError(f"boundary_mode={self.boundary_mode!r} {_A8}")
        if self.wire_dtype != "bf16":
            raise NotImplementedError(f"wire_dtype={self.wire_dtype!r} {_A8}")
        if self.seq_parallel:
            raise NotImplementedError(f"seq_parallel {_A8}")
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")

    @property
    def d1(self) -> int:
        return self.topo.axis_size(self.ax1) if self.ax1 else 1

    @property
    def d2(self) -> int:
        return self.topo.axis_size(self.ax2) if self.ax2 else 1

    @property
    def tp(self) -> int:
        return self.d1 * self.d2

    @property
    def dp(self) -> int:
        """Data-parallel degree (the product of the dp axes)."""
        n = 1
        for a in self.dp_axes:
            n *= self.topo.axis_size(a)
        return n

    def dp_index(self) -> int:
        """This rank's flat data-parallel index (first dp axis major)."""
        i = 0
        for a in self.dp_axes:
            i = i * self.topo.axis_size(a) + self.coords.get(a, 0)
        return i

    @property
    def tp_axes(self) -> tuple[str, ...]:
        """Combined TP axes, mesh-dim-1 major (for head sharding)."""
        return tuple(a for a in (self.ax1, self.ax2) if a)

    def index1(self) -> int:
        return self.coords.get(self.ax1, 0) if self.ax1 else 0

    def index2(self) -> int:
        return self.coords.get(self.ax2, 0) if self.ax2 else 0

    def tp_index(self) -> int:
        """Flattened TP rank, mesh-dim-1 major."""
        return self.index1() * self.d2 + self.index2()

    def group(self, axes):
        """The process group of one axis name or of the flat TP axes."""
        if isinstance(axes, str):
            return self.groups[axes]
        axes = tuple(axes)
        if len(axes) == 1:
            return self.groups[axes[0]]
        if axes != self.tp_axes:
            raise ValueError(f"no process group for axes {axes}")
        return self.groups["tp"]


def make_context(topo: MeshTopo, chunks: int = 1,
                 boundary_mode: Literal["psum", "ring"] = "psum",
                 seq_parallel: bool = False, wire_dtype: str = "bf16",
                 *, device_type: str = "cuda") -> ATPContext:
    """Build the execution context on ``topo``.

    A topology of more than one rank needs ``torch.distributed`` initialized
    with ``topo.size`` ranks; the ``DeviceMesh`` over ``device_type`` gives
    each axis's process group, and the flat (tp1, tp2) group is made here.
    Taking a ``ParallelPlan`` comes with ROADMAP A6.
    """
    ax1, ax2 = tp_axis_names(topo)
    mesh = topo.build(device_type)
    coords, groups = {}, {}
    if mesh is not None:
        import torch.distributed as dist

        for name in topo.names:
            groups[name] = mesh.get_group(name)
            # this rank's coordinate on an axis is its rank in that group
            coords[name] = dist.get_rank(groups[name])
        if ax1 and ax2:
            # every rank creates every flat group, in the same order
            tp_size = topo.axis_size(ax1) * topo.axis_size(ax2)
            for start in range(0, topo.size, tp_size):
                ranks = list(range(start, start + tp_size))
                g = dist.new_group(ranks)
                if dist.get_rank() in ranks:
                    groups["tp"] = g
    return ATPContext(topo=topo, ax1=ax1, ax2=ax2, dp_axes=dp_axis_names(topo),
                      chunks=chunks, boundary_mode=boundary_mode,
                      seq_parallel=seq_parallel, wire_dtype=wire_dtype,
                      coords=coords, groups=groups)


# ---------------------------------------------------------------------------
# Collectives.
# ---------------------------------------------------------------------------


def _grad(x: torch.Tensor) -> bool:
    """Whether ``x`` is on an autograd path (else the collectives work in
    place, as serving has them)."""
    return torch.is_grad_enabled() and x.requires_grad


class _Reduce(torch.autograd.Function):
    """All-reduce forward (on a copy), identity backward.  With a list for
    ``works`` the all-reduce is left in flight and its handle appended:
    the caller waits on it before reading the result."""

    @staticmethod
    def forward(ctx, x, group, works=None):
        import torch.distributed as dist

        y = x.clone()
        work = dist.all_reduce(y, group=group, async_op=works is not None)
        if works is not None:
            works.append(work)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Conjugate(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient backward (on a copy:
    autograd may hand the same gradient tensor to other branches)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def atp_boundary(ctx: ATPContext, x: torch.Tensor, axis):
    """Resolve a partial-sum activation: all-reduce over one mesh dim, or
    over the flat TP axes (in place on ``x``, which the caller owns, off
    the autograd path).  Backward: the identity."""
    if not axis:
        return x
    if _grad(x):
        return _Reduce.apply(x, ctx.group(axis))
    import torch.distributed as dist

    dist.all_reduce(x, group=ctx.group(axis))
    return x


def conjugate(ctx: ATPContext, x: torch.Tensor, axis):
    """The boundary's conjugate: identity forward, all-reduce of the
    gradient over ``axis`` (one name or the flat TP axes) backward."""
    if not axis or not _grad(x):
        return x
    return _Conjugate.apply(x, ctx.group(axis))


def grad_sync(ctx: ATPContext, p: torch.Tensor, axes):
    """A replicated parameter at a use site whose gradient is rank-partial
    (identity forward, all-reduce of the gradient over ``axes``).  Exactly
    one reduction: the caller wraps the parameter here and nowhere else."""
    return conjugate(ctx, p, axes)


def all_reduce_max(ctx: ATPContext, x: torch.Tensor, axis: str | None):
    if axis is None:
        return x
    import torch.distributed as dist

    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=ctx.group(axis))
    return x


def all_reduce_min(ctx: ATPContext, x: torch.Tensor, axis: str | None):
    if axis is None:
        return x
    import torch.distributed as dist

    dist.all_reduce(x, op=dist.ReduceOp.MIN, group=ctx.group(axis))
    return x


def _gather(x: torch.Tensor, group, dim: int, tiled: bool):
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim) if tiled else torch.stack(parts)


class _Gather(torch.autograd.Function):
    """All-gather forward; backward, this rank's slice of the complete
    gradient of the gathered (invariant) value."""

    @staticmethod
    def forward(ctx, x, group, dim, tiled):
        import torch.distributed as dist

        ctx.rank, ctx.dim, ctx.tiled = dist.get_rank(group), dim, tiled
        ctx.size = x.shape[dim] if tiled else 0
        return _gather(x, group, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        if ctx.tiled:
            g = g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size)
        else:
            g = g[ctx.rank]
        return g.contiguous(), None, None, None


def all_gather(ctx: ATPContext, x: torch.Tensor, axes, dim: int,
               tiled: bool = True):
    """Gather ``x`` from every rank of ``axes`` (one name or the flat TP
    axes), in group-rank order: concatenated along ``dim`` (tiled) or
    stacked on a new leading dim."""
    if not axes:
        return x if tiled else x.unsqueeze(0)
    group = ctx.group(axes)
    if _grad(x):
        return _Gather.apply(x, group, dim % x.dim() if tiled else 0, tiled)
    return _gather(x, group, dim, tiled)


# ---------------------------------------------------------------------------
# Row/column-first linear layers.
# ---------------------------------------------------------------------------


def _epilogue(y: torch.Tensor, b, activation):
    """Bias then activation after the boundary, in the matmul kernel's
    epilogue order and precision (fp32, cast back)."""
    if b is None and activation is None:
        return y
    return ref.epilogue(y.float(), b, activation).to(y.dtype)


def _chunked_boundary_matmul(ctx: ATPContext, x, w, axis, other, b=None,
                             activation=None):
    """Chunk-based overlapping (paper §4.1): split the leading dim into
    ``ctx.chunks`` chunks (uneven sizes allowed); each chunk's all-reduce is
    issued asynchronously, so the next chunk's GEMM runs under it.  Bias and
    activation follow each chunk's boundary; with no boundary they ride the
    GEMM's fused epilogue.  Backward mirrors it: each chunk's input
    gradient is all-reduced over ``other`` on its own (the conjugate of
    each chunk), in reverse chunk order."""
    c = max(1, min(ctx.chunks, x.shape[0]))
    outs, works = [], []
    for xc in torch.tensor_split(x, c, dim=0):
        xc = conjugate(ctx, xc, other)
        if axis is None:
            outs.append(ops.matmul(xc, w, b, activation=activation))
            continue
        yc = ops.matmul(xc, w)
        if _grad(yc):
            yc = _Reduce.apply(yc, ctx.group(axis), works)
        else:
            import torch.distributed as dist

            works.append(dist.all_reduce(yc, group=ctx.group(axis),
                                         async_op=True))
        outs.append(yc)
    for work in works:
        work.wait()
    if axis is not None:
        outs = [_epilogue(y, b, activation) for y in outs]
    return torch.cat(outs, dim=0)


def atp_linear(ctx: ATPContext, x, w, b=None, *,
               kind: Literal["col", "row"], chunked: bool = True,
               activation: str | None = None):
    """Distributed ``Y = act(XW + b)`` with ATP sharding.

    column-first: W local ``[K/d2, N/d1]``, X local ``[..., K/d2]``; the
        local product is partial over ax2 -> all-reduce(ax2) ->
        ``[..., N/d1]``.
    row-first: W local ``[K/d1, N/d2]``, X local ``[..., K/d1]``; partial
        over ax1 -> all-reduce(ax1) -> ``[..., N/d2]``.

    The bias (sharded like the output dim) and the activation apply after
    the boundary.  With no boundary (the axis is size 1) they are fused into
    the GEMM's epilogue.  The input, the same on every rank of the other
    axis, meets that axis's ranks' different weight shards: its conjugate
    all-reduces the input gradient over it.
    """
    axis = ctx.ax2 if kind == "col" else ctx.ax1
    other = ctx.ax1 if kind == "col" else ctx.ax2
    if chunked and ctx.chunks > 1 and x.dim() >= 2:
        return _chunked_boundary_matmul(ctx, x, w, axis, other, b, activation)
    x = conjugate(ctx, x, other)
    if axis is None:
        return ops.matmul(x, w, b, activation=activation)
    y = atp_boundary(ctx, ops.matmul(x, w), axis)
    return _epilogue(y, b, activation)


def shard_slice(x: torch.Tensor, index: int, nshards: int, dim: int):
    """Local slice of dim ``dim`` into ``nshards`` parts at ``index`` (the
    paper's free 'scatter' of a replicated tensor)."""
    if nshards == 1:
        return x
    size = x.shape[dim] // nshards
    return x.narrow(dim, index * size, size)
