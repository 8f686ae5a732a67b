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

A ``ParallelPlan`` (``core.plan``) reaches the model through
:func:`make_context`: its mesh and its per-segment knobs
(:class:`SegmentPlan`, one view per segment kind through
:meth:`ATPContext.for_segment`).  Every collective issued here is noted on
the installed ``analysis.signature`` record, if any.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.analysis import signature as sig
from repro_torch.core.mesh import MeshTopo, dp_axis_names, tp_axis_names
from repro_torch.kernels import ops, ref

_A8 = "is not ported yet (ROADMAP A8: ring and quantized boundaries)"

#: wire dtypes a plan's ``wire_dtype`` knob names (the reference's
#: ``repro.core.overlap.WIRE_DTYPES``): "bf16" is the full-width boundary,
#: "int8" and "fp8" the quantized wire (ROADMAP A8)
WIRE_DTYPES = ("bf16", "int8", "fp8")

#: Segment kinds whose block I/O can run the sequence-parallel spec
#: [Shard(seq)@ax1, Shard(f)@ax2] in the reference; other kinds' segment
#: views mask ``seq_parallel`` (per-segment gating, not a whole-network
#: error).  The spec itself is ROADMAP A8.
SEQ_PARALLEL_KINDS = frozenset({"dense", "mla_dense"})


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Per-segment execution knobs over the shared (d1, d2, dp) mesh
    (plan format_version 2; ``repro.core.atp.SegmentPlan``).

    One entry per model segment kind: the mesh is global (activation
    layouts must agree at segment boundaries), but chunking, the boundary
    implementation and the sequence-parallel spec belong to each segment's
    communication profile.
    """

    kind: str
    chunks: int = 1
    boundary_mode: str = "psum"
    seq_parallel: bool = False
    #: boundary-collective payload dtype (plan format_version 4): "bf16"
    #: full width, "int8"/"fp8" quantized wire (:data:`WIRE_DTYPES`)
    wire_dtype: str = "bf16"

    def __post_init__(self):
        if self.chunks < 1:
            raise ValueError(
                f"segment {self.kind!r}: chunks must be >= 1, got {self.chunks}")
        if self.boundary_mode not in ("psum", "ring"):
            raise ValueError(
                f"segment {self.kind!r}: boundary_mode must be 'psum' or "
                f"'ring', got {self.boundary_mode!r}")
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(
                f"segment {self.kind!r}: wire_dtype must be one of "
                f"{WIRE_DTYPES}, got {self.wire_dtype!r}")

    def describe(self) -> str:
        sp = "+sp" if self.seq_parallel else ""
        wd = "" if self.wire_dtype == "bf16" else f"@{self.wire_dtype}"
        return f"{self.kind}:ck{self.chunks}{self.boundary_mode}{sp}{wd}"

    def to_dict(self) -> dict:
        return {"kind": self.kind, "chunks": self.chunks,
                "boundary_mode": self.boundary_mode,
                "seq_parallel": self.seq_parallel,
                "wire_dtype": self.wire_dtype}

    @staticmethod
    def from_dict(d) -> "SegmentPlan":
        return SegmentPlan(kind=str(d["kind"]),
                           chunks=int(d.get("chunks", 1)),
                           boundary_mode=d.get("boundary_mode", "psum"),
                           seq_parallel=bool(d.get("seq_parallel", False)),
                           wire_dtype=d.get("wire_dtype", "bf16"))


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Decode-time (serving) knobs of a ParallelPlan (format_version 3;
    ``repro.core.atp.DecodePlan``).

    Decode boundary all-reduces move ``[B, 1, h]`` activations (latency-
    bound, not bandwidth-bound), so the serve objective
    (``core.search.search_strategy_decode``) may pick another (d1, d2) and
    boundary implementation than the train/prefill search did.  ``chunks``
    is pinned to 1; ``seq_parallel`` is absent (a one-token step has no
    sequence to shard).  A server built on the decode mesh is built from
    ``ParallelPlan.decode_view()`` up front (``launch/serve.py``);
    ``launch.steps.resolve_ctx(decode=True)`` applies the knobs that do not
    change the mesh layout.
    """

    d1: int
    d2: int
    boundary_mode: str = "psum"
    chunks: int = 1
    #: boundary wire dtype for decode steps (format_version 4)
    wire_dtype: str = "bf16"
    #: MTP self-speculative decode (format_version 5; ROADMAP A9a)
    speculate: bool = False
    #: copy-on-write prefix sharing at admission (format_version 5;
    #: ROADMAP A9a)
    prefix_cache: bool = False
    #: modelled seconds per generated token behind the choice (provenance)
    predicted_t_step: float | None = None

    def __post_init__(self):
        if self.d1 < 1 or self.d2 < 1:
            raise ValueError(f"decode plan degrees must be >= 1: {self}")
        if self.chunks != 1:
            raise ValueError(
                f"decode plans are chunks=1 by construction (got "
                f"{self.chunks}): one-token boundaries have nothing to "
                f"pipeline and pay alpha per chunk")
        if self.boundary_mode not in ("psum", "ring"):
            raise ValueError(
                f"decode boundary_mode must be 'psum' or 'ring', got "
                f"{self.boundary_mode!r}")
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(
                f"decode wire_dtype must be one of {WIRE_DTYPES}, "
                f"got {self.wire_dtype!r}")

    @property
    def tp(self) -> int:
        return self.d1 * self.d2

    def describe(self) -> str:
        wd = "" if self.wire_dtype == "bf16" else f" @{self.wire_dtype}"
        sp = " +spec" if self.speculate else ""
        pc = " +pfx" if self.prefix_cache else ""
        return f"decode[({self.d1},{self.d2}) {self.boundary_mode}{wd}{sp}{pc}]"

    def to_dict(self) -> dict:
        return {"d1": self.d1, "d2": self.d2,
                "boundary_mode": self.boundary_mode, "chunks": self.chunks,
                "wire_dtype": self.wire_dtype,
                "speculate": self.speculate,
                "prefix_cache": self.prefix_cache,
                "predicted_t_step": self.predicted_t_step}

    @staticmethod
    def from_dict(d) -> "DecodePlan":
        ts = d.get("predicted_t_step")
        return DecodePlan(d1=int(d["d1"]), d2=int(d["d2"]),
                          boundary_mode=d.get("boundary_mode", "psum"),
                          chunks=int(d.get("chunks", 1)),
                          wire_dtype=d.get("wire_dtype", "bf16"),
                          speculate=bool(d.get("speculate", False)),
                          prefix_cache=bool(d.get("prefix_cache", False)),
                          predicted_t_step=(None if ts is None
                                            else float(ts)))


def _check_ported(where: str, boundary_mode: str, wire_dtype: str,
                  seq_parallel: bool) -> None:
    """Raise for a knob the port does not run (ROADMAP A8): it must never
    run as a plain psum boundary instead."""
    if boundary_mode != "psum":
        raise NotImplementedError(
            f"{where}boundary_mode={boundary_mode!r} {_A8}")
    if wire_dtype != "bf16":
        raise NotImplementedError(f"{where}wire_dtype={wire_dtype!r} {_A8}")
    if seq_parallel:
        raise NotImplementedError(f"{where}seq_parallel {_A8}")


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
    #: per-segment knob overrides (plan format_version 2): model code asks
    #: for its segment's view through ``for_segment(kind)``; the scalar
    #: knobs above are the defaults for kinds with no entry of their own
    segment_plans: tuple[SegmentPlan, ...] = ()
    #: this rank's coordinate on every mesh axis
    coords: dict = dataclasses.field(default_factory=dict, compare=False)
    #: process group per axis name, plus "tp" for the flat (tp1, tp2) ranks
    #: and "dp" for the flat (pod, data) ranks
    groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    def __post_init__(self):
        """Validate the knobs as the reference does, then refuse every knob
        the context carries that the port does not run (ROADMAP A8): the
        scalar defaults and each segment's entry, whose ``seq_parallel``
        counts only for the kinds that run it (:data:`SEQ_PARALLEL_KINDS`;
        the others' views mask it)."""
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")
        if self.boundary_mode not in ("psum", "ring"):
            raise ValueError(f"boundary_mode must be 'psum' or 'ring', got "
                             f"{self.boundary_mode!r}")
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"wire_dtype must be one of {WIRE_DTYPES}, got "
                             f"{self.wire_dtype!r}")
        object.__setattr__(self, "segment_plans", tuple(self.segment_plans))
        _check_ported("", self.boundary_mode, self.wire_dtype,
                      self.seq_parallel)
        for seg in self.segment_plans:
            _check_ported(f"segment {seg.kind!r}: ", seg.boundary_mode,
                          seg.wire_dtype,
                          seg.seq_parallel and seg.kind in SEQ_PARALLEL_KINDS)

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

    # -- per-segment views (plan format_version 2) -------------------------

    def for_segment(self, kind: str) -> "ATPContext":
        """This segment kind's view: the same mesh and process groups, the
        segment's own (chunks, boundary_mode, seq_parallel, wire_dtype).

        Falls back to the scalar knobs where the kind has no
        :class:`SegmentPlan` entry (v1 plans broadcast their global knobs
        to every segment), and masks ``seq_parallel`` for kinds outside
        :data:`SEQ_PARALLEL_KINDS`.  The view carries no ``segment_plans``
        of its own."""
        knobs = dict(chunks=self.chunks, boundary_mode=self.boundary_mode,
                     seq_parallel=self.seq_parallel,
                     wire_dtype=self.wire_dtype)
        for seg in self.segment_plans:
            if seg.kind == kind:
                knobs = dict(chunks=seg.chunks,
                             boundary_mode=seg.boundary_mode,
                             seq_parallel=seg.seq_parallel,
                             wire_dtype=seg.wire_dtype)
                break
        if kind not in SEQ_PARALLEL_KINDS:
            knobs["seq_parallel"] = False
        return dataclasses.replace(self, segment_plans=(), **knobs)

    @property
    def any_ring(self) -> bool:
        """True if any segment (or the default knobs) runs ring boundaries."""
        return (self.boundary_mode == "ring"
                or any(s.boundary_mode == "ring" for s in self.segment_plans))

    @property
    def any_seq_parallel(self) -> bool:
        """True if the scalar default or any per-segment entry requests the
        sequence-parallel spec (whether a kind runs it is ``for_segment``'s
        call)."""
        return (self.seq_parallel
                or any(s.seq_parallel for s in self.segment_plans))

    def group(self, axes):
        """The process group of one axis name, of the flat TP axes or of
        the flat data-parallel axes (pod and data)."""
        if isinstance(axes, str):
            return self.groups[axes]
        axes = tuple(axes)
        if len(axes) == 1:
            return self.groups[axes[0]]
        if axes == self.tp_axes:
            return self.groups["tp"]
        if axes == self.dp_axes:
            return self.groups["dp"]
        raise ValueError(f"no process group for axes {axes}")


def make_context(topo: MeshTopo | None = None, chunks: int = 1,
                 boundary_mode: Literal["psum", "ring"] = "psum",
                 seq_parallel: bool = False, wire_dtype: str = "bf16",
                 *, plan=None, device_type: str = "cuda") -> ATPContext:
    """Build the execution context, from loose knobs or a ``ParallelPlan``
    (``repro.core.atp.make_context``).

    ``make_context(plan=p)`` is the canonical path: the plan's topology (or
    an explicitly passed ``topo``) with the plan's chunks, boundary_mode,
    seq_parallel, wire_dtype and per-segment entries.  A plan whose
    (d1, d2) disagrees with the topology's TP axes raises: the searched
    strategy and the executed mesh must be the same artifact.  Neither a
    topology nor a plan raises ``TypeError``.

    A topology of more than one rank needs ``torch.distributed`` initialized
    with ``topo.size`` ranks; the ``DeviceMesh`` over ``device_type`` gives
    each axis's process group, and the flat (tp1, tp2) group and, with two
    data-parallel axes, the flat (pod, data) group are made here.
    """
    segment_plans: tuple[SegmentPlan, ...] = ()
    if plan is not None:
        if topo is None:
            topo = plan.topo()
        chunks = plan.chunks
        boundary_mode = plan.boundary_mode
        seq_parallel = plan.seq_parallel
        wire_dtype = plan.wire_dtype
        segment_plans = tuple(plan.segments)
    if topo is None:
        raise TypeError("make_context needs a MeshTopo or a plan")
    ax1, ax2 = tp_axis_names(topo)
    # validates the knobs before any process group exists
    ctx = ATPContext(topo=topo, ax1=ax1, ax2=ax2, dp_axes=dp_axis_names(topo),
                     chunks=chunks, boundary_mode=boundary_mode,
                     seq_parallel=seq_parallel, wire_dtype=wire_dtype,
                     segment_plans=segment_plans)
    if plan is not None and (ctx.d1, ctx.d2) != (plan.d1, plan.d2):
        raise ValueError(
            f"plan/topology mismatch: plan prescribes DeviceMesh"
            f"({plan.d1},{plan.d2}) but mesh TP axes give "
            f"({ctx.d1},{ctx.d2}) on {topo.axes}")
    mesh = topo.build(device_type)
    if mesh is None:
        return ctx
    import torch.distributed as dist

    coords, groups = {}, {}
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
    if len(ctx.dp_axes) > 1:
        # the ranks that share every other coordinate, in ``dp_index``
        # order (pod major: the reference's tiled reduction over (pod,
        # data)); every rank creates every such group, in the same order
        rest = [a for a in topo.names if a not in ctx.dp_axes]
        by_rest: dict[tuple, list[int]] = {}
        for r in range(topo.size):
            c = topo.coords(r)
            by_rest.setdefault(tuple(c[a] for a in rest), []).append(r)
        for ranks in by_rest.values():
            g = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                groups["dp"] = g
    return dataclasses.replace(ctx, coords=coords, groups=groups)


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
    def forward(ctx, x, group, axes, works=None):
        import torch.distributed as dist

        y = x.clone()
        if sig.ACTIVE is not None:
            sig.ACTIVE.note("psum", axes, y.numel(), y.dtype)
        work = dist.all_reduce(y, group=group, async_op=works is not None)
        if works is not None:
            works.append(work)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _Conjugate(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient backward (on a copy:
    autograd may hand the same gradient tensor to other branches)."""

    @staticmethod
    def forward(ctx, x, group, axes):
        ctx.group, ctx.axes = group, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        if sig.ACTIVE is not None:
            sig.ACTIVE.note("psum", ctx.axes, g.numel(), g.dtype)
        dist.all_reduce(g, group=ctx.group)
        return g, None, None


def atp_boundary(ctx: ATPContext, x: torch.Tensor, axis):
    """Resolve a partial-sum activation: all-reduce over one mesh dim, or
    over the flat TP axes (in place on ``x``, which the caller owns, off
    the autograd path).  Backward: the identity."""
    if not axis:
        return x
    if _grad(x):
        return _Reduce.apply(x, ctx.group(axis), axis)
    import torch.distributed as dist

    if sig.ACTIVE is not None:
        sig.ACTIVE.note("psum", axis, x.numel(), x.dtype)
    dist.all_reduce(x, group=ctx.group(axis))
    return x


def conjugate(ctx: ATPContext, x: torch.Tensor, axis):
    """The boundary's conjugate: identity forward, all-reduce of the
    gradient over ``axis`` (one name or the flat TP axes) backward."""
    if not axis or not _grad(x):
        return x
    return _Conjugate.apply(x, ctx.group(axis), axis)


def grad_sync(ctx: ATPContext, p: torch.Tensor, axes):
    """A replicated parameter at a use site whose gradient is rank-partial
    (identity forward, all-reduce of the gradient over ``axes``).  Exactly
    one reduction: the caller wraps the parameter here and nowhere else."""
    return conjugate(ctx, p, axes)


def _extreme(ctx: ATPContext, x: torch.Tensor, axis: str | None, op: str):
    if axis is None:
        return x
    import torch.distributed as dist

    if sig.ACTIVE is not None:
        sig.ACTIVE.note(op, axis, x.numel(), x.dtype)
    reduce_op = dist.ReduceOp.MAX if op == "pmax" else dist.ReduceOp.MIN
    dist.all_reduce(x, op=reduce_op, group=ctx.group(axis))
    return x


def all_reduce_max(ctx: ATPContext, x: torch.Tensor, axis: str | None):
    return _extreme(ctx, x, axis, "pmax")


def all_reduce_min(ctx: ATPContext, x: torch.Tensor, axis: str | None):
    return _extreme(ctx, x, axis, "pmin")


def _gather(x: torch.Tensor, group, axes, dim: int, tiled: bool):
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if sig.ACTIVE is not None:
        sig.ACTIVE.note("all_gather", axes, n * x.numel(), x.dtype)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim) if tiled else torch.stack(parts)


class _Gather(torch.autograd.Function):
    """All-gather forward; backward, this rank's slice of the complete
    gradient of the gathered (invariant) value."""

    @staticmethod
    def forward(ctx, x, group, axes, dim, tiled):
        import torch.distributed as dist

        ctx.rank, ctx.dim, ctx.tiled = dist.get_rank(group), dim, tiled
        ctx.size = x.shape[dim] if tiled else 0
        return _gather(x, group, axes, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        if ctx.tiled:
            g = g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size)
        else:
            g = g[ctx.rank]
        return g.contiguous(), None, None, None, None


def all_gather(ctx: ATPContext, x: torch.Tensor, axes, dim: int,
               tiled: bool = True):
    """Gather ``x`` from every rank of ``axes`` (one name or the flat TP
    axes), in group-rank order: concatenated along ``dim`` (tiled) or
    stacked on a new leading dim."""
    if not axes:
        return x if tiled else x.unsqueeze(0)
    group = ctx.group(axes)
    if _grad(x):
        return _Gather.apply(x, group, axes, dim % x.dim() if tiled else 0,
                             tiled)
    return _gather(x, group, axes, dim, tiled)


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
            yc = _Reduce.apply(yc, ctx.group(axis), axis, works)
        else:
            import torch.distributed as dist

            if sig.ACTIVE is not None:
                sig.ACTIVE.note("psum", axis, yc.numel(), yc.dtype)
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
