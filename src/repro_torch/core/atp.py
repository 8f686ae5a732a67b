"""ATP row/column-first tensor-parallel layers (counterpart of
``repro.core.atp``).

Each rank holds local shards and issues its collectives explicitly through
``torch.distributed`` on the process group of one mesh axis:

    column-first GEMM -> boundary all-reduce over mesh dim 2 (f1 / f3)
    row-first GEMM    -> boundary all-reduce over mesh dim 1 (f2 / f4)

Activations between blocks are replicated over tp1 and feature-sharded over
tp2 (local ``[..., d_model/d2]``).  A size-1 axis is ``None`` and its
collectives are skipped.

The plan's knobs choose how a boundary runs (``repro.core.atp``'s dispatch,
decision for decision): ``boundary_mode="ring"`` makes it a ring of
``batch_isend_irecv`` hops, ``wire_dtype`` "int8"/"fp8" puts its payload on
the shared-scale quantized wire (``core.overlap``), and ``seq_parallel``
gives the dense blocks the sequence-parallel block I/O ``[Shard(seq)@ax1,
Shard(f)@ax2]``: the row boundaries reduce-scatter the sequence over ax1,
the block-entry norms gather it back (``seq_gather``).  The boundaries the
reference runs as plain all-reduces whatever the plan (the fused q/k/v
projection, the Mamba2 in-projections, the norms, the embedding, the loss)
stay plain here too (``atp_linear(plain=True)``, ``atp_boundary``).

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
    used on rank-local heads (the qk-norm gains).  A norm scale needs none
    outside ``seq_parallel``: the conjugate on the column input already
    completes its gradient, and a second reduction would count it d1
    times (the JAX package's vma path drops its own ``grad_sync`` for the
    same reason).  Under ``seq_parallel`` each ax1 rank normalises its own
    tokens, so the scale takes one ``grad_sync`` over ax1;
  - ``all_gather`` (varying -> invariant) hands each rank its own slice of
    the complete gradient.
Under a ring or quantized plan the gradient reductions that mirror its
boundaries ride the same wire, each once:
  - a column-first GEMM's input conjugate over ax1 (the mirror of the row
    boundaries) is a ring, or the quantized wire, on the gradient;
  - the MLP's column-first boundary (f3) carries the conjugate of the
    row-first GEMM that consumes it, as the reference's ring and quantized
    boundaries carry their backward: its backward runs its own ring or
    quantized all-reduce on the cotangent, which is what the reference
    quantizes, and the consumer takes no conjugate;
  - under ``seq_parallel`` a row boundary's reduce-scatter gathers the
    gradient back (a ring, the quantized wire), and the block-entry
    norm's sequence gather reduce-scatters its consumer's partial gradient
    (the conjugate folded in: the column-first GEMM takes none).
The one placement that departs: without ``seq_parallel`` the reference
quantizes the row boundaries' partial cotangent of the residual stream,
whose gradient the port keeps complete; the port quantizes the
column-first inputs' partial gradients (ROADMAP §C).
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
from repro_torch.core import overlap
from repro_torch.core.mesh import MeshTopo, dp_axis_names, tp_axis_names
from repro_torch.core.overlap import WIRE_DTYPES  # noqa: F401 (re-export)
from repro_torch.kernels import ops, ref

#: Segment kinds whose block I/O can run the sequence-parallel spec
#: [Shard(seq)@ax1, Shard(f)@ax2]: their block-entry norms gather the
#: sequence and their row boundaries reduce-scatter it back.  Other kinds'
#: segment views mask ``seq_parallel`` (per-segment gating, not a
#: whole-network error).
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
        """Validate the knobs as the reference does."""
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")
        if self.boundary_mode not in ("psum", "ring"):
            raise ValueError(f"boundary_mode must be 'psum' or 'ring', got "
                             f"{self.boundary_mode!r}")
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"wire_dtype must be one of {WIRE_DTYPES}, got "
                             f"{self.wire_dtype!r}")
        object.__setattr__(self, "segment_plans", tuple(self.segment_plans))

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
    data-parallel axes, the flat (pod, data) group are made here.  A plan
    with a ring anywhere issues one all-reduce on each axis group first:
    on NCCL a group whose first collective is a ``batch_isend_irecv`` needs
    every rank of the group in it, which one hop of a ring is not.
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
    if ctx.any_ring:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if device_type == "cuda" else torch.device(device_type))
        probe = torch.zeros(1, device=dev)
        for name in topo.names:
            dist.all_reduce(probe, group=groups[name])
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
        ctx.region = sig.current_region()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        if sig.ACTIVE is not None:
            sig.ACTIVE.note("psum", ctx.axes, g.numel(), g.dtype,
                            region=ctx.region)
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


def wired(ctx: ATPContext) -> bool:
    """Whether the context's boundaries run a ring or the quantized wire."""
    return ctx.boundary_mode == "ring" or ctx.wire_dtype != "bf16"


def _wire_reduce(ctx: ATPContext, axis: str):
    """The sum over one axis under the context's knobs, as a function of
    one tensor (off autograd)."""
    return overlap.all_reduce_fn(ctx.group(axis), axis, ctx.wire_dtype,
                                 ctx.boundary_mode == "ring")


def conjugate(ctx: ATPContext, x: torch.Tensor, axis, wire: bool = False):
    """The boundary's conjugate: identity forward, all-reduce of the
    gradient over ``axis`` (one name or the flat TP axes) backward.
    ``wire``: that all-reduce runs the context's ring or quantized wire
    (a column-first GEMM's input, the mirror of the row boundaries)."""
    if not axis or not _grad(x):
        return x
    if wire and wired(ctx):
        return overlap.op(x, None, _wire_reduce(ctx, axis))
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


def atp_reduce_scatter(ctx: ATPContext, x: torch.Tensor, axis, dim: int):
    """The sum over ``axis`` of the partial sums ``x`` as one
    reduce-scatter along ``dim`` (this rank keeps its block); backward, the
    all-gather of the blocks' complete gradients."""
    if axis is None:
        return x
    group = ctx.group(axis)
    return overlap.op(x, lambda t: overlap.reduce_scatter(t, group, axis, dim),
                      lambda g: overlap.all_gather(g, group, axis, dim))


# ---------------------------------------------------------------------------
# Sequence-parallel block I/O (spec [Shard(seq)@ax1, Shard(f)@ax2]).
# ---------------------------------------------------------------------------


def seq_scatter(ctx: ATPContext, x: torch.Tensor, dim: int = 1):
    """Free slice of an ax1-replicated activation to this rank's sequence
    shard (entry into the sequence-parallel domain); backward, the
    all-gather of the shards' complete gradients."""
    if not ctx.seq_parallel or ctx.ax1 is None:
        return x
    if x.shape[dim] % ctx.d1:
        raise ValueError(f"seq_parallel requires seq ({x.shape[dim]}) "
                         f"divisible by d1={ctx.d1}")
    group, i, d1 = ctx.group(ctx.ax1), ctx.index1(), ctx.d1
    return overlap.op(x, lambda t: shard_slice(t, i, d1, dim),
                      lambda g: overlap.all_gather(g, group, ctx.ax1, dim))


def seq_gather(ctx: ATPContext, x: torch.Tensor, dim: int = 1,
               reduce_grad: bool = False):
    """All-gather a sequence-sharded activation back to the full sequence
    over ax1 (a ring under ring boundaries).  Backward: this rank's slice of
    the complete gradient; with ``reduce_grad`` the reduce-scatter (a ring
    under ring boundaries) of its consumer's partial gradients, the
    consumer's conjugate folded in (a column-first GEMM's input, the
    head's), as the reference's gather transposes."""
    if not ctx.seq_parallel or ctx.ax1 is None:
        return x
    group, axis = ctx.group(ctx.ax1), ctx.ax1
    if ctx.boundary_mode == "ring":
        def fwd(t):
            return overlap.ring_all_gather_raw(t, group, axis, dim)

        def rs(g):
            return overlap.ring_reduce_scatter_raw(g, group, axis, dim)
    else:
        def fwd(t):
            return overlap.all_gather(t, group, axis, dim)

        def rs(g):
            return overlap.reduce_scatter(g, group, axis, dim)
    if reduce_grad:
        return overlap.op(x, fwd, rs)
    i, n = ctx.index1(), x.shape[dim]
    return overlap.op(x, fwd, lambda g: g.narrow(dim, i * n, n))


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
                             activation=None, wire_conj: bool = False):
    """Chunk-based overlapping (paper §4.1): split the leading dim into
    ``ctx.chunks`` chunks (uneven sizes allowed); each chunk's all-reduce is
    issued asynchronously, so the next chunk's GEMM runs under it.  Bias and
    activation follow each chunk's boundary; with no boundary they ride the
    GEMM's fused epilogue.  Backward mirrors it: each chunk's input
    gradient is all-reduced over ``other`` on its own (the conjugate of
    each chunk, on the context's wire where ``wire_conj``), in reverse
    chunk order."""
    c = max(1, min(ctx.chunks, x.shape[0]))
    outs, works = [], []
    for xc in torch.tensor_split(x, c, dim=0):
        xc = conjugate(ctx, xc, other, wire=wire_conj)
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


def _seq_parallel_row(ctx: ATPContext, x, w, axis: str):
    """The row-first GEMM and its boundary as a reduce-scatter of the
    sequence over ax1: on the quantized wire, as a collective matmul under
    ring boundaries (where the sequence divides), else one reduce-scatter."""
    seq_dim = x.dim() - 2
    group = ctx.group(axis)
    ring = ctx.boundary_mode == "ring" and x.shape[seq_dim] % ctx.d1 == 0
    if ctx.wire_dtype != "bf16":
        return overlap.quant_reduce_scatter(ops.matmul(x, w), group, axis,
                                            seq_dim, ctx.wire_dtype, ring)
    if ring:
        return overlap.overlap_matmul_rs(x, w, group, axis, seq_dim)
    return atp_reduce_scatter(ctx, ops.matmul(x, w), axis, seq_dim)


def atp_linear(ctx: ATPContext, x, w, b=None, *,
               kind: Literal["col", "row"], chunked: bool = True,
               activation: str | None = None, plain: bool = False):
    """Distributed ``Y = act(XW + b)`` with ATP sharding.

    column-first: W local ``[K/d2, N/d1]``, X local ``[..., K/d2]``; the
        local product is partial over ax2 -> all-reduce(ax2) ->
        ``[..., N/d1]``.
    row-first: W local ``[K/d1, N/d2]``, X local ``[..., K/d1]``; partial
        over ax1 -> all-reduce(ax1) -> ``[..., N/d2]``; under
        ``seq_parallel`` a reduce-scatter over ax1 along the sequence dim
        instead, leaving the sequence-parallel block I/O spec.

    The boundary runs the context's knobs, as the reference's
    ``atp_linear`` dispatches them: the sequence-parallel row boundary,
    then the chunked path (``chunks`` > 1), then a ring, the quantized wire
    or one all-reduce; ``plain`` keeps it one all-reduce whatever the knobs
    (what the reference runs as ``atp_boundary``).  The bias (sharded like
    the output dim) and the activation apply after the boundary; with no
    boundary (the axis is size 1) they are fused into the GEMM's epilogue.

    The input, the same on every rank of the other axis, meets that
    axis's ranks' different weight shards: its conjugate all-reduces the
    input gradient over it (a column-first input's on the context's wire;
    under ``seq_parallel`` none, the sequence gather that made the input
    reduce-scatters it).  A column-first GEMM that feeds a row-first one
    is :func:`atp_mlp`, which places that pair's reductions.
    """
    return _linear(ctx, x, w, b, kind=kind, chunked=chunked,
                   activation=activation, plain=plain)


def atp_mlp(ctx: ATPContext, x, w_up, w_down, *,
            activation: str | None = None, hidden=None):
    """The feed-forward pair: the column-first ``x @ w_up`` (f3, with
    ``activation`` after its boundary), ``hidden`` on its output (a gated
    activation; None: the identity), then the row-first ``@ w_down`` (f4).

    The down projection's input gradient is partial over ax2 and is
    reduced once, here decided: under a ring or quantized plan f3 carries
    it (f3's backward runs its own ring or quantized all-reduce on the
    cotangent, the tensor the reference reduces there) and the down
    projection takes no conjugate; else the down projection's conjugate
    all-reduces it.
    """
    carry = wired(ctx)
    y = _linear(ctx, x, w_up, kind="col", activation=activation, carry=carry)
    if hidden is not None:
        y = hidden(y)
    return _linear(ctx, y, w_down, kind="row", conj_input=not carry)


def _linear(ctx: ATPContext, x, w, b=None, *, kind, chunked=True,
            activation=None, plain=False, carry=False, conj_input=True):
    """:func:`atp_linear`.  ``carry``: a column-first boundary on a ring or
    the quantized wire runs the same collective backward on the cotangent
    (its consumer's conjugate); ``conj_input=False``: the input takes no
    conjugate (a ``carry`` boundary made it)."""
    axis = ctx.ax2 if kind == "col" else ctx.ax1
    other = ctx.ax1 if kind == "col" else ctx.ax2
    conj = conj_input and not (kind == "col" and ctx.seq_parallel)
    if (ctx.seq_parallel and kind == "row" and axis is not None
            and x.dim() >= 3):
        x = conjugate(ctx, x, other) if conj else x
        return _epilogue(_seq_parallel_row(ctx, x, w, axis), b, activation)
    wire = wired(ctx) and not plain and axis is not None
    if chunked and ctx.chunks > 1 and x.dim() >= 2 and not wire:
        return _chunked_boundary_matmul(ctx, x, w, axis,
                                        other if conj else None, b,
                                        activation, wire_conj=kind == "col")
    if conj:
        x = conjugate(ctx, x, other, wire=kind == "col")
    if axis is None:
        return ops.matmul(x, w, b, activation=activation)
    if wire and chunked and ctx.chunks > 1 and x.dim() >= 2:
        y = overlap.overlap_matmul_ar(
            x, w, ctx.group(axis), axis, ctx.chunks,
            wire_dtype=ctx.wire_dtype, ring=ctx.boundary_mode == "ring",
            mirror=carry)
    elif wire:
        red = _wire_reduce(ctx, axis)
        y = overlap.op(ops.matmul(x, w), red, red if carry else None)
    else:
        y = atp_boundary(ctx, ops.matmul(x, w), axis)
    return _epilogue(y, b, activation)


def shard_slice(x: torch.Tensor, index: int, nshards: int, dim: int):
    """Local slice of dim ``dim`` into ``nshards`` parts at ``index`` (the
    paper's free 'scatter' of a replicated tensor)."""
    if nshards == 1:
        return x
    size = x.shape[dim] // nshards
    return x.narrow(dim, index * size, size)
