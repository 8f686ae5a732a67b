"""The port's collective record (counterpart of ``repro.analysis.signature``).

The JAX package reads a step's collectives out of its jaxpr.  PyTorch has no
jaxpr, so the port records them where they are issued: every collective of
the model path goes through ``core.atp`` (and the optimizer's through
``optim.adamw``), and each issue site notes one entry on the installed
:class:`Record` when there is one::

    with recording("fwd") as fwd:
        loss = lm.train_loss(ctx, cfg, params, batch)
    with recording("bwd") as bwd:
        grads = torch.autograd.grad(loss, leaves)
    fwd.by_key()   # {(region, op, axes, quant): (count, raw_bytes)}

An entry is (region, phase, op, axes, elems, dtype).  ``op`` takes the
reference's names: ``psum`` (a sum all-reduce), ``pmax``, ``pmin``,
``all_gather``, ``reduce_scatter`` and ``all_to_all``.  ``elems`` follows
the byte conventions of ``repro.analysis.expect``: an all-reduce counts
its operand's elements, an all-gather and a ppermute (one ring hop,
``core.overlap``) their result's, a reduce-scatter and an all-to-all (the
MoE dispatch) its operand's.  Inside :func:`quant` (the
reference's ``quant[axis]`` scope) every entry is marked quantized: the
shared-scale ``pmax`` and the payload's collective, whose grid values are
held, and noted, in f32.  The
region is the innermost :func:`region` open when the collective is issued:
``models.lm`` opens the reference's scope names (``shell:embed``,
``seg{i}:{kind}``, ``shell:exit``, ``shell:head``, ``shell:loss``;
``launch.steps``' greedy pick ``shell:pick``); the optimizer's collectives
carry ``opt:*`` regions of their own.  Under ``torch.utils.checkpoint`` a
block's recompute runs in the backward, so it lands in the phase that is
recording then.

The installed record is one per process (:data:`ACTIVE`), not an argument:
the issue sites sit deep in the model code, under signatures the record
would otherwise have to cross.  Only :func:`recording` sets it, and puts
back what it found.  With no record installed the cost at an issue site is
one ``is None`` check on :data:`ACTIVE`: no tensor op, no host sync,
nothing else.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

#: the record collectives are noted on, or None (the default: nothing is
#: recorded)
ACTIVE: "Record | None" = None

#: ops the issue sites note (the reference's primitive names)
OPS = ("psum", "pmax", "pmin", "all_gather", "reduce_scatter", "ppermute",
       "all_to_all")

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int32": 4,
                "int64": 8, "float64": 8}


@dataclasses.dataclass(frozen=True)
class Entry:
    """One issued collective."""

    region: str
    phase: str
    op: str
    axes: tuple[str, ...]
    elems: int
    dtype: str
    quant: bool = False

    @property
    def raw_bytes(self) -> int:
        """Payload bytes at the dtype the payload is held in."""
        return self.elems * _DTYPE_BYTES[self.dtype]


def dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"``, the reference's dtype names."""
    return str(dtype).rsplit(".", 1)[-1]


class Record:
    """The collectives issued while this record was installed, in order."""

    def __init__(self):
        self.entries: list[Entry] = []
        self.phase = "fwd"
        self.region = ""
        self.quant = False

    def note(self, op: str, axes, elems: int, dtype, region: str | None = None):
        """Append one entry: ``axes`` one mesh axis name or a tuple of them,
        ``elems`` by the conventions above, ``dtype`` a torch dtype."""
        if op not in OPS:
            raise ValueError(f"unknown collective op {op!r}")
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        self.entries.append(Entry(
            region=self.region if region is None else region,
            phase=self.phase, op=op, axes=axes, elems=int(elems),
            dtype=dtype_name(dtype), quant=self.quant))

    def by_key(self, phase: str | None = "fwd") -> dict:
        """``{(region, op, axes, quant): (count, raw_bytes)}`` over the
        entries of ``phase`` (None: every phase), the shape of the
        reference's ``Expectation.by_key()`` without its bytes-known flag."""
        agg: dict[tuple, list[int]] = defaultdict(lambda: [0, 0])
        for e in self.entries:
            if phase is not None and e.phase != phase:
                continue
            a = agg[(e.region, e.op, e.axes, e.quant)]
            a[0] += 1
            a[1] += e.raw_bytes
        return {k: (v[0], v[1]) for k, v in agg.items()}


@contextlib.contextmanager
def recording(phase: str = "fwd", record: Record | None = None):
    """Install ``record`` (a new one by default) for the block, noting its
    entries under ``phase`` ("fwd" or "bwd"); yields it.  Records do not
    nest: the one installed before is put back at the end."""
    global ACTIVE
    if phase not in ("fwd", "bwd"):
        raise ValueError(f"phase must be 'fwd' or 'bwd', got {phase!r}")
    rec = Record() if record is None else record
    prev, prev_phase = ACTIVE, rec.phase
    rec.phase, ACTIVE = phase, rec
    try:
        yield rec
    finally:
        ACTIVE, rec.phase = prev, prev_phase


@contextlib.contextmanager
def paused():
    """No record for the block: the collectives issued inside it (a
    calibration's micro-benchmarks, which are not a step) are noted
    nowhere.  The record installed before is put back at the end."""
    global ACTIVE
    prev, ACTIVE = ACTIVE, None
    try:
        yield
    finally:
        ACTIVE = prev


@contextlib.contextmanager
def _region(rec: Record, name: str):
    prev, rec.region = rec.region, name
    try:
        yield
    finally:
        rec.region = prev


_NO_REGION = contextlib.nullcontext()


def region(name: str | None):
    """The region the collectives issued inside the block are attributed
    to (a no-op context when no record is installed, or for ``None``)."""
    rec = ACTIVE
    if rec is None or name is None:
        return _NO_REGION
    return _region(rec, name)


def current_region() -> str | None:
    """The open region of the installed record (None: no record).  An
    autograd Function keeps it from its forward, so that its backward's
    collectives are noted under the same region."""
    return None if ACTIVE is None else ACTIVE.region


@contextlib.contextmanager
def _quant(rec: Record):
    prev, rec.quant = rec.quant, True
    try:
        yield
    finally:
        rec.quant = prev


def quant():
    """Mark the collectives issued inside the block as carrying a quantized
    payload (a no-op context when no record is installed)."""
    rec = ACTIVE
    if rec is None:
        return _NO_REGION
    return _quant(rec)
