"""On-mesh calibration of the ATP cost model (paper §5.3; counterpart of
``repro.core.calibrate``).

The tables, their JSON form and the helpers the plan search reads are a
copy of the reference's.  The measuring side (``calibrate_mesh``,
``recalibrate_surviving``) times the port's own collectives over
``torch.distributed`` process groups, one process per rank (SPMD), where
the reference's single controller times ``shard_map`` programs:

  - ``devices`` is a list of global ranks (default: every rank of the
    default group); a factorization (d1, d2) runs on its first d1 * d2,
    laid out row-major as ``MeshTopo`` lays out (tp1, tp2);
  - every rank of the default group calls these functions, and creates
    every factorization's groups in the same order, member or not; ranks
    outside a factorization skip its timing and receive its entry;
  - a sample is timed on the host clock around a call that ends
    synchronised (``torch.cuda.synchronize`` on the card), after a barrier
    on the factorization's ranks, and is the slowest rank's (an all-reduce
    MAX of the seconds): the wall time the reference's ``block_until_ready``
    measures, whose host share ``launch_s`` and ``alpha_s`` isolate;
  - a decision on a budget (``_time_fn``'s early stop, the recovery
    deadline's gate) is the first rank's, on its clock, sent to the rest:
    every rank issues the same collectives and builds the same table, so
    that they pick the same plan;
  - the collectives are not a step: the record of ``analysis.signature``
    is paused while they run.

The analytic hierarchical comm matrix (Eq. 3/4) predicts per-mesh-dim
algorithm bandwidths; §5.3 shows the prediction can be badly wrong on
messy fabrics (IC1: PCIe ACS/NUMA effects), and that re-ranking with
*measured* (B1, B2) recovers the right strategy.  This module produces
those measurements as a ``CalibrationTable``: for each (d1, d2)
factorization of the TP degree that fits the available devices, it
micro-benchmarks

  - the all-reduce over each mesh dim  -> effective algorithm bandwidths
    (B1, B2) in the seed convention (payload_bytes / measured_seconds),
    directly substitutable for Eq. 4's values in ``t_comm`` /
    ``t_comm_overlap``;
  - the psum vs explicit-ring boundary  -> preferred ``boundary_mode``.

Tables are plain data (JSON round-trippable) so a ``ParallelPlan`` can
carry them: a plan searched on one machine records exactly which measured
numbers drove the choice.  Measurement is injectable (``measure=``) so
tests and the cost-model path stay deterministic.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Mapping

from repro_torch.core.comm_matrix import HierarchicalCommMatrix
from repro_torch.core.mesh import factorizations


@dataclasses.dataclass(frozen=True)
class CalibEntry:
    """Measured numbers for one (d1, d2) factorization.

    b1 / b2 are *algorithm* bandwidths in GB/s (the seed ``calibration``
    convention: all-reduce time = payload_bytes / (B * 1e9)); inf means
    the dim is singleton.  t_psum / t_ring are measured seconds of one
    boundary all-reduce in each implementation (None when unmeasured).
    alpha_s is the measured per-collective-step latency in seconds (ring
    step convention: a d-rank all-reduce runs 2(d-1) steps), extracted
    from a latency-bound tiny-payload all-reduce; it feeds
    ``t_comm_overlap``'s ring-vs-Rabenseifner and chunk-count choices —
    chunking amortizes bandwidth but pays alpha per chunk, so a measured
    alpha is what keeps the search from over-chunking on real fabrics.

    chunk_eff holds the chunked-overlap *effective bandwidth* micro-
    benchmark (ROADMAP open item): tuples ``(chunks, eff1, eff2)`` where
    eff_i is the measured PURE-bandwidth efficiency of splitting one
    boundary all-reduce on mesh dim i into ``chunks`` back-to-back
    collectives of payload/chunks each —
    ``t_whole / (t_chunked - (chunks-1) * launch_s)``, 1.0 = free
    splitting.  The per-extra-chunk software launch cost is measured
    separately as ``launch_s`` (from the c=2 split: t_2 - t_whole) and
    charged additively by ``t_comm_overlap(chunk_launch_s=...)``; folding
    it into the bandwidth number — the pre-fix behavior — double-counted
    launch overhead against the alpha_s term.  A slow measured chunk path
    (either number) still steers the search back to chunks=1.

    ``provenance`` records where THIS entry's numbers came from:
    ``"measured"`` (on-mesh micro-benchmark), ``"carried"`` (copied from
    the pre-shrink table when a recovery deadline ran out before this
    factorization's turn), or ``"analytic"`` (Eq. 3/4 model values — the
    budget-exhausted fallback when there is nothing to carry).  Deadline-
    budgeted recovery (``recalibrate_surviving(deadline_s=...)``) is the
    writer; ``CalibrationTable.provenance_counts`` and
    ``ParallelPlan.describe`` surface it so a partially-calibrated
    recovery is visible in the artifact.

    b1_q / b2_q are the *quantized-collective* algorithm bandwidths: the
    same micro-benchmark run over the int8 wire
    (``overlap.quant_psum``), in the WIRE-byte convention — a quantized
    all-reduce of N elements takes ``N * 1 byte / (b_q * 1e9)`` seconds.
    They pair with ``t_comm_overlap(wire_dtype=..., calibrated=...)``:
    the search substitutes (b1_q, b2_q) for (b1, b2) when pricing a
    quantized plan, which is how measured quant/dequant overhead (or a
    fabric that accelerates small payloads sub-linearly) can flip the
    chosen factorization or chunk count.  None = unmeasured (the search
    falls back to the full-width bandwidths over the halved byte count).
    """

    b1: float
    b2: float
    t_psum: float | None = None
    t_ring: float | None = None
    alpha_s: float | None = None
    chunk_eff: tuple[tuple[int, float, float], ...] | None = None
    launch_s: float | None = None
    b1_q: float | None = None
    b2_q: float | None = None
    provenance: str = "measured"

    @property
    def boundary_mode(self) -> str | None:
        if self.t_psum is None or self.t_ring is None:
            return None
        return "ring" if self.t_ring < self.t_psum else "psum"

    def chunk_efficiency(self) -> dict[int, tuple[float, float]] | None:
        """{chunks: (eff1, eff2)} view for ``t_comm_overlap`` (None when
        the chunked micro-benchmark was not run)."""
        if self.chunk_eff is None:
            return None
        return {int(c): (e1, e2) for c, e1, e2 in self.chunk_eff}

    def to_dict(self) -> dict:
        return {"b1": _enc_inf(self.b1), "b2": _enc_inf(self.b2),
                "t_psum": self.t_psum, "t_ring": self.t_ring,
                "alpha_s": self.alpha_s,
                "chunk_eff": (None if self.chunk_eff is None
                              else [list(t) for t in self.chunk_eff]),
                "launch_s": self.launch_s,
                "b1_q": (None if self.b1_q is None else _enc_inf(self.b1_q)),
                "b2_q": (None if self.b2_q is None else _enc_inf(self.b2_q)),
                "provenance": self.provenance}

    @staticmethod
    def from_dict(d: Mapping) -> "CalibEntry":
        ce = d.get("chunk_eff")
        b1_q, b2_q = d.get("b1_q"), d.get("b2_q")
        return CalibEntry(b1=_dec_inf(d["b1"]), b2=_dec_inf(d["b2"]),
                          t_psum=d.get("t_psum"), t_ring=d.get("t_ring"),
                          alpha_s=d.get("alpha_s"),
                          chunk_eff=(None if ce is None else tuple(
                              (int(c), float(e1), float(e2))
                              for c, e1, e2 in ce)),
                          launch_s=d.get("launch_s"),
                          b1_q=(None if b1_q is None else _dec_inf(b1_q)),
                          b2_q=(None if b2_q is None else _dec_inf(b2_q)),
                          # absent in pre-v5 files: every entry was a
                          # real on-mesh measurement back then
                          provenance=d.get("provenance", "measured"))


def _enc_inf(v: float):
    return "inf" if math.isinf(v) else v


def _dec_inf(v) -> float:
    return math.inf if v == "inf" else float(v)


@dataclasses.dataclass(frozen=True)
class CalibrationTable:
    """Per-factorization measured entries; JSON round-trippable.

    ``source`` records where the numbers came from ("measured", "model",
    or a free-form label such as the paper's published IC1 values).
    """

    entries: tuple[tuple[tuple[int, int], CalibEntry], ...] = ()
    source: str = "measured"

    def get(self, d1: int, d2: int) -> CalibEntry | None:
        for (a, b), e in self.entries:
            if (a, b) == (d1, d2):
                return e
        return None

    def bandwidths(self, d1: int, d2: int) -> tuple[float, float] | None:
        e = self.get(d1, d2)
        return (e.b1, e.b2) if e is not None else None

    def boundary_mode(self, d1: int, d2: int) -> str | None:
        e = self.get(d1, d2)
        return e.boundary_mode if e is not None else None

    def alpha(self, d1: int, d2: int) -> float | None:
        """Measured per-step collective latency (None when unmeasured)."""
        e = self.get(d1, d2)
        return e.alpha_s if e is not None else None

    def chunk_efficiency(self, d1: int, d2: int) \
            -> dict[int, tuple[float, float]] | None:
        """Measured chunked-collective bandwidth efficiencies (or None)."""
        e = self.get(d1, d2)
        return e.chunk_efficiency() if e is not None else None

    def launch(self, d1: int, d2: int) -> float | None:
        """Measured per-extra-chunk launch cost (None when unmeasured)."""
        e = self.get(d1, d2)
        return e.launch_s if e is not None else None

    def quant_bandwidths(self, d1: int, d2: int) \
            -> tuple[float, float] | None:
        """Measured quantized-collective bandwidths (b1_q, b2_q) in the
        wire-byte convention, or None when the quantized micro-benchmark
        did not run for this factorization."""
        e = self.get(d1, d2)
        if e is None or (e.b1_q is None and e.b2_q is None):
            return None
        return (e.b1_q if e.b1_q is not None else e.b1,
                e.b2_q if e.b2_q is not None else e.b2)

    def provenance_counts(self) -> dict[str, int]:
        """Entry counts by provenance (measured / carried / analytic) —
        how calibrated this table actually is.  A deadline-budgeted
        recovery that ran out of time shows up here (and in
        ``ParallelPlan.describe``) instead of masquerading as fully
        measured."""
        out: dict[str, int] = {}
        for _, e in self.entries:
            out[e.provenance] = out.get(e.provenance, 0) + 1
        return out

    def covers_tp(self, tp_degree: int) -> bool:
        """True if any entry measures a factorization of ``tp_degree``.

        Necessary (not sufficient) evidence of a surviving-mesh
        recalibration: ``replan_elastic`` requires it together with the
        provenance tag ``recalibrate_surviving`` writes, since an
        external table may key several degrees without any having been
        measured on this mesh.
        """
        return any(d1 * d2 == tp_degree for (d1, d2), _ in self.entries)

    def merged(self, other: "CalibrationTable") -> "CalibrationTable":
        """This table with ``other``'s entries layered on top.

        ``other`` wins on key collisions — it is the *fresher* measurement
        (the elastic recalibration path merges surviving-mesh numbers into
        the carried table this way, keeping still-valid old keys around
        for audit).
        """
        d = dict(self.entries)
        d.update(dict(other.entries))
        source = (other.source if other.source == self.source
                  else f"{self.source}+{other.source}")
        return CalibrationTable(entries=tuple(sorted(d.items())),
                                source=source)

    def __len__(self) -> int:
        return len(self.entries)

    @staticmethod
    def from_pairs(pairs: Mapping[tuple[int, int], tuple[float, float]],
                   source: str = "external") -> "CalibrationTable":
        """Lift a seed-style {(d1,d2): (B1,B2)} dict into a table."""
        return CalibrationTable(
            entries=tuple(((d1, d2), CalibEntry(b1=b1, b2=b2))
                          for (d1, d2), (b1, b2) in sorted(pairs.items())),
            source=source)

    @staticmethod
    def coerce(calibration) -> "CalibrationTable | None":
        """Accept a table, a seed-style {(d1,d2): (B1,B2)} dict, or None —
        the one dispatch point for every calibration-taking API."""
        if calibration is None or isinstance(calibration, CalibrationTable):
            return calibration
        return CalibrationTable.from_pairs(calibration)

    def as_pairs(self) -> dict[tuple[int, int], tuple[float, float]]:
        """Seed-style {(d1,d2): (B1,B2)} view (for ``search_strategy``)."""
        return {(d1, d2): (e.b1, e.b2) for (d1, d2), e in self.entries}

    def to_dict(self) -> dict:
        return {"source": self.source,
                "entries": {f"{d1}x{d2}": e.to_dict()
                            for (d1, d2), e in self.entries}}

    @staticmethod
    def from_dict(d: Mapping) -> "CalibrationTable":
        entries = []
        for key, ed in d.get("entries", {}).items():
            d1, d2 = (int(p) for p in key.split("x"))
            entries.append(((d1, d2), CalibEntry.from_dict(ed)))
        return CalibrationTable(entries=tuple(sorted(entries)),
                                source=d.get("source", "measured"))


# ---------------------------------------------------------------------------
# Measurement helpers.
# ---------------------------------------------------------------------------


#: samples above this multiple of the raw median are treated as outliers
_TRIM_FACTOR = 2.5


def robust_seconds(samples) -> float:
    """Median-of-k with high-side outlier trimming.

    The pre-fix statistic was best-of-N (min) — robust against slow
    outliers but maximally credulous of FAST ones: a single spuriously
    quick sample (clock glitch, coalesced dispatch) becomes the measured
    time, inflates the derived bandwidth, and can flip ``plan_search``
    to a mesh the fabric cannot actually sustain (the ic1 pin in
    tests/test_robustness.py).  The median is robust on both sides as
    long as fewer than half the samples are outliers; samples more than
    ``_TRIM_FACTOR``x the raw median (stragglers: GC pause, scheduler
    preemption) are dropped first so they cannot drag the median of a
    small k either.
    """
    xs = sorted(float(s) for s in samples)
    if not xs:
        raise ValueError("no timing samples")
    med = xs[len(xs) // 2]
    kept = [x for x in xs if x <= _TRIM_FACTOR * med] or xs
    n = len(kept)
    return kept[n // 2] if n % 2 else 0.5 * (kept[n // 2 - 1] + kept[n // 2])


# ---------------------------------------------------------------------------
# Agreement between the ranks.
# ---------------------------------------------------------------------------


def _dist():
    """``torch.distributed`` when a default group exists, else None (one
    process: nothing to agree on)."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _world_devices(devices) -> list:
    """``devices`` as a list of global ranks (default: every rank)."""
    if devices is not None:
        return list(devices)
    dist = _dist()
    return list(range(dist.get_world_size() if dist is not None else 1))


def _device():
    """Where the collectives' tensors live: the card under NCCL, the host
    under gloo."""
    import torch

    dist = _dist()
    if dist is not None and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _from_first(value, src: int):
    """``value`` as global rank ``src`` holds it, on every rank (a broadcast
    over the default group; itself in one process)."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def _sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the host:
    gloo's collectives return done)."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _agree_sample(seconds: float, stop: bool, group, device):
    """(the slowest rank's seconds, the group's first rank's stop): one
    all-reduce MAX, in which only the first rank raises the stop flag."""
    import torch

    dist = _dist()
    lead = dist.get_rank() == dist.get_global_rank(group, 0)
    t = torch.tensor([seconds, 1.0 if (stop and lead) else 0.0],
                     dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t[0]), bool(t[1] > 0)


def _time_fn(fn, *args, repeats: int = 3,
             timer: Callable[[], float] = time.perf_counter,
             budget_s: float | None = None, group=None, device=None) -> float:
    """Robust wall time of a blocking call: up to ``repeats`` samples,
    stopping early once ``budget_s`` is spent (always at least one —
    a deadline bounds the repeat count k, never the truth of a sample),
    reduced by :func:`robust_seconds`.

    On a process ``group`` every sample starts after a barrier of the
    group and is the slowest rank's; the early stop is the group's first
    rank's (on its clock and its ``budget_s``), carried in the same
    all-reduce, so every rank takes the same number of samples and returns
    the same seconds.  ``device`` (the host by default) is synchronised
    after each call."""
    import torch

    device = device if device is not None else torch.device("cpu")
    dist = _dist() if group is not None else None
    fn(*args)                      # warm up: first-use costs
    _sync(device)
    t_start = timer()
    samples = []
    for _ in range(max(1, repeats)):
        if dist is not None:
            dist.barrier(group=group)
            _sync(device)
        t0 = timer()
        fn(*args)
        _sync(device)
        dt = timer() - t0
        stop = budget_s is not None and timer() - t_start >= budget_s
        if dist is not None:
            dt, stop = _agree_sample(dt, stop, group, device)
        samples.append(dt)
        if stop:
            break
    return robust_seconds(samples)


def _factorization_groups(dist, ranks: list, d1: int, d2: int):
    """The process groups of a (d1, d2) mesh over ``ranks`` (row-major: rank
    ``ranks[i1 * d2 + i2]`` at (tp1 = i1, tp2 = i2)): this rank's tp1 group,
    its tp2 group (None where the axis is 1) and the group of all d1 * d2
    (None for a rank outside them).  Every rank creates every group, in the
    same order."""
    me = dist.get_rank()
    g1 = g2 = None
    if d1 > 1:
        for i2 in range(d2):
            members = [ranks[i1 * d2 + i2] for i1 in range(d1)]
            g = dist.new_group(members)
            if me in members:
                g1 = g
    if d2 > 1:
        for i1 in range(d1):
            members = [ranks[i1 * d2 + i2] for i2 in range(d2)]
            g = dist.new_group(members)
            if me in members:
                g2 = g
    whole = dist.new_group(ranks)
    return g1, g2, (whole if me in ranks else None)


def _measure_factorization(d1: int, d2: int, payload_bytes: int,
                           repeats: int, devices=None,
                           budget_s: float | None = None,
                           timer: Callable[[], float] = time.perf_counter
                           ) -> CalibEntry:
    """All-reduce timing over each TP mesh dim + psum-vs-ring boundary.

    ``budget_s`` (deadline-budgeted recovery) caps the wall time spent
    here: every inner timing loop sees the remaining budget and stops
    sampling once it is gone — k shrinks before coverage does, and the
    overrun is bounded by one sample per measurement kind.

    A rank holds ``payload_bytes // 4`` fp32 elements, as a shard of the
    reference's ``[d, elems]`` input does, and reduces them over its axis
    group: ``dist.all_reduce`` (t_psum, the bandwidths, alpha_s from 64
    elements, the chunked timings: c back-to-back all-reduces of
    payload/c), ``overlap.ring_all_reduce_raw`` (t_ring) and
    ``overlap.quant_psum_raw(..., "int8")`` (the quantized bandwidths).
    Every rank of the default group returns the same entry: the first
    d1 * d2 of ``devices`` measure it, the others receive it."""
    import torch

    from repro_torch.analysis import signature as sig
    from repro_torch.core import overlap

    ranks = _world_devices(devices)[: d1 * d2]
    if len(ranks) < d1 * d2:
        raise ValueError(f"({d1}, {d2}) needs {d1 * d2} ranks, "
                         f"{len(ranks)} given")
    dist = _dist()
    g1 = g2 = whole = None
    if d1 * d2 > 1:
        if dist is None:
            raise RuntimeError(f"measuring ({d1}, {d2}) needs "
                               f"torch.distributed initialized")
        g1, g2, whole = _factorization_groups(dist, ranks, d1, d2)
    ax1 = "tp1" if d1 > 1 else None
    ax2 = "tp2" if d2 > 1 else None
    groups = {"tp1": g1, "tp2": g2}
    device = _device()
    elems = max(1, payload_bytes // 4)
    t_begin = timer()

    def rem() -> float | None:
        if budget_s is None:
            return None
        return max(0.0, budget_s - (timer() - t_begin))

    def time_allreduce(axis: str, d: int, ring: bool = False,
                       n_elems: int | None = None,
                       quant: bool = False) -> float:
        g = groups[axis]
        x = torch.ones((1, n_elems or elems), dtype=torch.float32,
                       device=device)
        if quant:
            def red():
                return overlap.quant_psum_raw(x, g, (axis,), "int8")
        elif ring:
            def red():
                return overlap.ring_all_reduce_raw(x, g, (axis,))
        else:
            def red():
                return overlap.all_reduce_(x.clone(), g, (axis,))
        return _time_fn(red, repeats=repeats, budget_s=rem(), group=whole,
                        device=device)

    def quant_bw(axis: str | None, d: int) -> float | None:
        """Quantized-collective bandwidth in the WIRE-byte convention:
        the int8 wire moves 1 byte per element, so b_q = elems / t — the
        number ``t_comm_overlap(wire_dtype="int8")`` divides its 1-byte
        volumes by.  Quant/dequant overhead lands in t, which is the
        point: a fabric (or emulation) where quantization does not pay
        shows up as b_q < b/2 and the search prices it honestly."""
        if axis is None:
            return None
        t = time_allreduce(axis, d, quant=True)
        return elems / t / 1e9 if t > 0.0 else None

    def alpha_from_tiny(axis: str, d: int) -> float:
        """Per-step latency: a 64-element all-reduce is latency-bound, so
        its wall time over the ring step count is alpha_s."""
        return max(0.0, time_allreduce(axis, d, n_elems=64)) / (2 * (d - 1))

    def time_chunked(axis: str, d: int, c: int) -> float:
        """One boundary payload split into c back-to-back collectives of
        payload/c each — the wire pattern the chunk-overlap engine issues
        per boundary (``core.atp._chunked_boundary_matmul``)."""
        g = groups[axis]
        x = torch.ones((c, max(1, elems // c)), dtype=torch.float32,
                       device=device)

        def red():
            y = x.clone()
            for i in range(c):
                overlap.all_reduce_(y[i], g, (axis,))
            return y

        return _time_fn(red, repeats=repeats, budget_s=rem(), group=whole,
                        device=device)

    def launch_axis(axis: str | None, d: int,
                    whole_s: float | None) -> float | None:
        """Per-extra-chunk software launch cost: the c=2 split issues
        exactly one extra collective, so t_2 - t_whole isolates it from
        the bandwidth term."""
        if axis is None or whole_s is None or whole_s <= 0.0:
            return None
        return max(0.0, time_chunked(axis, d, 2) - whole_s)

    def chunk_eff_axis(axis: str | None, d: int, whole_s: float, c: int,
                       launch: float | None) -> float:
        """Measured PURE-bandwidth efficiency of splitting into c chunks
        on one axis (1.0 for singleton dims): the measured per-extra-chunk
        launch cost is subtracted from the chunked time first."""
        if axis is None or whole_s is None or whole_s <= 0.0:
            return 1.0
        tc = time_chunked(axis, d, c) - (c - 1) * (launch or 0.0)
        return min(1.0, whole_s / tc) if tc > 0.0 else 1.0

    def measure() -> CalibEntry:
        b1 = b2 = math.inf
        b1_q = b2_q = None
        t_psum = t_ring = alpha_s = None
        t1_whole = t2_whole = None
        if ax1 is not None:
            t_psum = time_allreduce(ax1, d1)
            t_ring = time_allreduce(ax1, d1, ring=True)
            b1 = payload_bytes / t_psum / 1e9
            alpha_s = alpha_from_tiny(ax1, d1)
            b1_q = quant_bw(ax1, d1)
            t1_whole = t_psum
            if ax2 is not None:
                t2_whole = time_allreduce(ax2, d2)
                b2 = payload_bytes / t2_whole / 1e9
                b2_q = quant_bw(ax2, d2)
                # one alpha serves every collective of this factorization:
                # keep the slower axis's latency
                alpha_s = max(alpha_s, alpha_from_tiny(ax2, d2))
        elif ax2 is not None:
            # boundary collectives live on the only non-trivial dim here,
            # so the psum timing doubles as the b2 measurement
            t_psum = time_allreduce(ax2, d2)
            t_ring = time_allreduce(ax2, d2, ring=True)
            b2 = payload_bytes / t_psum / 1e9
            alpha_s = alpha_from_tiny(ax2, d2)
            b2_q = quant_bw(ax2, d2)
            t2_whole = t_psum
        launch1 = launch_axis(ax1, d1, t1_whole)
        launch2 = launch_axis(ax2, d2, t2_whole)
        launch_s = max((v for v in (launch1, launch2) if v is not None),
                       default=None)
        chunk_eff = tuple(
            (c,
             chunk_eff_axis(ax1, d1, t1_whole, c, launch1),
             chunk_eff_axis(ax2, d2, t2_whole, c, launch2))
            for c in (2, 4))
        return CalibEntry(b1=b1, b2=b2, t_psum=t_psum, t_ring=t_ring,
                          alpha_s=alpha_s, chunk_eff=chunk_eff,
                          launch_s=launch_s, b1_q=b1_q, b2_q=b2_q)

    entry = None
    if d1 * d2 == 1 or whole is not None:
        with sig.paused():
            entry = measure()
    return entry if d1 * d2 == 1 else _from_first(entry, ranks[0])


def calibrate_mesh(
    tp_degree: int,
    matrix: HierarchicalCommMatrix | None = None,
    *,
    payload_kb: int = 256,
    repeats: int = 3,
    measure: Callable[[int, int], CalibEntry] | None = None,
    devices=None,
) -> CalibrationTable:
    """Measure (B1, B2) + boundary latency for every runnable (d1, d2).

    ``matrix`` (optional) restricts the sweep to factorizations that embed
    into the modelled topology — the same filter the search applies — so
    the table's keys line up with the strategy space.  Factorizations
    needing more ranks than ``devices`` holds are skipped (the table is
    partial — empty at world size 1 but for (1, 1); the search falls back
    to the analytic model for missing keys).  ``measure`` overrides the
    on-mesh micro-benchmark with an arbitrary (d1, d2) -> CalibEntry
    function (tests, simulators); its entries are the first rank's on
    every rank.  ``devices`` restricts the benchmark to a list of global
    ranks (the elastic recovery path passes the surviving pool; default:
    every rank of the default group, which must all call this)."""
    devs = _world_devices(devices)
    ndev = len(devs)
    entries = []
    for d1, d2 in factorizations(tp_degree):
        if matrix is not None:
            try:
                matrix.axis_bandwidths(d1, d2)
            except ValueError:
                continue
        if measure is None and d1 * d2 > ndev:
            continue
        if measure is not None:
            e = _from_first(measure(d1, d2), devs[0])
        else:
            e = _measure_factorization(d1, d2, payload_kb * 1024, repeats,
                                       devs)
        entries.append(((d1, d2), e))
    return CalibrationTable(entries=tuple(entries), source="measured")


# ---------------------------------------------------------------------------
# Elastic recovery: recalibrate on the surviving mesh.
# ---------------------------------------------------------------------------


def surviving_tp(tp_degree: int, n_devices: int) -> int:
    """The TP degree an elastic shrink keeps on ``n_devices``.

    Mirrors ``plan.replan_elastic``: data-parallel replicas absorb device
    loss first, so TP only halves when even dp=1 no longer fits.
    """
    if n_devices < 1:
        raise ValueError("no surviving devices")
    tp = tp_degree
    while tp > n_devices:
        tp //= 2
    return tp


def analytic_entry(matrix: HierarchicalCommMatrix | None, d1: int,
                   d2: int) -> CalibEntry:
    """Eq. 3/4 model bandwidths lifted into a ``CalibEntry`` (provenance
    ``"analytic"``) — the budget-exhausted fallback when a recovery
    deadline leaves a factorization unmeasured and the carried table has
    nothing for it.  Only (b1, b2) are filled: the model has no opinion
    on boundary-mode timings or chunk efficiencies, and pretending it
    did would defeat the provenance record."""
    if matrix is None:
        return CalibEntry(b1=math.inf, b2=math.inf, provenance="analytic")
    from repro_torch.core.cost_model import axis_algorithm_bw

    _, _, b1, b2 = axis_algorithm_bw(matrix, d1, d2)
    return CalibEntry(b1=b1, b2=b2, provenance="analytic")


def sensitivity_order(keys, matrix: HierarchicalCommMatrix | None, *,
                      model=None, batch: int | None = None,
                      seq: int | None = None) -> list[tuple[int, int]]:
    """Order factorization keys by descending cost-model sensitivity
    (``cost_model.factorization_sensitivity``): the entries whose
    bandwidth numbers move the strategy ranking most get measured first,
    so a recovery deadline degrades the *least important* entries to
    carried/analytic.  Without a matrix the natural order stands (there
    is no model to rank by); without a workload a generic dense block is
    assumed — the ordering across factorizations is dominated by the
    fabric's bandwidths, not the exact layer shape."""
    keys = list(keys)
    if matrix is None or len(keys) < 2:
        return keys
    from repro_torch.core.cost_model import (LayerCommProfile, SegmentWorkload,
                                       factorization_sensitivity,
                                       segment_workloads)

    if model is not None:
        workloads = segment_workloads(model)
    else:
        workloads = (SegmentWorkload(kind="dense", layers=1,
                                     profile=LayerCommProfile.gpt(4096)),)
    b = batch if batch is not None else 8
    s = seq if seq is not None else 512
    return sorted(keys, key=lambda k: (-factorization_sensitivity(
        matrix, k[0], k[1], workloads=workloads, batch=b, seq=s), k))


def recalibrate_surviving(
    plan,
    devices=None,
    *,
    payload_kb: int = 256,
    repeats: int = 3,
    measure: Callable[[int, int], CalibEntry] | None = None,
    deadline_s: float | None = None,
    model=None,
    batch: int | None = None,
    seq: int | None = None,
    timer: Callable[[], float] = time.perf_counter,
):
    """Re-measure a plan's calibration on the surviving mesh (paper §5.3).

    After an elastic shrink the carried table is tagged
    ``calibration: stale``.  This re-runs the micro-benchmarks for every
    factorization of the *surviving* TP degree (``surviving_tp`` of the
    surviving pool), merges the fresh entries into the carried table
    (fresh keys win; old keys stay for audit), clears the stale tag and
    records the recalibration in provenance, as the reference does.

    **Deadline budget** (``deadline_s``): factorizations are visited in
    descending cost-model sensitivity (``sensitivity_order``), each
    measurement's repeat count shrinks as the budget drains, and once the
    budget is gone the remaining factorizations fall back to the carried
    table's entry (provenance ``"carried"``) or the analytic model
    (``"analytic"``); the ``recalibrated tp=`` tag is only written when at
    least one entry was measured.  Every gate (the remaining budget against
    the last measurement's cost) and the spend the provenance records are
    the first surviving rank's, on its ``timer``, sent to every rank: the
    ranks take the same path and return the same plan.

    ``plan`` is any ParallelPlan-shaped object.  ``measure`` injects the
    per-factorization benchmark (tests, simulators); ``devices`` is the
    surviving pool as global ranks (default: every rank of the default
    group, which must all call this); ``timer`` injects the budget clock.
    """
    from repro_torch.core import comm_matrix

    devs = _world_devices(devices)
    lead = devs[0]
    tp = surviving_tp(plan.tp, len(devs))
    matrix = None
    if plan.topology is not None:
        preset = comm_matrix.PRESETS.get(plan.topology)
        matrix = preset() if preset is not None else None
    keys = []
    for d1, d2 in factorizations(tp):
        if matrix is not None:
            try:
                matrix.axis_bandwidths(d1, d2)
            except ValueError:
                continue
        if measure is None and d1 * d2 > len(devs):
            continue
        keys.append((d1, d2))
    if deadline_s is not None:
        keys = sensitivity_order(keys, matrix, model=model, batch=batch,
                                 seq=seq)
    t0 = timer()
    entries = []
    counts = {"measured": 0, "carried": 0, "analytic": 0}
    # adaptive gate: once one factorization has been timed, a later one is
    # only measured if the remaining budget covers what the last one cost
    last_cost = 0.0
    for d1, d2 in keys:
        remaining = (None if deadline_s is None
                     else deadline_s - (timer() - t0))
        skip = remaining is not None and (remaining <= 0.0
                                          or remaining < last_cost)
        if deadline_s is not None:
            skip, remaining = _from_first((skip, remaining), lead)
        if skip:
            old = (plan.calibration.get(d1, d2)
                   if plan.calibration is not None else None)
            e = (dataclasses.replace(old, provenance="carried")
                 if old is not None else analytic_entry(matrix, d1, d2))
        else:
            t_meas = timer()
            if measure is not None:
                e = _from_first(measure(d1, d2), lead)
            else:
                e = _measure_factorization(d1, d2, payload_kb * 1024,
                                           repeats, devs, budget_s=remaining,
                                           timer=timer)
            e = dataclasses.replace(e, provenance="measured")
            last_cost = timer() - t_meas
        counts[e.provenance] += 1
        entries.append(((d1, d2), e))
    entries.sort()
    source = ("measured" if counts["measured"] == len(entries)
              else "deadline-budgeted")
    fresh = CalibrationTable(entries=tuple(entries), source=source)
    merged = fresh if plan.calibration is None \
        else plan.calibration.merged(fresh)
    prov = tuple(p for p in plan.provenance
                 if p != ("calibration", "stale"))
    if counts["measured"] > 0:
        prov += (("calibration",
                  f"recalibrated tp={tp} on {len(devs)} devices"),)
    if deadline_s is not None:
        spent = _from_first(timer() - t0, lead)
        # key "calibration" so replan_elastic's re-search carries it
        prov += (("calibration",
                  f"budget deadline_s={deadline_s:g} spent_s={spent:.3f} "
                  f"measured={counts['measured']} "
                  f"carried={counts['carried']} "
                  f"analytic={counts['analytic']}"),)
    return plan.with_(calibration=merged, provenance=prov)
