"""Calibration tables of the ATP cost model (paper §5.3; counterpart of
``repro.core.calibrate``, its data part).

The measuring side (``calibrate_mesh``, ``recalibrate_surviving``: the
on-mesh micro-benchmarks) is ROADMAP A7 and raises here; the tables, their
JSON form and the helpers the plan search reads are a copy of the
reference's.

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
from typing import Mapping

from repro_torch.core.comm_matrix import HierarchicalCommMatrix


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


_A7 = ("is not ported yet (ROADMAP A7: calibration, the on-mesh "
       "micro-benchmarks timed with CUDA events)")


def calibrate_mesh(tp_degree: int, matrix: HierarchicalCommMatrix | None = None,
                   **kwargs) -> CalibrationTable:
    """Measure (B1, B2) and the boundary latencies of every runnable
    (d1, d2) of ``tp_degree``: ROADMAP A7."""
    raise NotImplementedError(f"calibrate_mesh {_A7}")


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


def recalibrate_surviving(plan, devices=None, **kwargs):
    """Re-measure a plan's calibration on the surviving mesh (paper §5.3):
    ROADMAP A7."""
    raise NotImplementedError(f"recalibrate_surviving {_A7}")
