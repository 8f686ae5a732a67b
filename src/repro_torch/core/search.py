"""ATP strategy search (paper §3.5): pick DeviceMesh(d1,d2) minimizing T_comm
(counterpart of ``repro.core.search``, a copy).

``search_strategy`` is the paper's Eq. 2 ranking over (d1, d2).
``search_strategy_overlap`` extends the space with the overlap engine's
knobs — ``chunks`` (§4.1 chunk-pipelining) and ``seq_parallel`` (the
reduce-scatter/all-gather block I/O spec) — ranked by *exposed* (post-
overlap) communication time from ``cost_model.t_comm_overlap``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.atp import SEQ_PARALLEL_KINDS
from repro_torch.core.calibrate import CalibrationTable
from repro_torch.core.cost_model import (DECODE_ALPHA_S, DECODE_LAUNCH_S,
                                   DecodeStrategyCost, LayerCommProfile,
                                   OverlapStrategyCost, SegmentWorkload,
                                   StrategyCost, t_comm, t_comm_decode,
                                   t_comm_overlap)
from repro_torch.core.comm_matrix import HierarchicalCommMatrix
from repro_torch.core.mesh import factorizations


@dataclasses.dataclass(frozen=True)
class SearchResult:
    best: StrategyCost
    ranked: tuple[StrategyCost, ...]  # ascending T_comm

    def mesh(self) -> tuple[int, int]:
        return (self.best.d1, self.best.d2)


def search_strategy(
    matrix: HierarchicalCommMatrix,
    tp_degree: int,
    *,
    layers: int,
    batch: int,
    seq: int,
    profile: LayerCommProfile,
    bytes_per_elem: int = 2,
    calibration: dict[tuple[int, int], tuple[float, float]] | None = None,
) -> SearchResult:
    """Enumerate all (d1,d2) factorizations of tp_degree and rank by Eq. 2.

    `calibration` maps (d1,d2) -> measured (B1,B2) overrides (paper §5.3);
    a ``calibrate.CalibrationTable`` is accepted in place of the dict.
    """
    calibration = CalibrationTable.coerce(calibration)
    costs = []
    for d1, d2 in factorizations(tp_degree):
        calib = (calibration.bandwidths(d1, d2)
                 if calibration is not None else None)
        try:
            costs.append(
                t_comm(
                    matrix, d1, d2,
                    layers=layers, batch=batch, seq=seq,
                    profile=profile, bytes_per_elem=bytes_per_elem,
                    calibrated=calib,
                )
            )
        except ValueError:
            continue  # factorization does not embed into the topology
    if not costs:
        raise ValueError(f"no valid (d1,d2) for tp={tp_degree} on {matrix.name}")
    ranked = tuple(sorted(costs, key=lambda c: c.t_comm))
    return SearchResult(ranked[0], ranked)


@dataclasses.dataclass(frozen=True)
class OverlapSearchResult:
    best: OverlapStrategyCost
    ranked: tuple[OverlapStrategyCost, ...]  # ascending t_exposed

    def mesh(self) -> tuple[int, int]:
        return (self.best.d1, self.best.d2)

    def config(self) -> dict:
        return {"d1": self.best.d1, "d2": self.best.d2,
                "chunks": self.best.chunks,
                "seq_parallel": self.best.seq_parallel}


def _calibration_lookups(calibration, alpha_s: float,
                         wire_dtype: str = "bf16"):
    """(calib_for, alpha_for, chunk_eff_for, launch_for) shared by every
    search — measured bandwidths / per-step latencies / chunked-collective
    efficiencies / per-chunk launch costs override the analytic defaults
    for the factorizations the table covers.  One implementation: the
    v1/v2 parity pin depends on all searches pricing calibration
    identically.

    Under ``wire_dtype`` "int8"/"fp8" the measured *quantized* wire
    bandwidths (``CalibEntry.b1_q``/``b2_q``, already in the 1-byte/elem
    convention the cost model uses for quantized volumes) replace the
    full-width ones where measured — this is what lets ``plan_search``
    pick a different factorization under quantization when the fabric's
    small-message behaviour differs from its large-message one."""

    def calib_for(d1: int, d2: int):
        if calibration is None:
            return None
        if wire_dtype != "bf16":
            q = calibration.quant_bandwidths(d1, d2)
            if q is not None:
                return q
        return calibration.bandwidths(d1, d2)

    def alpha_for(d1: int, d2: int) -> float:
        if calibration is not None:
            a = calibration.alpha(d1, d2)
            if a is not None:
                return a
        return alpha_s

    def chunk_eff_for(d1: int, d2: int):
        if calibration is not None:
            return calibration.chunk_efficiency(d1, d2)
        return None

    def launch_for(d1: int, d2: int):
        if calibration is not None:
            return calibration.launch(d1, d2)
        return None

    return calib_for, alpha_for, chunk_eff_for, launch_for


def search_strategy_overlap(
    matrix: HierarchicalCommMatrix,
    tp_degree: int,
    *,
    layers: int,
    batch: int,
    seq: int,
    profile: LayerCommProfile,
    bytes_per_elem: int = 2,
    chunks_options: tuple[int, ...] = (1, 2, 4, 8),
    seq_parallel_options: tuple[bool, ...] = (False, True),
    peak_tflops: float = 200.0,
    algo: str = "ring",
    alpha_s: float = 0.0,
    calibration=None,
    wire_dtype: str = "bf16",
) -> OverlapSearchResult:
    """Rank (d1, d2) x chunks x seq_parallel by exposed comm time.

    ``wire_dtype`` prices boundary collectives at 1 byte/elem for
    "int8"/"fp8" (MoE dispatch stays full width) and, when the
    calibration table carries measured quantized bandwidths, ranks
    against those instead of the full-width measurements.

    ``seq_parallel`` subsumes the retired ``ATPContext.use_reduce_scatter``
    knob: the fused psum+slice boundary it named is exactly the
    reduce-scatter row boundary the sequence-parallel spec uses (plus the
    conjugate entry gather), so ranking seq_parallel on/off covers that
    axis of the space.

    ``calibration`` maps (d1, d2) to measured (B1, B2) — either a
    ``calibrate.CalibrationTable`` or the seed-style dict ``t_comm``
    accepts — overriding the analytic Eq. 3/4 bandwidths (paper §5.3).

    With ``chunks_options=(1,)``, ``seq_parallel_options=(False,)``,
    ``algo="rabenseifner"`` and ``alpha_s=0`` the ranking over (d1, d2)
    coincides exactly with the seed's Eq. 2 ``search_strategy``.
    """

    calibration = CalibrationTable.coerce(calibration)
    calib_for, alpha_for, chunk_eff_for, launch_for = _calibration_lookups(
        calibration, alpha_s, wire_dtype)

    costs = []
    for d1, d2 in factorizations(tp_degree):
        try:
            matrix.axis_bandwidths(d1, d2)
        except ValueError:
            continue  # factorization does not embed into the topology
        for chunks in chunks_options:
            for sp in seq_parallel_options:
                costs.append(t_comm_overlap(
                    matrix, d1, d2, layers=layers, batch=batch, seq=seq,
                    profile=profile, bytes_per_elem=bytes_per_elem,
                    chunks=chunks, seq_parallel=sp,
                    peak_tflops=peak_tflops, algo=algo,
                    alpha_s=alpha_for(d1, d2),
                    calibrated=calib_for(d1, d2),
                    chunk_eff=chunk_eff_for(d1, d2),
                    chunk_launch_s=launch_for(d1, d2),
                    wire_dtype=wire_dtype))
    if not costs:
        raise ValueError(
            f"no valid (d1,d2) for tp={tp_degree} on {matrix.name}")
    ranked = tuple(sorted(costs, key=lambda c: (c.t_exposed, c.chunks,
                                                c.seq_parallel)))
    return OverlapSearchResult(ranked[0], ranked)


# ---------------------------------------------------------------------------
# Heterogeneous per-segment search (plan format_version 2).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SegmentChoice:
    """One segment's chosen knobs under a shared (d1, d2) mesh."""

    kind: str
    layers: int
    chunks: int
    seq_parallel: bool
    cost: OverlapStrategyCost

    @property
    def t_exposed(self) -> float:
        return self.cost.t_exposed


@dataclasses.dataclass(frozen=True)
class SegmentedStrategyCost:
    """Summed per-segment cost of one (d1, d2) factorization."""

    d1: int
    d2: int
    t_comm: float
    t_exposed: float
    t_gemm: float
    segments: tuple[SegmentChoice, ...]

    @property
    def chunks(self) -> int:
        """Dominant (most-layers) segment's chunk count — the summary knob."""
        return max(self.segments, key=lambda c: c.layers).chunks

    @property
    def seq_parallel(self) -> bool:
        return max(self.segments, key=lambda c: c.layers).seq_parallel


@dataclasses.dataclass(frozen=True)
class SegmentedSearchResult:
    best: SegmentedStrategyCost
    ranked: tuple[SegmentedStrategyCost, ...]  # ascending summed t_exposed

    def mesh(self) -> tuple[int, int]:
        return (self.best.d1, self.best.d2)


def search_strategy_segments(
    matrix: HierarchicalCommMatrix,
    tp_degree: int,
    *,
    workloads: tuple[SegmentWorkload, ...],
    batch: int,
    seq: int,
    bytes_per_elem: int = 2,
    chunks_options: tuple[int, ...] = (1, 2, 4, 8),
    seq_parallel_options: tuple[bool, ...] = (False, True),
    peak_tflops: float = 200.0,
    algo: str = "ring",
    alpha_s: float = 0.0,
    calibration=None,
    wire_dtype: str = "bf16",
) -> SegmentedSearchResult:
    """Per-segment knob search over a shared (d1, d2) mesh.

    The mesh is global (segment boundaries must agree on the activation
    layout) but (chunks, seq_parallel) are optimized independently per
    segment against that segment's per-kind comm profile, and the mesh
    ranking sums the per-segment exposed times.  ``seq_parallel`` is only
    explored for kinds in :data:`repro_torch.core.atp.SEQ_PARALLEL_KINDS` —
    the same gate execution applies (``ATPContext.for_segment``).

    For a single-segment workload this selects exactly the strategy
    ``search_strategy_overlap`` would (identical knobs and cost): per-mesh
    knob minimization under the same (t_exposed, chunks, seq_parallel)
    key, then the same mesh ranking — the v1/v2 parity pin.
    """
    if not workloads:
        raise ValueError("search_strategy_segments needs >= 1 workload")
    calibration = CalibrationTable.coerce(calibration)
    calib_for, alpha_for, chunk_eff_for, launch_for = _calibration_lookups(
        calibration, alpha_s, wire_dtype)

    meshes = []
    for d1, d2 in factorizations(tp_degree):
        try:
            matrix.axis_bandwidths(d1, d2)
        except ValueError:
            continue
        choices = []
        for w in workloads:
            sp_opts = (seq_parallel_options if w.kind in SEQ_PARALLEL_KINDS
                       else (False,))
            cands = [t_comm_overlap(
                matrix, d1, d2, layers=w.layers, batch=batch, seq=seq,
                profile=w.profile, bytes_per_elem=bytes_per_elem,
                chunks=chunks, seq_parallel=sp, peak_tflops=peak_tflops,
                algo=algo, alpha_s=alpha_for(d1, d2),
                calibrated=calib_for(d1, d2),
                chunk_eff=chunk_eff_for(d1, d2),
                chunk_launch_s=launch_for(d1, d2),
                wire_dtype=wire_dtype)
                for chunks in chunks_options for sp in sp_opts]
            best = min(cands, key=lambda c: (c.t_exposed, c.chunks,
                                             c.seq_parallel))
            choices.append(SegmentChoice(
                kind=w.kind, layers=w.layers, chunks=best.chunks,
                seq_parallel=best.seq_parallel, cost=best))
        meshes.append(SegmentedStrategyCost(
            d1=d1, d2=d2,
            t_comm=sum(c.cost.t_comm for c in choices),
            t_exposed=sum(c.cost.t_exposed for c in choices),
            t_gemm=sum(c.cost.t_gemm for c in choices),
            segments=tuple(choices)))
    if not meshes:
        raise ValueError(
            f"no valid (d1,d2) for tp={tp_degree} on {matrix.name}")
    ranked = tuple(sorted(
        meshes, key=lambda m: (m.t_exposed,
                               tuple((c.chunks, c.seq_parallel)
                                     for c in m.segments))))
    return SegmentedSearchResult(ranked[0], ranked)


# ---------------------------------------------------------------------------
# Latency-aware decode (serving) search.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DecodeSearchResult:
    best: DecodeStrategyCost
    ranked: tuple[DecodeStrategyCost, ...]  # ascending t_step

    def mesh(self) -> tuple[int, int]:
        return (self.best.d1, self.best.d2)


def search_strategy_decode(
    matrix: HierarchicalCommMatrix,
    tp_degree: int,
    *,
    workloads: tuple[SegmentWorkload, ...],
    batch: int,
    bytes_per_elem: int = 2,
    alpha_s: float = DECODE_ALPHA_S,
    launch_s: float = DECODE_LAUNCH_S,
    calibration=None,
    boundary_mode: str | None = None,
    wire_dtype: str = "bf16",
    paged_read=None,
    spec_accept_rate: float | None = None,
) -> DecodeSearchResult:
    """Rank (d1, d2) by modelled per-token decode latency (serve objective).

    Decode boundary all-reduces move ``[B, 1, h]`` activations — per ATP's
    Eq. 4 split the alpha*steps latency term dominates, not the bandwidth
    term the training search (Eq. 2) optimizes — so the winning
    factorization is generally NOT the training winner: eliminating a
    whole boundary family (d1=1 or d2=1) or keeping the TP degree on
    low-hop-latency fabric layers beats balancing payload bytes.  The
    per-factorization ``boundary_mode`` is chosen by the same model (psum
    O(log d) steps vs ring O(d) steps; a calibrated boundary preference
    from the table wins when measured).

    ``calibration`` threads measured (B1, B2) and per-step alpha exactly
    like the training searches; ``batch`` is the decode slot count.
    ``paged_read`` prices the per-tick paged KV gather (exposed only
    where the boundary algorithm can't hide it — see ``t_comm_decode``);
    ``spec_accept_rate`` lets each factorization also bid its MTP
    self-speculative tick.  Both default off, leaving rankings unchanged.
    """
    if not workloads:
        raise ValueError("search_strategy_decode needs >= 1 workload")
    calibration = CalibrationTable.coerce(calibration)
    calib_for, alpha_for, _, _ = _calibration_lookups(
        calibration, alpha_s, wire_dtype)

    costs = []
    for d1, d2 in factorizations(tp_degree):
        try:
            matrix.axis_bandwidths(d1, d2)
        except ValueError:
            continue
        bm = boundary_mode
        if bm is None and calibration is not None:
            bm = calibration.boundary_mode(d1, d2)
        costs.append(t_comm_decode(
            matrix, d1, d2, workloads=workloads, batch=batch,
            bytes_per_elem=bytes_per_elem, alpha_s=alpha_for(d1, d2),
            launch_s=launch_s, calibrated=calib_for(d1, d2),
            boundary_mode=bm, wire_dtype=wire_dtype,
            paged_read=paged_read, spec_accept_rate=spec_accept_rate))
    if not costs:
        raise ValueError(
            f"no valid (d1,d2) for tp={tp_degree} on {matrix.name}")
    ranked = tuple(sorted(costs, key=lambda c: (c.t_step, c.d1)))
    return DecodeSearchResult(ranked[0], ranked)


def recommend_chunks(matrix: HierarchicalCommMatrix, d1: int, d2: int) -> int:
    """Paper §4.1/§5.2 heuristic: chunk 4 on slow fabrics, 2 otherwise.

    Slow fabric := bottleneck algorithm bandwidth under ~30 GB/s (IB-class),
    where Table 3 shows chunk=4 keeps winning; on NVLink-class fabrics the
    gain saturates at chunk=2 and larger chunks hurt small GEMM efficiency.
    """
    from repro_torch.core.cost_model import axis_algorithm_bw

    _, _, b1, b2 = axis_algorithm_bw(matrix, d1, d2)
    bottleneck = min(b for b in (b1, b2) if b != float("inf"))
    return 4 if bottleneck < 30.0 else 2
