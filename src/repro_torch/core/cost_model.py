"""ATP analytic communication cost model (paper §3.3-§3.5, Eq. 2-4;
counterpart of ``repro.core.cost_model``, a copy: the port's plans are
priced with the same arithmetic in the same order).

Beyond the paper's Eq. 2 (``t_comm``), ``t_comm_overlap`` models the
reference's overlap engine (``repro.core.overlap``; ROADMAP A8 in the
port): per-chunk
effective communication time max(0, comm - overlappable GEMM), ring vs.
Rabenseifner algorithm step counts per hierarchy level, and the
sequence-parallel boundary (reduce-scatter wire bytes = half an
all-reduce's, plus the conjugate block-entry all-gather accounted
separately).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

from repro_torch.core.comm_matrix import HierarchicalCommMatrix


def rabenseifner_bw(d: int, raw_bw: float) -> float:
    """Eq. 4: algorithm bandwidth of a d-rank all-reduce on raw link bw."""
    if d <= 1:
        return math.inf
    return d / (2.0 * (d - 1)) * raw_bw


#: wire-transfer factor and ring/rabenseifner step counts per collective
_COLLECTIVE_SHAPE = {
    # op: (transfer fraction of payload, ring steps fn, raben steps fn)
    "all_reduce": (lambda d: 2.0 * (d - 1) / d,
                   lambda d: 2 * (d - 1),
                   lambda d: 2 * math.ceil(math.log2(d))),
    "reduce_scatter": (lambda d: (d - 1) / d,
                       lambda d: d - 1,
                       lambda d: math.ceil(math.log2(d))),
    "all_gather": (lambda d: (d - 1) / d,
                   lambda d: d - 1,
                   lambda d: math.ceil(math.log2(d))),
}


def collective_seconds(
    vol_bytes: float,
    d: int,
    raw_bw_gbps: float,
    *,
    op: str = "all_reduce",
    algo: str = "ring",
    alpha_s: float = 0.0,
) -> float:
    """Time of one collective over a `d`-rank group on raw link bandwidth.

    vol_bytes is the per-device payload (the tensor size); the wire moves
    ``transfer_factor * vol_bytes`` of it.  ``alpha_s`` is the per-step
    latency, where ring uses O(d) steps and Rabenseifner O(log d) — the
    bandwidth term is identical (Eq. 4), so the algorithm choice only
    matters through latency and is what chunking has to amortise.
    """
    if d <= 1 or vol_bytes <= 0.0:
        return 0.0
    transfer, ring_steps, raben_steps = _COLLECTIVE_SHAPE[op]
    steps = ring_steps(d) if algo == "ring" else raben_steps(d)
    return vol_bytes * transfer(d) / (raw_bw_gbps * 1e9) + steps * alpha_s


def _ff_cols(cfg, d_ff: float) -> float:
    """Column-first output width of one MLP up(-and-gate) projection."""
    return 2.0 * d_ff if cfg.mlp_kind in ("swiglu", "geglu") else float(d_ff)


@dataclasses.dataclass(frozen=True)
class LayerCommProfile:
    """Per-layer TP communication volumes (generalizes Eq. 2 per segment kind).

    col_first_out : sum of output dims of column-first GEMMs (all-reduced
                    over mesh dim 2 at size dim/d1).  GPT: qkv 3h + mlp-up
                    4h = 7h.  SwiGLU archs: qkv_dim + 2*d_ff.
    row_first_out : sum of output dims of row-first GEMMs (all-reduced over
                    mesh dim 1 at size dim/d2).  GPT: attn-out h + mlp-down
                    h = 2h.
    col_full_out  : output dims all-reduced over mesh dim 2 at FULL width
                    (not d1-sharded): MLA's compressed-latent
                    down-projections, mamba's replicated zx/B/C/dt
                    projections (the recurrent-state inputs), xlstm's
                    replicated gate pre-activations.
    row_full_out  : output dims all-reduced over mesh dim 1 at FULL width
                    (not d2-sharded): zamba's shared-attention ax1
                    regather, xlstm's w_down/recurrent-h psum(ax1) parts.
                    Priced against B1 with no GEMM-overlap credit.
    flat_dispatch_out : per-token feature widths moved through flat-TP
                    (d1*d2) all-to-all — MoE expert dispatch + combine
                    (2 * top_k * capacity_factor * h); priced on the
                    bottleneck link and never credited with GEMM overlap.

    The per-kind constructors below derive these from a ``ModelConfig``;
    ``for_segment`` dispatches on the model's segment kinds (configs.base
    ``segments``), which is what the per-segment plan search prices.
    """

    col_first_out: float
    row_first_out: float
    hidden: float | None = None  # contraction dim (for GEMM-time modelling)
    col_full_out: float = 0.0
    row_full_out: float = 0.0
    flat_dispatch_out: float = 0.0

    @staticmethod
    def gpt(hidden: int) -> "LayerCommProfile":
        return LayerCommProfile(7.0 * hidden, 2.0 * hidden, hidden=hidden)

    # -- per-segment-kind constructors (derive volumes from ModelConfig) ----

    @staticmethod
    def dense(cfg) -> "LayerCommProfile":
        """GQA attention + dense MLP: fused qkv f1, attn-out f2, up(+gate)
        f3, down f4 (matches models.transformer.dense_block)."""
        col = cfg.q_dim + 2.0 * cfg.kv_dim + _ff_cols(cfg, cfg.d_ff)
        return LayerCommProfile(float(col), 2.0 * cfg.d_model,
                                hidden=float(cfg.d_model))

    @staticmethod
    def moe(cfg) -> "LayerCommProfile":
        """GQA attention + EP MoE FFN: the dense-MLP boundaries are replaced
        by flat-TP all-to-all dispatch bytes (models.moe.moe_block)."""
        mc = cfg.moe
        col = cfg.q_dim + 2.0 * cfg.kv_dim
        row = float(cfg.d_model)  # attn-out f2 only
        if mc.num_shared:  # deepseek shared experts run the dense MLP path
            col += _ff_cols(cfg, mc.d_ff_expert * mc.num_shared)
            row += cfg.d_model
        flat = 2.0 * mc.top_k * mc.capacity_factor * cfg.d_model
        return LayerCommProfile(float(col), row, hidden=float(cfg.d_model),
                                flat_dispatch_out=flat)

    @staticmethod
    def mla_dense(cfg) -> "LayerCommProfile":
        """MLA attention + dense MLP: the latent down-projections psum(ax2)
        at full compressed-KV width (models.mla.mla_block)."""
        m = cfg.mla
        latents = m.q_lora_rank + m.kv_lora_rank + m.qk_rope_head_dim
        return LayerCommProfile(
            _ff_cols(cfg, cfg.d_ff),            # f3 (up+gate)
            2.0 * cfg.d_model,                  # wo + mlp-down row boundaries
            hidden=float(cfg.d_model), col_full_out=float(latents))

    @staticmethod
    def mla_moe(cfg) -> "LayerCommProfile":
        mla = LayerCommProfile.mla_dense(cfg)
        moe = LayerCommProfile.moe(cfg)
        mc = cfg.moe
        col = (mla.col_first_out - _ff_cols(cfg, cfg.d_ff)  # MoE replaces MLP
               + (_ff_cols(cfg, mc.d_ff_expert * mc.num_shared)
                  if mc.num_shared else 0.0))
        row = cfg.d_model + (cfg.d_model if mc.num_shared else 0.0)
        return LayerCommProfile(col, float(row), hidden=float(cfg.d_model),
                                col_full_out=mla.col_full_out,
                                flat_dispatch_out=moe.flat_dispatch_out)

    @staticmethod
    def mamba(cfg) -> "LayerCommProfile":
        """Mamba2 block: replicated zx in-projection + the recurrent-state
        inputs (B/C at 2*d_state, dt at nheads) psum(ax2) at full width;
        out-projection is a standard row boundary."""
        sc = cfg.ssm
        d_inner = sc.expand * cfg.d_model
        nheads = d_inner // sc.head_dim
        state = 2.0 * sc.d_state + nheads       # recurrent-state volume/token
        return LayerCommProfile(
            0.0, float(cfg.d_model), hidden=float(cfg.d_model),
            col_full_out=2.0 * d_inner + state)

    @staticmethod
    def zamba(cfg) -> "LayerCommProfile":
        """One zamba super-block: shared-attention entry (two fused
        column-first h->h projections + full-width ax1 regather) + a dense
        block + (shared_attn_every - 1) mamba blocks."""
        inner = cfg.ssm.shared_attn_every
        d = LayerCommProfile.dense(cfg)
        m = LayerCommProfile.mamba(cfg)
        k = inner - 1
        return LayerCommProfile(
            d.col_first_out + cfg.d_model,               # shared entry proj
            d.row_first_out + k * m.row_first_out,
            hidden=float(cfg.d_model),
            col_full_out=k * m.col_full_out,
            row_full_out=float(cfg.d_model))             # ax1 regather

    @staticmethod
    def xlstm(cfg) -> "LayerCommProfile":
        """One xLSTM super-block: (slstm_every - 1) mLSTM blocks (replicated
        up/gate + qk pre-activations, full-width down psum over both axes)
        + one sLSTM (replicated gates + recurrent h psum(ax1))."""
        sc = cfg.ssm
        inner = sc.slstm_every
        d_up = int(sc.proj_factor * cfg.d_model)
        nh = cfg.num_heads
        dk = (d_up // nh) // 2
        mlstm_col_full = 2.0 * d_up + 2.0 * nh * dk + cfg.d_model
        slstm_col_full = 4.0 * cfg.d_model
        return LayerCommProfile(
            0.0, 0.0, hidden=float(cfg.d_model),
            col_full_out=(inner - 1) * mlstm_col_full + slstm_col_full,
            # per-block w_down / recurrent-h psum(ax1) at full width
            row_full_out=float(inner * cfg.d_model))

    _KIND_DISPATCH = {
        "dense": "dense", "moe": "moe", "mla_dense": "mla_dense",
        "mla_moe": "mla_moe", "mamba": "mamba", "zamba": "zamba",
        "xlstm": "xlstm",
    }

    @staticmethod
    def for_segment(kind: str, cfg) -> "LayerCommProfile":
        """Per-kind profile for one model segment (configs.base.segments)."""
        try:
            ctor = LayerCommProfile._KIND_DISPATCH[kind]
        except KeyError:
            raise ValueError(
                f"no comm profile for segment kind {kind!r}; have "
                f"{sorted(LayerCommProfile._KIND_DISPATCH)}") from None
        return getattr(LayerCommProfile, ctor)(cfg)


@dataclasses.dataclass(frozen=True)
class SegmentWorkload:
    """One model segment's search workload: ``layers`` scan steps of a
    ``profile``-shaped block (super-block kinds fold their inner blocks
    into the profile, so layers == scan count)."""

    kind: str
    layers: int
    profile: LayerCommProfile


def segment_workloads(cfg) -> tuple[SegmentWorkload, ...]:
    """Per-segment (kind, layers, profile) for a ModelConfig — the
    heterogeneous workload the v2 plan search prices and sums."""
    from repro_torch.configs.base import segments

    return tuple(
        SegmentWorkload(kind=s.kind, layers=s.count,
                        profile=LayerCommProfile.for_segment(s.kind, cfg))
        for s in segments(cfg))


@dataclasses.dataclass(frozen=True)
class StrategyCost:
    d1: int
    d2: int
    b1_raw: float
    b2_raw: float
    b1: float
    b2: float
    t_comm: float  # seconds per step


def axis_algorithm_bw(
    matrix: HierarchicalCommMatrix, d1: int, d2: int
) -> tuple[float, float, float, float]:
    """(B1', B2', B1, B2): Eq. 3 raw then Eq. 4 algorithm bandwidths."""
    b1_raw, b2_raw = matrix.axis_bandwidths(d1, d2)
    return b1_raw, b2_raw, rabenseifner_bw(d1, b1_raw), rabenseifner_bw(d2, b2_raw)


def t_comm(
    matrix: HierarchicalCommMatrix,
    d1: int,
    d2: int,
    *,
    layers: int,
    batch: int,
    seq: int,
    profile: LayerCommProfile,
    bytes_per_elem: int = 2,
    calibrated: tuple[float, float] | None = None,
) -> StrategyCost:
    """Generalized Eq. 2, in seconds.

    T = 2*L*b*s * ( C_col/(d1*B2) + C_row/(d2*B1) ) * bytes

    `calibrated` optionally overrides (B1, B2) with measured values
    (paper §5.3, IC1 case).
    """
    b1_raw, b2_raw, b1, b2 = axis_algorithm_bw(matrix, d1, d2)
    if calibrated is not None:
        b1, b2 = calibrated
    tokens = 2.0 * layers * batch * seq * bytes_per_elem  # fwd+bwd factor 2
    term_col = (profile.col_first_out / (d1 * b2)) if d2 > 1 else 0.0
    term_row = (profile.row_first_out / (d2 * b1)) if d1 > 1 else 0.0
    t = tokens * (term_col + term_row) / 1e9  # GB/s -> bytes/s
    return StrategyCost(d1, d2, b1_raw, b2_raw, b1, b2, t)


def factorization_sensitivity(
    matrix: HierarchicalCommMatrix,
    d1: int,
    d2: int,
    *,
    workloads: tuple[SegmentWorkload, ...],
    batch: int,
    seq: int,
    bytes_per_elem: int = 2,
) -> float:
    """Modelled step-seconds riding on this factorization's bandwidth
    numbers: Eq. 2's comm time under the analytic (B1, B2), summed over
    the model's segment workloads.

    Because T is proportional to 1/B, the first-order |dT/d ln B| *is*
    the comm time itself — so this one number ranks how much the
    strategy ranking moves if the analytic bandwidths are wrong for
    this (d1, d2).  Deadline-budgeted recovery
    (``calibrate.recalibrate_surviving(deadline_s=...)``) measures
    factorizations in descending sensitivity: §5.3's IC1 mis-ranking is
    exactly a high-sensitivity entry being wrong, and those are the
    entries a shrinking budget must spend its micro-benchmarks on
    first.
    """
    return sum(
        t_comm(matrix, d1, d2, layers=w.layers, batch=batch, seq=seq,
               profile=w.profile, bytes_per_elem=bytes_per_elem).t_comm
        for w in workloads)


# ---------------------------------------------------------------------------
# Overlap-aware extension (docs/overlap.md).
# ---------------------------------------------------------------------------


def wire_bytes_per_elem(wire_dtype: str, bytes_per_elem: int) -> float:
    """Bytes per element a boundary collective actually moves.

    Mirrors ``overlap.WIRE_DTYPES`` without importing jax: "bf16" is the
    full-width baseline (whatever ``bytes_per_elem`` the caller models),
    int8/fp8 payloads are one byte on the wire (the shared per-chunk
    scale is O(1) per collective — negligible against the payload)."""
    if wire_dtype in ("int8", "fp8"):
        return 1.0
    if wire_dtype != "bf16":
        raise ValueError(
            f"wire_dtype must be 'bf16', 'int8' or 'fp8', got "
            f"{wire_dtype!r}")
    return float(bytes_per_elem)


@dataclasses.dataclass(frozen=True)
class OverlapStrategyCost:
    """Per-(d1, d2, chunks, seq_parallel) modelled step communication.

    t_comm          raw (un-overlapped) collective time per step [s]
    t_exposed       comm time left on the critical path after per-chunk
                    overlap with the producing GEMMs [s]
    t_gemm          boundary-producing GEMM time per step [s]
    ax1_boundary_bytes   wire bytes of the ax1 *boundary* collectives
                    (f2/f4: all-reduce, or reduce-scatter when seq-parallel)
    ax1_total_bytes      ax1 boundary + block-entry gather wire bytes
                    (seq-parallel conserves total fwd+bwd volume; the win is
                    per-op size, overlap granularity and activation memory)
    """

    d1: int
    d2: int
    chunks: int
    seq_parallel: bool
    b1_raw: float
    b2_raw: float
    t_comm: float
    t_exposed: float
    t_gemm: float
    ax1_boundary_bytes: float
    ax1_total_bytes: float
    ax2_boundary_bytes: float
    #: chunks > 1 and every chunk-credited boundary's per-chunk collective
    #: time (incl. per-step latency) fits inside its per-chunk GEMM time —
    #: when True, t_exposed is strictly below the chunks=1 exposure.
    fully_overlapped: bool = False
    #: flat-TP all-to-all wire bytes (MoE expert dispatch + combine)
    flat_dispatch_bytes: float = 0.0


def _exposed(vol_bytes: float, d: int, raw_bw: float, op: str, algo: str,
             alpha_s: float, chunks: int, t_gemm: float) -> float:
    """Critical-path comm after pipelining `chunks` chunks against the
    producing GEMM: chunk k's collective overlaps chunk k+1's GEMM; the
    last chunk's collective is always exposed.  Each chunk pays its own
    per-step latency (chunking amortises bandwidth, not alpha)."""
    if d <= 1:
        return 0.0
    c = max(1, chunks)
    tc = collective_seconds(vol_bytes / c, d, raw_bw, op=op, algo=algo,
                            alpha_s=alpha_s)
    return tc + (c - 1) * max(0.0, tc - t_gemm / c)


def t_comm_overlap(
    matrix: HierarchicalCommMatrix,
    d1: int,
    d2: int,
    *,
    layers: int,
    batch: int,
    seq: int,
    profile: LayerCommProfile,
    bytes_per_elem: int = 2,
    chunks: int = 1,
    seq_parallel: bool = False,
    peak_tflops: float = 200.0,
    algo: str = "ring",
    alpha_s: float = 0.0,
    calibrated: tuple[float, float] | None = None,
    chunk_eff: "Mapping[int, tuple[float, float]] | None" = None,
    chunk_launch_s: float | None = None,
    wire_dtype: str = "bf16",
) -> OverlapStrategyCost:
    """Generalised Eq. 2 with explicit-overlap accounting.

    Per layer and direction (fwd+bwd = factor 2):
      col boundary: payload b*s*C_col/d1 bytes all-reduced over ax2 (d2)
      row boundary: payload b*s*C_row/d2 bytes over ax1 (d1) — all-reduce
        under the replicated block I/O spec, reduce-scatter (+ the
        conjugate block-entry all-gather) under sequence-parallel.
    Effective comm per boundary = _exposed(comm, producing-GEMM, chunks).
    With chunks=1, algo="rabenseifner", alpha_s=0 this reduces exactly to
    Eq. 2 (the parity the strategy-search acceptance test pins down).

    ``calibrated`` overrides (B1, B2) with measured *algorithm* bandwidths
    in the same convention as ``t_comm`` (paper §5.3: all-reduce time =
    payload/B).  Internally the raw link bandwidth is recovered by
    inverting Eq. 4, so a calibrated all-reduce costs exactly payload/B
    regardless of ``algo`` — matching the seed Eq. 2 path bit-for-bit.

    ``chunk_eff`` optionally maps a chunk count to measured per-axis
    bandwidth-efficiency multipliers (ax1, ax2) from the chunked
    micro-benchmark (``calibrate``): splitting a collective into c pieces
    on a real fabric loses efficiency to per-piece overheads the analytic
    exposure model cannot see, so the *chunked* boundary collectives run
    at ``raw_bw * eff`` while the unchunked totals keep the full-payload
    bandwidth.  Absent (or for a chunk count with no entry) the analytic
    exposure model is used unchanged.

    ``chunk_launch_s`` is the measured per-extra-chunk launch cost
    (``CalibEntry.launch_s``): splitting a boundary into c collectives
    pays c-1 extra software launches that no amount of overlap hides.
    Kept separate from ``chunk_eff`` — which since the double-count fix
    prices pure bandwidth loss — and from ``alpha_s`` (per *ring step*
    wire latency, already charged per chunk by ``collective_seconds``).

    ``wire_dtype`` prices the boundary payloads at the quantized wire
    width: "int8"/"fp8" move 1 byte per element instead of
    ``bytes_per_elem``.  GEMM flops are unchanged (compute stays full
    precision) and the MoE flat dispatch keeps full-width activations
    (wire quantization rides the f1..f4 boundary collectives only).
    """
    if profile.hidden is None:
        raise ValueError(
            "t_comm_overlap needs profile.hidden to model GEMM time; use "
            "LayerCommProfile.gpt(...) or pass hidden= explicitly")
    b1_raw, b2_raw = matrix.axis_bandwidths(d1, d2)
    if calibrated is not None:
        cb1, cb2 = calibrated
        # invert Eq. 4: raw = B_alg * 2(d-1)/d (the all-reduce transfer
        # factor), so collective_seconds(vol, d, raw) == vol / B_alg
        if d1 > 1 and cb1 is not None and not math.isinf(cb1):
            b1_raw = cb1 * 2.0 * (d1 - 1) / d1
        if d2 > 1 and cb2 is not None and not math.isinf(cb2):
            b2_raw = cb2 * 2.0 * (d2 - 1) / d2
    steps = 2.0 * layers  # fwd + bwd per layer
    wire_bytes = wire_bytes_per_elem(wire_dtype, bytes_per_elem)
    # col boundary pool: d1-sharded column outputs + full-width (unsharded)
    # psum(ax2) outputs — MLA latents, SSM recurrent-state projections
    vol_col = batch * seq * (profile.col_first_out / max(1, d1)
                             + profile.col_full_out) * wire_bytes
    # row boundary pool: d2-sharded row outputs + full-width psum(ax1)
    # outputs (zamba regather, xlstm recurrent h) — no GEMM-overlap credit
    # is claimed for the full-width part (conservative: it stays exposed)
    vol_row = batch * seq * (profile.row_first_out / max(1, d2)
                             + profile.row_full_out) * wire_bytes

    # producing-GEMM time per boundary group (overlappable work); the
    # full-width outputs' GEMMs shard only over ax2 (K = hidden/d2)
    hidden = profile.hidden
    flops_col = 2.0 * batch * seq * hidden * (
        profile.col_first_out / (d1 * d2) + profile.col_full_out / d2)
    flops_row = 2.0 * batch * seq * hidden * profile.row_first_out / (d1 * d2)
    tg_col = flops_col / (peak_tflops * 1e12)
    tg_row = flops_row / (peak_tflops * 1e12)

    # flat-TP expert dispatch (MoE all-to-all, there + back): bottleneck
    # link, ring-step latency over the flat d1*d2 group, no overlap credit
    n_flat = d1 * d2
    t_flat = 0.0
    flat_bytes = 0.0
    if profile.flat_dispatch_out > 0.0 and n_flat > 1:
        vol_flat = (batch * seq * profile.flat_dispatch_out / n_flat
                    * bytes_per_elem)
        bw_flat = min(b for b, d in ((b1_raw, d1), (b2_raw, d2)) if d > 1)
        flat_steps = (n_flat - 1) if algo == "ring" \
            else math.ceil(math.log2(n_flat))
        t_flat = (vol_flat * (n_flat - 1) / n_flat / (bw_flat * 1e9)
                  + flat_steps * alpha_s)
        flat_bytes = steps * vol_flat * (n_flat - 1) / n_flat

    t_col = (collective_seconds(vol_col, d2, b2_raw, op="all_reduce",
                                algo=algo, alpha_s=alpha_s) if d2 > 1 else 0.0)
    if seq_parallel and d1 > 1:
        t_row = collective_seconds(vol_row, d1, b1_raw, op="reduce_scatter",
                                   algo=algo, alpha_s=alpha_s)
        t_gather = collective_seconds(vol_row, d1, b1_raw, op="all_gather",
                                      algo=algo, alpha_s=alpha_s)
    else:
        t_row = (collective_seconds(vol_row, d1, b1_raw, op="all_reduce",
                                    algo=algo, alpha_s=alpha_s)
                 if d1 > 1 else 0.0)
        t_gather = 0.0

    if seq_parallel and d1 > 1:
        # the psum_scatter row boundary is not batch-chunked by atp_linear
        # (the ring rs collective-matmul pipelines over its own d1 steps);
        # credit no chunk overlap to it — conservative for both modes
        row_boundary_op, row_chunks = "reduce_scatter", 1
    else:
        row_boundary_op, row_chunks = "all_reduce", chunks
    def chunked_bw(raw: float, axis: int, c: int) -> float:
        """Measured per-chunk bandwidth efficiency (1.0 when unmeasured)."""
        if chunk_eff is None or c <= 1:
            return raw
        eff = chunk_eff.get(c)
        if eff is None or eff[axis] is None:
            return raw
        return raw * eff[axis]

    # measured per-extra-chunk launch cost: software overhead paid once
    # per additional collective, never hidden by overlap (satellite fix:
    # this used to be baked into chunk_eff, double-counting alpha)
    launch = chunk_launch_s or 0.0
    t_launch = (max(0, chunks - 1) * launch * (1.0 if d2 > 1 else 0.0)
                + max(0, row_chunks - 1) * launch * (1.0 if d1 > 1 else 0.0))

    t_comm = steps * (t_col + t_row + t_gather + t_flat)
    t_exposed = steps * (
        _exposed(vol_col, d2, chunked_bw(b2_raw, 1, chunks), "all_reduce",
                 algo, alpha_s, chunks, tg_col)
        + _exposed(vol_row, d1, chunked_bw(b1_raw, 0, row_chunks),
                   row_boundary_op, algo, alpha_s, row_chunks, tg_row)
        + t_launch   # per-extra-chunk launches stay on the critical path
        + t_gather   # entry gathers overlap the norm only
        + t_flat)    # dispatch is on the routing critical path
    t_gemm = steps * (tg_col + tg_row)

    # does every chunk-credited boundary hide its per-chunk collective
    # (with its own per-step latency) inside the per-chunk GEMM?
    chunked_boundaries = [
        (vol_col, d2, chunked_bw(b2_raw, 1, chunks), "all_reduce", chunks,
         tg_col),
        (vol_row, d1, chunked_bw(b1_raw, 0, row_chunks), row_boundary_op,
         row_chunks, tg_row),
    ]
    active = [(v, d, bw, op, c, tg) for v, d, bw, op, c, tg
              in chunked_boundaries if d > 1 and c > 1 and v > 0]
    fully_overlapped = bool(active) and all(
        collective_seconds(v / c, d, bw, op=op, algo=algo, alpha_s=alpha_s)
        <= tg / c
        for v, d, bw, op, c, tg in active)

    def wire(vol, d, op):
        if d <= 1:
            return 0.0
        return vol * _COLLECTIVE_SHAPE[op][0](d)

    row_op = "reduce_scatter" if seq_parallel else "all_reduce"
    ax1_boundary = steps * wire(vol_row, d1, row_op)
    ax1_total = ax1_boundary + steps * wire(
        vol_row, d1, "all_gather") * (1.0 if seq_parallel else 0.0)
    ax2_boundary = steps * wire(vol_col, d2, "all_reduce")
    return OverlapStrategyCost(
        d1=d1, d2=d2, chunks=chunks, seq_parallel=seq_parallel,
        b1_raw=b1_raw, b2_raw=b2_raw,
        t_comm=t_comm, t_exposed=t_exposed, t_gemm=t_gemm,
        ax1_boundary_bytes=ax1_boundary, ax1_total_bytes=ax1_total,
        ax2_boundary_bytes=ax2_boundary, fully_overlapped=fully_overlapped,
        flat_dispatch_bytes=flat_bytes)


# ---------------------------------------------------------------------------
# Decode-time (serving) cost: latency-bound per-token boundary collectives.
# ---------------------------------------------------------------------------

#: analytic defaults for the decode objective when no calibration covers
#: the factorization: base per-collective-step latency (an NVLink-class
#: hop; each mesh dim scales it by the comm matrix's ``alpha_factor``) and
#: the fixed software launch/sync cost every collective pays regardless of
#: payload.  Training-side searches keep alpha_s=0 defaults untouched.
DECODE_ALPHA_S = 1.5e-6
DECODE_LAUNCH_S = 6.0e-6


@dataclasses.dataclass(frozen=True)
class PagedReadModel:
    """Per-tick paged-attention KV read cost (the decode cost-model debt:
    measured in the reference's BENCH_serve.json).

    Every decode tick each live slot gathers its whole mapped history
    from the page pools — ``avg_len`` tokens x ``kv_bytes_per_token``
    per layer off HBM, plus the attention FLOPs over those tokens.  The
    per-DEVICE volume is factorization-independent (attention banks are
    sharded over the flat TP degree, MLA latents are replicated — either
    way d1 x d2 is fixed across candidates), so what makes the term
    mesh-RELEVANT is overlap with the boundary collectives: a ring
    pipelines its transfers and leaves bandwidth slack the gather can
    hide in (exposed = max(0, t_read - t_bytes)), while Rabenseifner
    psum's log-step bursts leave nothing to hide behind (fully exposed).
    Candidates with fatter wire terms therefore hide more of the read,
    and the (d1, d2) argmin can flip once the term is priced.

    Build one with :func:`paged_read_model` (derives the per-token bytes
    and FLOPs from a ModelConfig) or construct directly for what-ifs.
    """

    kv_bytes_per_token: float    # per layer, per device
    avg_len: float               # mean mapped history per live slot
    layers: int
    hbm_gbps: float = 800.0
    attn_flops_per_token: float = 0.0   # per layer, per device
    peak_tflops: float = 200.0

    def t_read(self, batch: int) -> float:
        """Seconds per decode tick spent gathering + scoring paged KV."""
        per_tok = (self.kv_bytes_per_token / (self.hbm_gbps * 1e9)
                   + self.attn_flops_per_token / (self.peak_tflops * 1e12))
        return batch * self.avg_len * self.layers * per_tok


def paged_read_model(cfg, *, avg_len: float, tp: int = 1,
                     page_dtype: str = "bf16", hbm_gbps: float = 800.0,
                     peak_tflops: float = 200.0) -> PagedReadModel:
    """Derive a :class:`PagedReadModel` from a ModelConfig.

    Per attention layer a token's cached KV costs ``2 * kv_dim`` elements
    (split over the flat TP degree — banks are tp-sharded); an MLA layer
    caches the replicated latent ``kv_lora_rank + qk_rope_head_dim``.
    Recurrent kinds (mamba/zamba's inner blocks/xlstm) hold O(1) state —
    no per-token read — so only their attention sub-blocks contribute.
    Attention FLOPs per cached token are ``4 * q_dim`` (QK dot + value
    weighting), tp-sharded.  ``page_dtype`` prices quantized pools at
    1 byte/elem (scale reads are per-page, negligible).
    """
    from repro_torch.configs.base import segments

    elem = 1.0 if page_dtype in ("int8", "fp8") else 2.0
    layers = 0
    kv_bytes = 0.0
    flops = 0.0
    for s in segments(cfg):
        if s.kind in ("dense", "moe", "zamba"):
            # zamba: one shared attention block per super-block
            kv_bytes += s.count * 2.0 * cfg.kv_dim * elem / max(1, tp)
            flops += s.count * 4.0 * cfg.q_dim / max(1, tp)
            layers += s.count
        elif s.kind in ("mla_dense", "mla_moe"):
            m = cfg.mla
            kv_bytes += s.count * (m.kv_lora_rank + m.qk_rope_head_dim) * elem
            flops += s.count * 4.0 * cfg.q_dim / max(1, tp)
            layers += s.count
        # mamba / xlstm: O(1) recurrent state, nothing to page-read
    if layers == 0:
        return PagedReadModel(kv_bytes_per_token=0.0, avg_len=avg_len,
                              layers=0, hbm_gbps=hbm_gbps,
                              peak_tflops=peak_tflops)
    # normalize to per-layer averages so t_read(b) = b*len*layers*per_tok
    return PagedReadModel(
        kv_bytes_per_token=kv_bytes / layers, avg_len=avg_len,
        layers=layers, hbm_gbps=hbm_gbps,
        attn_flops_per_token=flops / layers, peak_tflops=peak_tflops)


@dataclasses.dataclass(frozen=True)
class DecodeStrategyCost:
    """Modelled per-decode-step (one token, whole model) cost of (d1, d2).

    Decode boundary all-reduces run on ``[B, 1, h]`` activations, so the
    Eq. 2 bandwidth term nearly vanishes and the cost splits into
    ``t_launch`` (fixed per-collective software overhead — minimized by
    factorizations that *eliminate* whole boundary families: d1=1 kills
    every row boundary, d2=1 every col boundary), ``t_alpha``
    (per-step wire latency: steps(d) x the dim's hop latency) and
    ``t_bytes`` (the residual small-message bandwidth term, which keeps
    the paper's Eq. 2 ranking as the tie-break).  ``boundary_mode`` is
    the cheaper of monolithic psum (Rabenseifner O(log d) steps) and the
    explicit ring (O(d) steps) under this latency model — decode
    virtually always answers "psum", the opposite pressure from the
    bandwidth-bound training objective.

    ``t_read`` is the EXPOSED part of the per-tick paged KV gather when a
    :class:`PagedReadModel` is priced (0.0 otherwise) — rings hide up to
    ``t_bytes`` of it, psum hides none, so it shifts the psum/ring break-
    even and with it the mesh choice.  ``speculate`` marks that this
    candidate's ``t_step`` is the per-ACCEPTED-token cost of the MTP
    self-speculative tick (s=2 payloads + one extra head block, amortized
    over ``1 + accept_rate`` tokens) and that speculation beat the plain
    tick on this interconnect.
    """

    d1: int
    d2: int
    boundary_mode: str
    t_step: float        # seconds per generated token (comm only)
    t_launch: float
    t_alpha: float
    t_bytes: float
    collectives: float   # collective launches per decode step
    t_read: float = 0.0  # exposed paged-read seconds per token
    speculate: bool = False


def t_comm_decode(
    matrix: HierarchicalCommMatrix,
    d1: int,
    d2: int,
    *,
    workloads: "tuple[SegmentWorkload, ...]",
    batch: int,
    bytes_per_elem: int = 2,
    alpha_s: float = DECODE_ALPHA_S,
    launch_s: float = DECODE_LAUNCH_S,
    calibrated: tuple[float, float] | None = None,
    boundary_mode: str | None = None,
    wire_dtype: str = "bf16",
    paged_read: PagedReadModel | None = None,
    spec_accept_rate: float | None = None,
) -> DecodeStrategyCost:
    """Per-token decode communication time of one (d1, d2) factorization.

    Forward-only (no backward factor 2), seq=1, summed over the model's
    segment workloads.  Per layer the same two boundary pools as
    ``t_comm_overlap`` apply, but each *active* pool now costs

        launch_s + steps(d) * alpha_s * alpha_factor(dim) + payload/BW

    and the ranking is dominated by the first two terms (ATP Eq. 4's
    latency split).  ``calibrated`` overrides the algorithm bandwidths as
    everywhere else; a calibrated ``alpha_s`` should be passed by the
    caller (the search threads the table's measured per-step latency).
    ``boundary_mode`` forces psum/ring; default picks the cheaper.
    ``wire_dtype`` prices the boundary payloads at the quantized wire
    width (int8/fp8 = 1 byte/elem), exactly as in ``t_comm_overlap``.

    ``paged_read`` adds the per-tick paged-attention KV gather: its raw
    seconds are factorization-independent, but a ring overlaps streamed
    chunks with the gather (exposed = max(0, t_read - t_bytes)) while
    Rabenseifner's bursty log-steps hide nothing (fully exposed), so the
    term shifts the psum/ring break-even — and with it the chosen mesh.
    ``spec_accept_rate`` additionally evaluates the MTP self-speculative
    tick for each mode: s=2 payloads (2x bandwidth term) plus one extra
    head block (x (L+1)/L on the latency terms), amortized over
    ``1 + accept_rate`` emitted tokens; the candidate wins whenever
    acceptance outruns the overhead, and ``speculate`` records which tick
    shape the returned cost describes.  Both default off (inert).
    """
    b1_raw, b2_raw = matrix.axis_bandwidths(d1, d2)
    if calibrated is not None:
        cb1, cb2 = calibrated
        if d1 > 1 and cb1 is not None and not math.isinf(cb1):
            b1_raw = cb1 * 2.0 * (d1 - 1) / d1
        if d2 > 1 and cb2 is not None and not math.isinf(cb2):
            b2_raw = cb2 * 2.0 * (d2 - 1) / d2
    a1, a2 = matrix.axis_alpha_factors(d1, d2)
    n_flat = d1 * d2
    wire_bytes = wire_bytes_per_elem(wire_dtype, bytes_per_elem)

    def mode_cost(algo: str) -> tuple[float, float, float, float]:
        launch = alpha = byte = coll = 0.0
        for w in workloads:
            p = w.profile
            vol_col = batch * (p.col_first_out / max(1, d1)
                               + p.col_full_out) * wire_bytes
            vol_row = batch * (p.row_first_out / max(1, d2)
                               + p.row_full_out) * wire_bytes
            for vol, d, bw, af in ((vol_col, d2, b2_raw, a2),
                                   (vol_row, d1, b1_raw, a1)):
                if d <= 1 or vol <= 0.0:
                    continue
                transfer, ring_steps, raben_steps = \
                    _COLLECTIVE_SHAPE["all_reduce"]
                steps = (ring_steps(d) if algo == "ring"
                         else raben_steps(d))
                launch += w.layers * launch_s
                alpha += w.layers * steps * alpha_s * af
                byte += w.layers * vol * transfer(d) / (bw * 1e9)
                coll += w.layers
            if p.flat_dispatch_out > 0.0 and n_flat > 1:
                # MoE dispatch+combine: two flat all-to-alls per layer
                vol_flat = (batch * p.flat_dispatch_out / n_flat
                            * bytes_per_elem)
                bw_flat = min(b for b, d in ((b1_raw, d1), (b2_raw, d2))
                              if d > 1)
                af_flat = max(a for a, d in ((a1, d1), (a2, d2)) if d > 1)
                fsteps = ((n_flat - 1) if algo == "ring"
                          else math.ceil(math.log2(n_flat)))
                launch += w.layers * 2 * launch_s
                alpha += w.layers * 2 * fsteps * alpha_s * af_flat
                byte += (w.layers * vol_flat * (n_flat - 1) / n_flat
                         / (bw_flat * 1e9))
                coll += 2 * w.layers
        return launch, alpha, byte, coll

    t_read_raw = paged_read.t_read(batch) if paged_read is not None else 0.0
    L_total = sum(w.layers for w in workloads)
    mtp_factor = (L_total + 1) / L_total if L_total > 0 else 1.0

    modes = ([boundary_mode] if boundary_mode is not None
             else ["psum", "ring"])
    best = None
    for bm in modes:
        algo = "ring" if bm == "ring" else "rabenseifner"
        launch, alpha, byte, coll = mode_cost(algo)
        # ring streams its transfers — the paged gather hides in the
        # bandwidth slack; psum's bursty log-steps expose it fully
        exposed = (max(0.0, t_read_raw - byte) if bm == "ring"
                   else t_read_raw)
        cands = [DecodeStrategyCost(
            d1=d1, d2=d2, boundary_mode=bm,
            t_step=launch + alpha + byte + exposed,
            t_launch=launch, t_alpha=alpha, t_bytes=byte, collectives=coll,
            t_read=exposed)]
        if spec_accept_rate is not None:
            # speculative tick: s=2 payloads double the bandwidth term,
            # the extra MTP head block scales the per-layer terms by
            # (L+1)/L, and 1 + accept_rate tokens come out per tick
            exposed_spec = (max(0.0, t_read_raw - 2.0 * byte)
                            if bm == "ring" else t_read_raw)
            t_tick = ((launch + alpha + 2.0 * byte) * mtp_factor
                      + exposed_spec)
            cands.append(DecodeStrategyCost(
                d1=d1, d2=d2, boundary_mode=bm,
                t_step=t_tick / (1.0 + spec_accept_rate),
                t_launch=launch * mtp_factor, t_alpha=alpha * mtp_factor,
                t_bytes=2.0 * byte * mtp_factor, collectives=coll,
                t_read=exposed_spec, speculate=True))
        for cand in cands:
            if best is None or cand.t_step < best.t_step:
                best = cand
    return best
