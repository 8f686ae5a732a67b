"""ParallelPlan: the single serializable strategy artifact (paper §3.5, §5.3;
counterpart of ``repro.core.plan``, a copy: a plan's JSON crosses between
the two packages unchanged, format v5 with the v1-v4 migration).

ATP's thesis is that the *searched* strategy drives execution.  This module
makes that literal: ``plan_search`` ranks the whole strategy space —
DeviceMesh(d1, d2) x chunks x seq_parallel, optionally re-weighted by an
on-mesh :class:`~repro_torch.core.calibrate.CalibrationTable` — and emits frozen,
JSON-round-trippable :class:`ParallelPlan` objects.  Every execution layer
(``make_context(plan=...)``, the ``launch/steps`` builders, the train /
serve / dryrun launchers, the elastic trainer restart path and the paper
benchmarks) consumes a plan instead of loose kwargs, so a strategy can be
saved, diffed, shipped and re-applied:

    plan = plan_search("ic4", 16, layers=..., batch=..., seq=...,
                       profile=prof).best
    plan.save("plan.json")                    # -> CI artifact / flag file
    ctx = make_context(plan=ParallelPlan.load("plan.json"))   # identical

``plan_search(..., chunks_options=(1,), seq_parallel_options=(False,),
algo="rabenseifner", alpha_s=0)`` degrades exactly to the seed Eq. 2
``search_strategy`` ranking (pinned by tests on IC1-IC6).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Mapping

from repro_torch.core import comm_matrix
from repro_torch.core.atp import WIRE_DTYPES, DecodePlan, SegmentPlan
from repro_torch.core.calibrate import CalibrationTable, surviving_tp
from repro_torch.core.comm_matrix import HierarchicalCommMatrix
from repro_torch.core.cost_model import (DECODE_ALPHA_S, DECODE_LAUNCH_S,
                                   LayerCommProfile, OverlapStrategyCost,
                                   SegmentWorkload, segment_workloads)
from repro_torch.core.mesh import MeshTopo, atp_topo
from repro_torch.core.search import (search_strategy_decode,
                               search_strategy_overlap,
                               search_strategy_segments)

#: v2 added per-segment ``SegmentPlan`` tuples (heterogeneous per-segment
#: overlap strategies); v3 adds the optional ``decode`` sub-plan (the
#: latency-aware serve objective's factorization + boundary_mode); v4 adds
#: ``wire_dtype`` (quantized boundary collectives) on the plan, its
#: segments and its decode sub-plan; v5 adds the decode sub-plan's
#: ``speculate`` / ``prefix_cache`` serving knobs (MTP self-speculative
#: decode priced by the search, copy-on-write prefix sharing).  v1-v4
#: files load unchanged — v1 global knobs broadcast to every segment
#: (``segment_plan``), a missing ``decode`` means "serve with the train
#: knobs" (the pre-v3 behavior), a missing ``wire_dtype`` means
#: full-width "bf16" (the pre-v4 behavior), and missing
#: ``speculate``/``prefix_cache`` mean False (the pre-v5 behavior).
#: Newer versions still fail loudly.
PLAN_FORMAT_VERSION = 5


@dataclasses.dataclass(frozen=True)
class PredictedCost:
    """Modelled per-step seconds behind a plan choice (provenance, not input)."""

    t_comm: float
    t_exposed: float
    t_gemm: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Mapping) -> "PredictedCost":
        return PredictedCost(t_comm=float(d["t_comm"]),
                             t_exposed=float(d["t_exposed"]),
                             t_gemm=float(d["t_gemm"]))


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """One complete, serializable parallelization strategy.

    Only (d1, d2, dp, pods, chunks, boundary_mode, seq_parallel, segments)
    affect execution — ``context()`` is a pure function of them.
    ``topology``, ``calibration``, ``predicted`` and ``provenance`` record
    *why* the plan was chosen, so saved artifacts are auditable and
    re-searchable.

    ``segments`` (format_version 2) carries one :class:`SegmentPlan` per
    model segment kind over the shared (d1, d2, dp) mesh; the scalar
    (chunks, boundary_mode, seq_parallel) stay as the defaults broadcast
    to kinds with no dedicated entry — which is exactly how v1 files
    load.
    """

    d1: int
    d2: int
    dp: int = 1
    pods: int = 1
    chunks: int = 1
    boundary_mode: str = "psum"
    seq_parallel: bool = False
    #: boundary-collective payload dtype (format_version 4): "bf16" full
    #: width, "int8"/"fp8" quantized wire — the default broadcast to
    #: segments with no dedicated entry, exactly like the other knobs
    wire_dtype: str = "bf16"
    segments: tuple[SegmentPlan, ...] = ()
    #: decode-time sub-plan (format_version 3): the serve objective's
    #: factorization/boundary choice; None = serve with the train knobs
    decode: DecodePlan | None = None
    topology: str | None = None  # comm-matrix preset name (if any)
    calibration: CalibrationTable | None = None
    predicted: PredictedCost | None = None
    provenance: tuple[tuple[str, str], ...] = ()

    def __post_init__(self):
        if self.d1 < 1 or self.d2 < 1 or self.dp < 1 or self.pods < 1:
            raise ValueError(f"plan degrees must be >= 1: {self}")
        if self.chunks < 1:
            raise ValueError(f"plan chunks must be >= 1, got {self.chunks}")
        if self.boundary_mode not in ("psum", "ring"):
            raise ValueError(
                f"boundary_mode must be 'psum' or 'ring', got "
                f"{self.boundary_mode!r}")
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(
                f"wire_dtype must be one of {WIRE_DTYPES}, got "
                f"{self.wire_dtype!r}")
        object.__setattr__(self, "segments", tuple(self.segments))
        kinds = [s.kind for s in self.segments]
        if len(set(kinds)) != len(kinds):
            raise ValueError(f"duplicate segment kinds in plan: {kinds}")
        # canonical provenance ordering so equality survives JSON round-trips
        object.__setattr__(self, "provenance", tuple(sorted(
            (str(k), str(v)) for k, v in self.provenance)))

    # -- execution ---------------------------------------------------------

    @property
    def tp(self) -> int:
        return self.d1 * self.d2

    @property
    def devices(self) -> int:
        return self.pods * self.dp * self.tp

    def topo(self) -> MeshTopo:
        """The logical mesh this plan prescribes."""
        return atp_topo(self.dp, self.d1, self.d2, pods=self.pods)

    def context(self, topo: MeshTopo | None = None, *,
                device_type: str = "cuda"):
        """Build the ATPContext this plan prescribes (on ``topo`` if given;
        process groups over ``device_type`` on a mesh of several ranks)."""
        from repro_torch.core.atp import make_context

        return make_context(topo if topo is not None else self.topo(),
                            plan=self, device_type=device_type)

    def segment_plan(self, kind: str) -> SegmentPlan:
        """This kind's knobs — a dedicated v2 entry, or the plan's global
        knobs broadcast (the v1-file migration rule)."""
        for seg in self.segments:
            if seg.kind == kind:
                return seg
        return SegmentPlan(kind=kind, chunks=self.chunks,
                           boundary_mode=self.boundary_mode,
                           seq_parallel=self.seq_parallel,
                           wire_dtype=self.wire_dtype)

    def decode_view(self) -> "ParallelPlan":
        """The plan a decode-dominated serving deployment executes.

        With no ``decode`` sub-plan this is the plan itself (pre-v3
        behavior: serve with the train knobs).  Otherwise the decode
        factorization replaces (d1, d2) — the serving stack builds its
        mesh from this view up front, since prefill and decode share one
        set of sharded params/caches — and every knob collapses to the
        decode choice: chunks=1, the decode boundary_mode, seq_parallel
        off globally and per segment.  The sub-plan and the carried
        calibration/provenance stay attached for audit.
        """
        if self.decode is None:
            return self
        dec = self.decode
        segs = tuple(SegmentPlan(kind=s.kind, chunks=dec.chunks,
                                 boundary_mode=dec.boundary_mode,
                                 seq_parallel=False,
                                 wire_dtype=dec.wire_dtype)
                     for s in self.segments)
        return self.with_(
            d1=dec.d1, d2=dec.d2, chunks=dec.chunks,
            boundary_mode=dec.boundary_mode, seq_parallel=False,
            wire_dtype=dec.wire_dtype, segments=segs,
            provenance=self.provenance + (
                ("decode_view", f"serving on DeviceMesh({dec.d1},{dec.d2})"),))

    @property
    def calibration_stale(self) -> bool:
        """True when the carried calibration table predates an elastic
        resize (it was measured on a mesh this plan no longer runs on)."""
        return ("calibration", "stale") in self.provenance

    def describe(self) -> str:
        sp = "+sp" if self.seq_parallel else ""
        wd = "" if self.wire_dtype == "bf16" else f" wire={self.wire_dtype}"
        out = (f"DeviceMesh({self.d1},{self.d2}) dp={self.dp} "
               f"chunks={self.chunks} {self.boundary_mode}{sp}{wd}")
        if self.segments:
            out += (" segments["
                    + " ".join(s.describe() for s in self.segments) + "]")
        if self.decode is not None:
            out += " " + self.decode.describe()
        if self.calibration_stale:
            out += " [calibration:stale]"
        if self.calibration is not None:
            counts = self.calibration.provenance_counts()
            budgeted = any(k == "calibration" and v.startswith("budget ")
                           for k, v in self.provenance)
            # only worth a line when recovery actually degraded something
            # (or a deadline budget ran): all-measured tables are the norm
            if budgeted or any(p != "measured" for p in counts):
                out += (" calib["
                        + " ".join(f"{k}={counts[k]}"
                                   for k in sorted(counts)) + "]")
        return out

    def with_(self, **changes) -> "ParallelPlan":
        """Functional update (e.g. re-binding dp to a new device count)."""
        return dataclasses.replace(self, **changes)

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "format_version": PLAN_FORMAT_VERSION,
            "d1": self.d1, "d2": self.d2, "dp": self.dp, "pods": self.pods,
            "chunks": self.chunks, "boundary_mode": self.boundary_mode,
            "seq_parallel": self.seq_parallel,
            "wire_dtype": self.wire_dtype,
            "segments": [s.to_dict() for s in self.segments],
            "decode": (self.decode.to_dict()
                       if self.decode is not None else None),
            "topology": self.topology,
            "calibration": (self.calibration.to_dict()
                            if self.calibration is not None else None),
            "predicted": (self.predicted.to_dict()
                          if self.predicted is not None else None),
            # list-of-pairs, not an object: tag keys may repeat (e.g. two
            # successive "elastic" resizes) and must all survive round-trip
            "provenance": [[k, v] for k, v in self.provenance],
        }

    @staticmethod
    def from_dict(d: Mapping) -> "ParallelPlan":
        ver = d.get("format_version", PLAN_FORMAT_VERSION)
        if ver > PLAN_FORMAT_VERSION:
            raise ValueError(
                f"plan format_version {ver} is newer than supported "
                f"({PLAN_FORMAT_VERSION}); upgrade the repro_torch package")
        calib = d.get("calibration")
        pred = d.get("predicted")
        prov = d.get("provenance", ())
        prov_pairs = prov.items() if isinstance(prov, Mapping) else prov
        return ParallelPlan(
            d1=int(d["d1"]), d2=int(d["d2"]),
            dp=int(d.get("dp", 1)), pods=int(d.get("pods", 1)),
            chunks=int(d.get("chunks", 1)),
            boundary_mode=d.get("boundary_mode", "psum"),
            seq_parallel=bool(d.get("seq_parallel", False)),
            # absent in v1-v3 files: full-width boundary collectives
            wire_dtype=d.get("wire_dtype", "bf16"),
            # absent in v1 files: the global knobs above broadcast to every
            # segment through ``segment_plan`` / ``ATPContext.for_segment``
            segments=tuple(SegmentPlan.from_dict(s)
                           for s in d.get("segments", ())),
            # absent in v1/v2 files: no decode sub-plan — serving runs the
            # train knobs, exactly the pre-v3 behavior
            decode=(DecodePlan.from_dict(d["decode"])
                    if d.get("decode") is not None else None),
            topology=d.get("topology"),
            calibration=(CalibrationTable.from_dict(calib)
                         if calib is not None else None),
            predicted=(PredictedCost.from_dict(pred)
                       if pred is not None else None),
            provenance=tuple((str(k), str(v)) for k, v in prov_pairs),
        )

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "ParallelPlan":
        return ParallelPlan.from_dict(json.loads(s))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return path

    @staticmethod
    def load(path: str) -> "ParallelPlan":
        with open(path) as f:
            return ParallelPlan.from_json(f.read())


# ---------------------------------------------------------------------------
# Unified strategy search.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanSearchResult:
    best: ParallelPlan
    ranked: tuple[ParallelPlan, ...]          # ascending modelled cost
    costs: tuple[OverlapStrategyCost, ...]    # aligned with ``ranked``

    def mesh(self) -> tuple[int, int]:
        return (self.best.d1, self.best.d2)


def _resolve_matrix(matrix) -> tuple[HierarchicalCommMatrix, str | None]:
    if isinstance(matrix, str):
        if matrix not in comm_matrix.PRESETS:
            raise ValueError(f"unknown topology preset {matrix!r}; "
                             f"have {sorted(comm_matrix.PRESETS)}")
        return comm_matrix.PRESETS[matrix](), matrix
    return matrix, None


def plan_search(
    matrix: HierarchicalCommMatrix | str,
    tp_degree: int,
    *,
    batch: int,
    seq: int,
    layers: int | None = None,
    profile: LayerCommProfile | None = None,
    model=None,
    dp: int = 1,
    pods: int = 1,
    bytes_per_elem: int = 2,
    chunks_options: tuple[int, ...] = (1, 2, 4, 8),
    seq_parallel_options: tuple[bool, ...] = (False, True),
    peak_tflops: float = 200.0,
    algo: str = "ring",
    alpha_s: float = 0.0,
    calibration: CalibrationTable | Mapping | None = None,
    boundary_mode: str | None = None,
    wire_dtype: str = "bf16",
    decode_batch: int | None = None,
    decode_alpha_s: float = DECODE_ALPHA_S,
    decode_launch_s: float = DECODE_LAUNCH_S,
    decode_paged_read=None,
    decode_accept_rate: float | None = None,
    decode_prefix_cache: bool = False,
) -> PlanSearchResult:
    """Rank the full strategy space and emit ParallelPlans.

    The one entry point subsuming the seed's two searches:

      - overlap knobs wide open (the defaults) == ``search_strategy_overlap``
        extended with calibration;
      - ``chunks_options=(1,)``, ``seq_parallel_options=(False,)``,
        ``algo="rabenseifner"``, ``alpha_s=0`` == the seed Eq. 2
        ``search_strategy`` ranking, exactly.

    Two workload forms:

      - ``layers=`` + ``profile=``: one homogeneous per-layer profile (the
        v1 API) — emits plans with no ``segments`` (global knobs only);
      - ``model=`` (a ModelConfig): heterogeneous per-segment search — each
        model segment's (chunks, seq_parallel) is optimized against its
        per-kind comm profile (``cost_model.segment_workloads``) over the
        shared mesh, segment costs are summed, and the emitted plans carry
        one :class:`SegmentPlan` per segment.  For a single-dense-segment
        model this selects the identical strategy as the v1 form with
        ``profile=LayerCommProfile.dense(model)`` (the parity pin).

    ``calibration`` accepts a :class:`CalibrationTable` or a seed-style
    ``{(d1,d2): (B1,B2)}`` dict; measured bandwidths (and measured per-step
    latencies, when the table has them) override Eq. 3/4 for the
    factorizations they cover and the winning plan carries the table.
    ``boundary_mode`` forces psum/ring; by default it follows the
    calibration's measured preference (falling back to "psum").

    ``wire_dtype`` prices the boundary collectives at the quantized wire
    width ("int8"/"fp8" move 1 byte per element instead of
    ``bytes_per_elem``; quantized-collective bandwidths from the
    calibration table override Eq. 3/4 where measured), so quantization
    can flip the optimal (d1, d2)/chunks/boundary_mode — and the emitted
    plans carry the knob into execution.

    ``decode_batch`` (the serving slot count) additionally runs the
    latency-aware decode objective (``search_strategy_decode``) over the
    same strategy space and attaches its winner as a :class:`DecodePlan`
    to every emitted plan — decode boundary all-reduces on ``[B, 1, h]``
    activations are latency-bound, so the serve factorization may differ
    from the train/prefill one; ``ParallelPlan.decode_view`` is the
    execution side of that split.

    ``decode_paged_read`` (a :class:`cost_model.PagedReadModel`) adds the
    per-tick paged-attention KV read term — exposed under bursty psum
    boundaries, partially hidden behind a ring's pipelined transfers —
    which can flip the chosen decode mesh.  ``decode_accept_rate`` (the
    measured/expected MTP draft acceptance rate) makes the search price
    self-speculative decode per candidate; when it wins, the emitted
    DecodePlan records ``speculate=True``.  ``decode_prefix_cache``
    stamps the admission-time COW prefix sharing knob onto the sub-plan
    (an admission policy, not a per-mesh cost).
    """
    hm, preset = _resolve_matrix(matrix)
    calibration = CalibrationTable.coerce(calibration)
    if model is None and (layers is None or profile is None):
        raise TypeError("plan_search needs layers= + profile=, or model=")

    if model is not None:
        workloads = segment_workloads(model)
        res = search_strategy_segments(
            hm, tp_degree, workloads=workloads, batch=batch, seq=seq,
            bytes_per_elem=bytes_per_elem, chunks_options=chunks_options,
            seq_parallel_options=seq_parallel_options,
            peak_tflops=peak_tflops, algo=algo, alpha_s=alpha_s,
            calibration=calibration, wire_dtype=wire_dtype)
        workload_tag = (f"model={model.name} "
                        f"segments={'+'.join(f'{w.kind}x{w.layers}' for w in workloads)} "
                        f"batch={batch} seq={seq} bytes={bytes_per_elem}")
    else:
        res = search_strategy_overlap(
            hm, tp_degree, layers=layers, batch=batch, seq=seq,
            profile=profile, bytes_per_elem=bytes_per_elem,
            chunks_options=chunks_options,
            seq_parallel_options=seq_parallel_options,
            peak_tflops=peak_tflops, algo=algo, alpha_s=alpha_s,
            calibration=calibration, wire_dtype=wire_dtype)
        workload_tag = (f"layers={layers} batch={batch} seq={seq} "
                        f"bytes={bytes_per_elem}")

    decode_plan = None
    if decode_batch is not None:
        dworkloads = (segment_workloads(model) if model is not None else
                      (SegmentWorkload(kind="dense", layers=layers,
                                       profile=profile),))
        dres = search_strategy_decode(
            hm, tp_degree, workloads=dworkloads, batch=decode_batch,
            bytes_per_elem=bytes_per_elem, alpha_s=decode_alpha_s,
            launch_s=decode_launch_s, calibration=calibration,
            boundary_mode=boundary_mode, wire_dtype=wire_dtype,
            paged_read=decode_paged_read,
            spec_accept_rate=decode_accept_rate)
        decode_plan = DecodePlan(
            d1=dres.best.d1, d2=dres.best.d2,
            boundary_mode=dres.best.boundary_mode,
            wire_dtype=wire_dtype,
            speculate=getattr(dres.best, "speculate", False),
            prefix_cache=decode_prefix_cache,
            predicted_t_step=dres.best.t_step)

    prov = (
        ("searcher", "plan_search"),
        ("matrix", hm.name),
        ("algo", algo),
        ("alpha_s", repr(alpha_s)),
        ("peak_tflops", repr(peak_tflops)),
        ("workload", workload_tag),
        ("calibrated", "yes" if calibration is not None else "no"),
    )
    if wire_dtype != "bf16":
        prov += (("wire_dtype", wire_dtype),)
    if decode_plan is not None:
        extras = ""
        if decode_plan.speculate:
            extras += f" +spec(accept={decode_accept_rate})"
        if decode_plan.prefix_cache:
            extras += " +prefix_cache"
        if decode_paged_read is not None:
            extras += " +paged_read"
        prov += (("decode",
                  f"objective=serve batch={decode_batch} -> "
                  f"DeviceMesh({decode_plan.d1},{decode_plan.d2}) "
                  f"{decode_plan.boundary_mode}{extras}"),)

    def boundary_for(d1: int, d2: int) -> str:
        bm = boundary_mode
        if bm is None and calibration is not None:
            bm = calibration.boundary_mode(d1, d2)
        return bm or "psum"

    def to_plan(c) -> ParallelPlan:
        """c: OverlapStrategyCost (v1) or SegmentedStrategyCost (model=);
        both expose d1/d2/chunks/seq_parallel/t_* with the same meaning
        (segmented summary knobs are the dominant segment's)."""
        bm = boundary_for(c.d1, c.d2)
        segs = ()
        if model is not None:
            segs = tuple(SegmentPlan(
                kind=s.kind, chunks=s.chunks, boundary_mode=bm,
                seq_parallel=s.seq_parallel,
                wire_dtype=wire_dtype) for s in c.segments)
        return ParallelPlan(
            d1=c.d1, d2=c.d2, dp=dp, pods=pods, chunks=c.chunks,
            boundary_mode=bm, seq_parallel=c.seq_parallel,
            wire_dtype=wire_dtype, segments=segs,
            decode=decode_plan, topology=preset, calibration=calibration,
            predicted=PredictedCost(t_comm=c.t_comm, t_exposed=c.t_exposed,
                                    t_gemm=c.t_gemm),
            provenance=prov)

    ranked = tuple(to_plan(c) for c in res.ranked)
    return PlanSearchResult(best=ranked[0], ranked=ranked, costs=res.ranked)


def replan_elastic(
    plan: ParallelPlan,
    n_devices: int,
    *,
    layers: int | None = None,
    batch: int | None = None,
    seq: int | None = None,
    profile: LayerCommProfile | None = None,
    model=None,
) -> ParallelPlan:
    """Derive a plan for a surviving device pool (elastic restart).

    Data-parallel replicas absorb the loss first (they are fungible); the
    TP degree is halved only when even dp=1 no longer fits.  dp never
    *grows* past the original plan's dp*pods — a re-plan may only shrink
    the job, not silently expand it onto devices the user never asked
    for.  When the workload is known (``layers``+``profile``, or
    ``model``) and the plan records its topology preset, the surviving TP
    degree is re-searched from scratch; otherwise the mesh is
    re-factorized arithmetically and every other knob is kept.  The
    result records the resize in its provenance.

    The calibration table is *kept* across a TP-degree change — its
    measurements may still cover surviving factorizations — but the plan
    is tagged ``calibration: stale`` (visible in ``describe()`` and via
    ``calibration_stale``), so a consumer knows the numbers predate the
    resize and can re-run ``calibrate_mesh`` on the surviving mesh.  A
    plan whose provenance records a ``calibrate.recalibrate_surviving``
    pass for the surviving degree (and whose table ``covers_tp`` it) is
    not tagged: the re-search below then ranks with fresh measurements.
    Key coverage alone is deliberately not trusted — an external table
    may legitimately key several TP degrees without any of them having
    been measured on *this* surviving mesh.
    """
    if n_devices < 1:
        raise ValueError("no surviving devices to re-plan onto")
    tp = surviving_tp(plan.tp, n_devices)
    dp = max(1, min(plan.dp * plan.pods, n_devices // tp))
    tag = ("elastic", f"replanned {plan.devices}->{n_devices} devices")
    # a carried table goes (or stays) stale when the TP degree changed,
    # unless it has been recalibrated for the surviving degree
    recalibrated = (
        plan.calibration is not None and plan.calibration.covers_tp(tp)
        and any(k == "calibration"
                and v.startswith(f"recalibrated tp={tp} ")
                for k, v in plan.provenance))
    now_stale = plan.calibration is not None and not recalibrated and (
        tp != plan.tp or plan.calibration_stale)
    stale_tags = ((("calibration", "stale"),)
                  if now_stale and not plan.calibration_stale else ())
    workload_known = (model is not None and None not in (batch, seq)) or \
        None not in (layers, batch, seq, profile)
    if workload_known and plan.topology is not None:
        res = plan_search(
            plan.topology, tp, layers=layers, batch=batch, seq=seq,
            profile=profile, model=model, dp=dp,
            calibration=plan.calibration)
        best = res.best
        fresh_stale = ((("calibration", "stale"),) if now_stale else ())
        # re-searched provenance is fresh; keep the audit trail of any
        # recalibration tags the incoming plan carried
        carried = tuple(p for p in plan.provenance
                        if p[0] == "calibration" and p[1] != "stale")
        return best.with_(
            provenance=best.provenance + (tag,) + carried + fresh_stale)
    if tp == plan.tp:
        return plan.with_(dp=dp, pods=1,
                          provenance=plan.provenance + (tag,))
    import math as _math

    d1 = _math.gcd(plan.d1, tp)
    return plan.with_(d1=d1, d2=tp // d1, dp=dp, pods=1,
                      provenance=plan.provenance + (tag,) + stale_tags)
