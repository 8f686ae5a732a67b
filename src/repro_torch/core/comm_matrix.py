"""Hierarchical communication matrix (paper §3.4; counterpart of
``repro.core.comm_matrix``, a copy of its model and presets plus two H100
presets).

A topology is described as an ordered list of layers, outermost (layer 1)
first.  Each layer has R ranks (sub-groups at that level), a P2P bandwidth
(aggregate GB/s between two ranks of the layer) and a *group bandwidth*
(aggregate GB/s from one rank-group to the rest of the world).

Effective all-reduce link bandwidth for a group of ``k`` ranks inside one
layer follows the paper's correction rule: the ring algorithm on k of R
ranks cannot exceed ``p2p * (k - 1)`` (a 2-rank group only has one peer
link), capped by the group bandwidth:

    eff(layer, k) = min(group_bw, p2p * (k - 1))      (k >= 2)

which reproduces both worked examples of Figure 7 (NVSwitch node: k=4 ->
600 GB/s; dual-GPU pair: k=2 -> 200 GB/s < 600 group).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class CommLayer:
    name: str
    ranks: int        # R_i sub-groups at this level
    p2p_bw: float     # GB/s between two ranks at this level
    group_bw: float   # GB/s one rank-group <-> everything else
    #: relative per-collective-step latency of a hop crossing this layer,
    #: as a multiple of the fabric's base alpha_s (NVLink-class hop = 1).
    #: Only the latency-bound decode objective reads this — the training
    #: cost model (Eq. 2-4) is bandwidth-bound and ignores it.
    alpha_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class HierarchicalCommMatrix:
    """Layers ordered outermost -> innermost."""

    name: str
    layers: tuple[CommLayer, ...]

    @property
    def num_devices(self) -> int:
        return math.prod(l.ranks for l in self.layers)

    def effective_bw(self, layer: CommLayer, k: int) -> float:
        if k <= 1:
            return math.inf
        return min(layer.group_bw, layer.p2p_bw * (k - 1))

    def dim_layer_spans(self, d1: int, d2: int) -> tuple[list[tuple[int, int]], list[tuple[int, int]]]:
        """Assign mesh dims to layers: dim2 consumes innermost layers first.

        Returns, per dim, [(layer_index, k)] where k is the per-group rank
        factor the dim uses inside that layer.  A layer may be split between
        dims (k < R); `capacity[i]` tracks the unconsumed factor per layer.
        """
        n = self.num_devices
        if d1 * d2 > n:
            raise ValueError(f"mesh {d1}x{d2} larger than topology ({n})")
        capacity = [l.ranks for l in self.layers]

        def consume(need: int, spans: list[tuple[int, int]]):
            # innermost-first over layers with remaining capacity
            for i in range(len(self.layers) - 1, -1, -1):
                if need == 1:
                    break
                if capacity[i] == 1:
                    continue
                k = min(need, capacity[i])
                if capacity[i] % k:
                    k = math.gcd(need, capacity[i])
                    if k == 1:
                        continue
                spans.append((i, k))
                capacity[i] //= k
                need //= k
            if need != 1:
                raise ValueError(
                    f"mesh dim does not embed into topology {self.name}"
                )

        spans2: list[tuple[int, int]] = []
        consume(d2, spans2)
        spans1: list[tuple[int, int]] = []
        consume(d1, spans1)
        return spans1, spans2

    def axis_bandwidths(self, d1: int, d2: int) -> tuple[float, float]:
        """Paper Eq. 3: (B1', B2') raw link bandwidths for the two mesh dims.

        Sharing rule (generalizes the paper's "divide by d2"): when a dim
        spans layer j, every rank of layer j is a subtree; the groups of
        *this* dim whose members live inside one subtree all share that
        subtree's uplinks.  Their count is the product of the *other* dim's
        per-layer factors at layers strictly inner than j.  This reproduces
        the paper's worked examples: Fig. 7a DeviceMesh(8,2) -> B1'=12.5,
        B2'=200; flat IB-16 DeviceMesh(8,2) -> B1'=25 (no sharing, each
        device has its own port); IC6 4x4 torus (4,4) -> B1'=B2'=50.
        """
        spans1, spans2 = self.dim_layer_spans(d1, d2)

        def dim_bw(own: list[tuple[int, int]], other: list[tuple[int, int]]) -> float:
            best = math.inf
            for j, k in own:
                share = math.prod(k2 for i2, k2 in other if i2 > j)
                best = min(best, self.effective_bw(self.layers[j], k) / share)
            return best

        b1 = dim_bw(spans1, spans2)
        b2 = dim_bw(spans2, spans1)
        return b1, b2

    def axis_alpha_factors(self, d1: int, d2: int) -> tuple[float, float]:
        """Per-mesh-dim step-latency multipliers (decode objective).

        Every collective step on a dim pays the latency of the *slowest*
        layer the dim spans (a ring/butterfly step crossing a socket or IB
        hop cannot be faster than that hop), so each dim's factor is the
        max ``alpha_factor`` over its spanned layers; a singleton dim has
        no collectives and reports 1.0.
        """
        spans1, spans2 = self.dim_layer_spans(d1, d2)

        def dim_alpha(spans: list[tuple[int, int]]) -> float:
            if not spans:
                return 1.0
            return max(self.layers[j].alpha_factor for j, _ in spans)

        return dim_alpha(spans1), dim_alpha(spans2)


# ---------------------------------------------------------------------------
# Presets.  IC1..IC6 reproduce the paper's interconnects analytically; the
# two TPU presets are the JAX package's (plans searched on them must stay
# equal); the two H100 presets describe the port's own card.
# ---------------------------------------------------------------------------

def ic1_pcie_8gpu() -> HierarchicalCommMatrix:
    """Machine A with NVLink disabled (PCIe 4.0 tree, 2 sockets x 4 GPUs)."""
    return HierarchicalCommMatrix(
        "IC1-PCIe",
        (
            CommLayer("socket", 2, 16.0, 16.0, alpha_factor=8.0),  # QPI/GMI bridge
            CommLayer("pcie-switch", 2, 32.0, 32.0, alpha_factor=3.0),
            CommLayer("gpu", 2, 32.0, 32.0, alpha_factor=2.0),
        ),
    )


def ic2_dual_nvlink_8gpu() -> HierarchicalCommMatrix:
    """Machine B: 4 dual-GPU NVLink islands bridged by PCIe."""
    return HierarchicalCommMatrix(
        "IC2-dualNVLink",
        (
            CommLayer("pcie", 4, 32.0, 32.0, alpha_factor=3.0),
            CommLayer("nvlink-pair", 2, 200.0, 200.0),  # alpha_factor 1 (NVLink hop)
        ),
    )


def ic3_nvswitch_8gpu() -> HierarchicalCommMatrix:
    """Machine A: 8x A100 fully connected over NVSwitch (NVLink-v3)."""
    return HierarchicalCommMatrix(
        "IC3-NVSwitch",
        (CommLayer("nvswitch", 8, 200.0, 600.0),),
    )


def ic4_ib_cluster_16gpu() -> HierarchicalCommMatrix:
    """Cluster C: 16 GPUs, flat 200 Gbps InfiniBand (single layer)."""
    return HierarchicalCommMatrix(
        "IC4-IB",
        (CommLayer("ib", 16, 25.0, 25.0, alpha_factor=12.0),),
    )


def ic5_nvlink_network(n: int = 16) -> HierarchicalCommMatrix:
    """NVLink-Network Switch superpod: flat full-bandwidth fabric."""
    return HierarchicalCommMatrix(
        "IC5-NVLinkNet",
        (CommLayer("nvl-net", n, 450.0, 450.0),),
    )


def ic6_torus_2d(side: int = 4, link_gbps: float = 25.0) -> HierarchicalCommMatrix:
    """2D torus (Fig. 7b): rings of `side`, ring-of-rings above."""
    return HierarchicalCommMatrix(
        "IC6-2DTorus",
        (
            CommLayer("ring-of-rings", side, link_gbps * side,
                      2 * link_gbps * side, alpha_factor=2.0),
            CommLayer("ring", side, link_gbps, 2 * link_gbps),
        ),
    )


def tpu_v5e_pod(rows: int = 16, cols: int = 16, link_bw: float = 50.0) -> HierarchicalCommMatrix:
    """A TPU pod's 2D torus (``repro.core.comm_matrix.tpu_v5e_pod``).

    Innermost layer: a torus row (ring of ``cols``).  Outer layer: ring of
    rows; adjacent rows are joined by ``cols`` column links.  Kept so that
    a plan searched on this preset by the JAX package is equal here; the
    link figure is the reference's default argument.
    """
    return HierarchicalCommMatrix(
        "TPUv5e-pod",
        (
            CommLayer("torus-rows", rows, link_bw * cols, 2 * link_bw * cols,
                      alpha_factor=2.0),
            CommLayer("torus-cols", cols, link_bw, 2 * link_bw),
        ),
    )


def tpu_multipod(pods: int = 2, dcn_bw: float = 100.0, **kw) -> HierarchicalCommMatrix:
    """Pods of :func:`tpu_v5e_pod` joined by a data-center network layer
    (``repro.core.comm_matrix.tpu_multipod``; its default arguments)."""
    pod = tpu_v5e_pod(**kw)
    return HierarchicalCommMatrix(
        "TPUv5e-multipod",
        (CommLayer("dcn", pods, dcn_bw, dcn_bw, alpha_factor=40.0),)
        + pod.layers,
    )


def h100_sxm_8() -> HierarchicalCommMatrix:
    """One HGX/DGX H100 node: 8 H100 SXM GPUs on NVSwitch (NVLink 4).

    Source: the NVIDIA H100 Tensor Core GPU datasheet gives NVLink at
    900 GB/s per GPU (A100: 600).  The layer follows ``ic3``'s convention
    for the A100 node (p2p 200, group 600, which reproduces Fig. 7's
    k = 4 -> 600 GB/s) scaled by 900/600: p2p 300, group 900.

    Eq. 3 raw per-dim bandwidths (B1', B2') and Eq. 4 algorithm
    bandwidths (B1, B2), in GB/s, for every factorization of 8:

        (1, 8): B2' 900, B2 514.29      (2, 4): B1' 300, B2' 900,
        (4, 2): B1' 900, B2' 300,               B1 300,  B2 600
                B1 600,  B2 300          (8, 1): B1' 900, B1 514.29

    (a size-1 dim has no collective: its bandwidth is inf).
    """
    return HierarchicalCommMatrix(
        "H100-SXM-8",
        (CommLayer("nvswitch", 8, 300.0, 900.0),),
    )


def h100_sxm_2x8() -> HierarchicalCommMatrix:
    """Two :func:`h100_sxm_8` nodes over InfiniBand NDR.

    Source: the NVIDIA DGX H100 user guide gives one 400 Gb/s ConnectX-7
    NIC per GPU, i.e. 50 GB/s a GPU.  The outer layer follows ``ic4``'s
    (a per-GPU IB port, alpha factor 12) and ``tpu_multipod``'s (the
    outer layer's p2p and group bandwidth are the aggregate between two
    groups) conventions: 8 NICs x 50 GB/s = 400 GB/s between the nodes,
    which the sharing rule of :meth:`HierarchicalCommMatrix.axis_bandwidths`
    divides among the dim-1 groups that cross it (DeviceMesh(2, 8): each
    of the 8 groups gets one NIC, 50 GB/s).

    (B1', B2') and Eq. 4 (B1, B2), in GB/s, for every factorization of 16:

        (1, 16): B2' 400, B2 213.33
        (2, 8):  B1' 50,  B2' 900,  B1 50,     B2 514.29
        (4, 4):  B1' 100, B2' 900,  B1 66.67,  B2 600
        (8, 2):  B1' 200, B2' 300,  B1 114.29, B2 300
        (16, 1): B1' 400, B1 213.33
    """
    node = h100_sxm_8()
    return HierarchicalCommMatrix(
        "H100-SXM-2x8",
        (CommLayer("ib-ndr", 2, 400.0, 400.0, alpha_factor=12.0),)
        + node.layers,
    )


PRESETS = {
    "ic1": ic1_pcie_8gpu,
    "ic2": ic2_dual_nvlink_8gpu,
    "ic3": ic3_nvswitch_8gpu,
    "ic4": ic4_ib_cluster_16gpu,
    "ic5": ic5_nvlink_network,
    "ic6": ic6_torus_2d,
    "v5e": tpu_v5e_pod,
    "v5e-multipod": tpu_multipod,
    "h100-sxm-8": h100_sxm_8,
    "h100-sxm-2x8": h100_sxm_2x8,
}
