"""Device-mesh abstractions for ATP (counterpart of ``repro.core.mesh``).

The paper factorizes the tensor-parallel degree N into a 2D device mesh
(d1, d2); a job adds data-parallel and pod axes.  ``MeshTopo`` is the
logical description; ``MeshTopo.build`` materializes it as a
``torch.distributed.device_mesh.DeviceMesh`` over (pod, data, tp1, tp2) in
row-major rank order.
"""
from __future__ import annotations

import dataclasses
import math

import torch

# Canonical axis names used throughout the framework.
AXIS_POD = "pod"      # across pods
AXIS_DATA = "data"    # data parallel (within pod)
AXIS_TP1 = "tp1"      # first dim of the ATP 2D device mesh (d1)
AXIS_TP2 = "tp2"      # second dim of the ATP 2D device mesh (d2)
# The required production mesh uses a single "model" axis == ATP (N, 1).
AXIS_MODEL = "model"


@dataclasses.dataclass(frozen=True)
class MeshTopo:
    """Logical mesh: ordered (axis_name, size) pairs."""

    axes: tuple[tuple[str, int], ...]

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(s for _, s in self.axes)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        for a, s in self.axes:
            if a == name:
                return s
        return 1  # absent axes behave as singleton

    def has_axis(self, name: str) -> bool:
        return any(a == name for a, _ in self.axes)

    def coords(self, rank: int) -> dict[str, int]:
        """Row-major coordinates of global ``rank`` on every axis."""
        out = {}
        for name, size in reversed(self.axes):
            out[name] = rank % size
            rank //= size
        return out

    def build(self, device_type: str = "cuda"):
        """The ``DeviceMesh`` over this topology (needs an initialized
        default process group of ``size`` ranks), or None when ``size == 1``:
        a single rank runs no collective."""
        if self.size == 1:
            return None
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh(device_type, self.shape,
                                mesh_dim_names=self.names)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Without a GPU, a CUDA device (named or by default) raises:
    the port never carries on quietly on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port "
                           "on the CPU")
    return device


def atp_topo(dp: int, d1: int, d2: int, pods: int = 1) -> MeshTopo:
    """ATP mesh: (pod?, data, tp1, tp2).  d1*d2 is the TP degree."""
    axes: list[tuple[str, int]] = []
    if pods > 1:
        axes.append((AXIS_POD, pods))
    axes.append((AXIS_DATA, dp))
    axes.append((AXIS_TP1, d1))
    axes.append((AXIS_TP2, d2))
    return MeshTopo(tuple(axes))


def tp_axis_names(topo: MeshTopo) -> tuple[str | None, str | None]:
    """(first, second) mesh-dim axis names for ATP collectives.

    On the production mesh the single "model" axis is ATP (N, 1):
    tp1="model", tp2=None.  Size-1 axes are returned as None so collective
    code skips no-op reductions.
    """
    if topo.has_axis(AXIS_MODEL):
        return (AXIS_MODEL if topo.axis_size(AXIS_MODEL) > 1 else None, None)
    a1 = AXIS_TP1 if topo.axis_size(AXIS_TP1) > 1 else None
    a2 = AXIS_TP2 if topo.axis_size(AXIS_TP2) > 1 else None
    return (a1, a2)


def dp_axis_names(topo: MeshTopo) -> tuple[str, ...]:
    names = []
    if topo.has_axis(AXIS_POD) and topo.axis_size(AXIS_POD) > 1:
        names.append(AXIS_POD)
    if topo.has_axis(AXIS_DATA) and topo.axis_size(AXIS_DATA) > 1:
        names.append(AXIS_DATA)
    return tuple(names)
