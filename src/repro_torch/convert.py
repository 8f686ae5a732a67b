"""Carry the JAX package's weights into the port.

``params_from_jax`` takes the tree ``repro.models.lm.init_params`` makes,
as numpy arrays (keys like ``seg0/attn/wq`` stacked ``[count, ...]``), and
returns rank ``rank``'s shard for the port: cut by the same
PartitionSpecs the JAX package shards with, with q/k/v, up/gate and the
Mamba2 z/x fused per rank in the order the JAX blocks concatenate their
local shards (``lm.shard_params``).  Each leaf keeps its dtype: a bf16
model's Mamba2 ``conv``, ``A_log``, ``D``, ``dt_bias``, ``ln`` and ``gn``
stay fp32.  This module imports no JAX: the caller hands over numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mesh import MeshTopo
from repro_torch.models import lm


def to_torch(a) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) -> torch, sharing no memory."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def tree_to_torch(tree):
    return lm.tree_map(to_torch, tree)


def params_from_jax(cfg: ModelConfig, np_params: dict, topo: MeshTopo,
                    rank: int) -> dict:
    """Rank ``rank``'s port parameters from the JAX global tree."""
    return lm.shard_params(cfg, tree_to_torch(np_params),
                           lm.layout_context(topo, rank))
