"""Carry the JAX package's weights into the port, and back.

``params_from_jax`` takes the tree ``repro.models.lm.init_params`` makes,
as numpy arrays (keys like ``seg0/attn/wq`` stacked ``[count, ...]``), and
returns rank ``rank``'s shard for the port: cut by the same
PartitionSpecs the JAX package shards with, with q/k/v, up/gate and the
Mamba2 z/x fused per rank in the order the JAX blocks concatenate their
local shards (``lm.shard_params``).  Each leaf keeps its dtype: a bf16
model's Mamba2 ``conv``, ``A_log``, ``D``, ``dt_bias``, ``ln`` and ``gn``
stay fp32.  ``params_to_numpy`` is its inverse for a dense model: it
reassembles the global arrays, under the JAX keys, from every rank's shard
(of parameters, or of their gradients).  This module imports no JAX: the
caller hands over numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mesh import MeshTopo
from repro_torch.models import layers as L
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


def _dense_pieces(cfg: ModelConfig, ctx, params: dict):
    """(JAX key, tensor, spec, lead dims) of each global leaf's piece on
    this rank: the fused q/k/v, up/gate and bias leaves split back."""
    nspec = L.feat_spec(ctx)
    yield "embed", params["embed"], L.embed_spec(ctx), 0
    for k, v in params["final_norm"].items():
        yield f"final_norm/{k}", v, nspec, 0
    if "lm_head" in params:
        yield "lm_head", params["lm_head"], L.head_spec(ctx), 0
    qd, kvd = cfg.q_dim // ctx.d1, cfg.kv_dim // ctx.d1
    col, row = L.col_w_spec(ctx), L.row_w_spec(ctx)
    for i in range(len([k for k in params if k.startswith("seg")])):
        sp, seg = params[f"seg{i}"], f"seg{i}"
        for ln in ("ln_attn", "ln_mlp", "ln_post_attn", "ln_post_mlp"):
            for k, v in sp.get(ln, {}).items():
                yield f"{seg}/{ln}/{k}", v, nspec, 1
        a = sp["attn"]
        for name, t in zip(("wq", "wk", "wv"),
                           a["w_qkv"].split([qd, kvd, kvd], dim=-1)):
            yield f"{seg}/attn/{name}", t, col, 1
        if "b_qkv" in a:
            for name, t in zip(("bq", "bk", "bv"),
                               a["b_qkv"].split([qd, kvd, kvd], dim=-1)):
                yield f"{seg}/attn/{name}", t, L.col_b_spec(ctx), 1
        yield f"{seg}/attn/wo", a["wo"], row, 1
        for name in ("q_norm", "k_norm"):
            if name in a:
                yield f"{seg}/attn/{name}", a[name], (), 1
        m = sp["mlp"]
        if "w_upgate" in m:
            up, gate = m["w_upgate"].chunk(2, dim=-1)
            yield f"{seg}/mlp/w_up", up, col, 1
            yield f"{seg}/mlp/w_gate", gate, col, 1
        else:
            yield f"{seg}/mlp/w_up", m["w_up"], col, 1
        yield f"{seg}/mlp/w_down", m["w_down"], row, 1


def params_to_numpy(cfg: ModelConfig, params_per_rank: list,
                    topo: MeshTopo) -> dict:
    """The global tree (JAX keys, numpy; bf16 leaves as fp32) of a dense
    model from ``params_per_rank[r]``, rank r's port tree (parameters or
    gradients).  Each rank's piece goes to its place by the PartitionSpecs
    it was cut with; a piece that several ranks hold is written by each."""
    lm.check_trainable(cfg)
    flat: dict = {}
    for rank, params in enumerate(params_per_rank):
        ctx = lm.layout_context(topo, rank)
        for key, t, spec, lead in _dense_pieces(cfg, ctx, params):
            a = t.detach().cpu()
            a = (a.float() if a.dtype == torch.bfloat16 else a).numpy()
            shape, where = list(a.shape), [slice(None)] * a.ndim
            for i, axis in enumerate(spec):
                if axis is None:
                    continue
                d, c = lead + i, ctx.coords[axis]
                shape[d] *= topo.axis_size(axis)
                where[d] = slice(c * a.shape[d], (c + 1) * a.shape[d])
            flat.setdefault(key, np.zeros(shape, a.dtype))[tuple(where)] = a
    tree: dict = {}
    for key, a in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = a
    return tree
