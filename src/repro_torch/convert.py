"""Carry the JAX package's weights into the port, and back.

``params_from_jax`` takes the tree ``repro.models.lm.init_params`` makes,
as numpy arrays (keys like ``seg0/attn/wq`` stacked ``[count, ...]``), and
returns rank ``rank``'s shard for the port: cut by the same
PartitionSpecs the JAX package shards with (an MoE layer's experts over
the flat TP ranks; an MLA layer's leaves by ``mla.SPECS``, none fused),
with q/k/v, up/gate (each expert's too) and the
Mamba2 z/x fused per rank in the order the JAX blocks concatenate their
local shards (``lm.shard_params``).  Each leaf keeps its dtype: a bf16
model's Mamba2 ``conv``, ``A_log``, ``D``, ``dt_bias``, ``ln`` and ``gn``
stay fp32.  ``params_to_numpy`` is its inverse: it reassembles the global
arrays, under the JAX keys, from every rank's shard (of parameters, or of
their gradients), with the fused leaves split back.  This module imports
no JAX: the caller hands over numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, segments
from repro_torch.core.mesh import MeshTopo
from repro_torch.models import layers as L
from repro_torch.models import lm, mla, moe


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


def _dense_block_pieces(cfg: ModelConfig, ctx, key: str, blk: dict,
                        lead: int):
    """The pieces of one (stacked) dense block under ``key`` (an MoE
    layer's holds no MLP): the fused q/k/v, up/gate and bias leaves split
    back."""
    nspec = L.feat_spec(ctx)
    col, row = L.col_w_spec(ctx), L.row_w_spec(ctx)
    for ln in ("ln_attn", "ln_mlp", "ln_post_attn", "ln_post_mlp"):
        for k, v in blk.get(ln, {}).items():
            yield f"{key}/{ln}/{k}", v, nspec, lead
    a = blk["attn"]
    for name, t in L.split_fused(cfg, ctx, "w_qkv", a["w_qkv"]):
        yield f"{key}/attn/{name}", t, col, lead
    if "b_qkv" in a:
        for name, t in L.split_fused(cfg, ctx, "b_qkv", a["b_qkv"]):
            yield f"{key}/attn/{name}", t, L.col_b_spec(ctx), lead
    yield f"{key}/attn/wo", a["wo"], row, lead
    for name in ("q_norm", "k_norm"):
        if name in a:
            yield f"{key}/attn/{name}", a[name], (), lead
    if "mlp" in blk:
        yield from _mlp_pieces(cfg, ctx, f"{key}/mlp", blk["mlp"], lead)


def _mlp_pieces(cfg: ModelConfig, ctx, key: str, m: dict, lead: int):
    """The pieces of one (stacked) dense MLP under ``key``: the fused
    up/gate split back."""
    if "w_upgate" in m:
        for name, t in L.split_fused(cfg, ctx, "w_upgate", m["w_upgate"]):
            yield f"{key}/{name}", t, L.col_w_spec(ctx), lead
    else:
        yield f"{key}/w_up", m["w_up"], L.col_w_spec(ctx), lead
    yield f"{key}/w_down", m["w_down"], L.row_w_spec(ctx), lead


def _moe_block_pieces(cfg: ModelConfig, ctx, key: str, blk: dict,
                      lead: int):
    """The pieces of a (stacked) MoE layer under ``key``: its norms and
    attention as a dense block's, the router, each expert's up/gate split
    back, and the shared experts' MLP."""
    yield from _dense_block_pieces(cfg, ctx, key, blk, lead)
    yield from _moe_pieces(cfg, ctx, key, blk["moe"], lead)


def _moe_pieces(cfg: ModelConfig, ctx, key: str, m: dict, lead: int):
    """The pieces of a (stacked) ``moe`` node under ``key``."""
    yield f"{key}/moe/router", m["router"], (), lead
    ep = moe.expert_spec(ctx)
    for name, t in L.split_fused(cfg, ctx, "w_upgate", m["w_upgate"]):
        yield f"{key}/moe/{name}", t, ep, lead
    yield f"{key}/moe/w_down", m["w_down"], ep, lead
    if "shared" in m:
        yield from _mlp_pieces(cfg, ctx, f"{key}/moe/shared", m["shared"],
                               lead)


def _mla_layer_pieces(cfg: ModelConfig, ctx, key: str, blk: dict,
                      lead: int):
    """The pieces of a (stacked) mla_dense or mla_moe layer under ``key``:
    its norms, its MLA leaves as they are, and its MLP (up/gate split back)
    or MoE node."""
    nspec = L.feat_spec(ctx)
    for ln in ("ln_attn", "ln_mlp"):
        for k, v in blk[ln].items():
            yield f"{key}/{ln}/{k}", v, nspec, lead
    for name, spec in mla.SPECS.items():
        yield f"{key}/mla/{name}", blk["mla"][name], spec(ctx), lead
    if "moe" in blk:
        yield from _moe_pieces(cfg, ctx, key, blk["moe"], lead)
    else:
        yield from _mlp_pieces(cfg, ctx, f"{key}/mlp", blk["mlp"], lead)


def _mamba_pieces(cfg: ModelConfig, ctx, key: str, blk: dict, lead: int):
    """The pieces of (stacked) Mamba2 blocks under ``key``: ``w_zx`` split
    back into ``w_z | w_x`` (``mamba2.shard_mamba`` fused this rank's two
    column shards)."""
    col = L.col_w_spec(ctx)
    for name, t in L.split_fused(cfg, ctx, "w_zx", blk["w_zx"]):
        yield f"{key}/{name}", t, col, lead
    yield f"{key}/w_bcdt", blk["w_bcdt"], (ctx.ax2, None), lead
    yield f"{key}/w_out", blk["w_out"], L.row_w_spec(ctx), lead
    yield f"{key}/ln", blk["ln"], L.feat_spec(ctx), lead
    for name in ("conv", "A_log", "D", "dt_bias", "gn"):
        yield f"{key}/{name}", blk[name], (), lead


def _pieces(cfg: ModelConfig, ctx, params: dict):
    """(JAX key, tensor, spec, lead dims) of each global leaf's piece on
    this rank."""
    yield "embed", params["embed"], L.embed_spec(ctx), 0
    for k, v in params["final_norm"].items():
        yield f"final_norm/{k}", v, L.feat_spec(ctx), 0
    if "lm_head" in params:
        yield "lm_head", params["lm_head"], L.head_spec(ctx), 0
    for i, seg in enumerate(segments(cfg)):
        sp, key = params[f"seg{i}"], f"seg{i}"
        if seg.kind == "dense":
            yield from _dense_block_pieces(cfg, ctx, key, sp, 1)
        elif seg.kind == "moe":
            yield from _moe_block_pieces(cfg, ctx, key, sp, 1)
        elif seg.kind in lm.MLA_KINDS:
            yield from _mla_layer_pieces(cfg, ctx, key, sp, 1)
        elif seg.kind == "zamba":
            yield from _mamba_pieces(cfg, ctx, f"{key}/mamba", sp["mamba"],
                                     2)
        else:
            yield from _mamba_pieces(cfg, ctx, key, sp, 1)
    if "shared_attn" in params:
        sa = params["shared_attn"]
        for name in ("w_in_h", "w_in_e"):
            yield f"shared_attn/{name}", sa[name], L.col_w_spec(ctx), 0
        yield from _dense_block_pieces(cfg, ctx, "shared_attn/block",
                                       sa["block"], 0)
    if "mtp" in params:
        mp = params["mtp"]
        for name in ("proj_h", "proj_e"):
            yield f"mtp/{name}", mp[name], L.col_w_spec(ctx), 0
        pieces = _mla_layer_pieces if cfg.mla else _dense_block_pieces
        yield from pieces(cfg, ctx, "mtp/block", mp["block"], 0)
        for k, v in mp["norm"].items():
            yield f"mtp/norm/{k}", v, L.feat_spec(ctx), 0


def params_to_numpy(cfg: ModelConfig, params_per_rank: list,
                    topo: MeshTopo) -> dict:
    """The global tree (JAX keys, numpy; bf16 leaves as fp32) from
    ``params_per_rank[r]``, rank r's port tree (parameters or
    gradients).  Each rank's piece goes to its place by the PartitionSpecs
    it was cut with; a piece that several ranks hold is written by each."""
    lm.check_trainable(cfg)
    flat: dict = {}
    for rank, params in enumerate(params_per_rank):
        ctx = lm.layout_context(topo, rank)
        for key, t, spec, lead in _pieces(cfg, ctx, params):
            a = t.detach().cpu()
            a = (a.float() if a.dtype == torch.bfloat16 else a).numpy()
            shape, where = list(a.shape), [slice(None)] * a.ndim
            for i, axis in enumerate(spec):
                if axis is None:
                    continue
                d, c = lead + i, L.axis_index(topo, ctx.coords, axis)
                shape[d] *= L.axis_size(topo, axis)
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
