"""Language model: embedding -> block stack -> head, ATP-sharded
(counterpart of ``repro.models.lm``), paged serving of dense segments.

Parameters come in two forms.  ``init_params`` makes the GLOBAL tree with
the JAX package's keys (``seg0/attn/wq`` ... stacked ``[count, ...]``) and
distributions; ``shard_params`` cuts one rank's shard out of it by the JAX
PartitionSpecs and fuses q/k/v and up/gate per rank.  The model functions
take the sharded tree.  A Python loop over layers replaces ``lax.scan``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, segments
from repro_torch.core.atp import ATPContext, atp_boundary
from repro_torch.core.mesh import (MeshTopo, dp_axis_names, resolve_device,
                                   tp_axis_names)
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import paging, transformer

_A10 = "segment kind {!r} is not ported yet (ROADMAP A10: other segment kinds)"


def _check_dense(cfg: ModelConfig):
    for seg in segments(cfg):
        if seg.kind != "dense":
            raise NotImplementedError(_A10.format(seg.kind))
    if cfg.mtp:
        raise NotImplementedError("the MTP head is ROADMAP A9 (speculation)")


def _layer(tree, i: int):
    """Layer ``i`` of a layer-stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, dtype=None,
                device=None) -> dict:
    """Global parameters with the JAX ``lm.init_params`` keys, scales and
    distributions (normal * scale, norm scales 1, biases 0), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (CUDA unless
    named).  A torch generator does not draw the numbers jax.random draws:
    weights that must match the JAX package cross through
    ``convert.params_from_jax``."""
    _check_dense(cfg)
    device = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    h = cfg.d_model
    p = {"embed": transformer._normal(gen, (cfg.vocab_size, h), 0.02, dtype,
                                      device),
         "final_norm": {k: v.to(device) for k, v in L.norm_params(cfg, h).items()}}
    if not cfg.tie_embeddings:
        p["lm_head"] = transformer._normal(gen, (h, cfg.vocab_size),
                                           1.0 / math.sqrt(h), dtype, device)
    for i, seg in enumerate(segments(cfg)):
        # one block at a time into preallocated stacks: the fp32 draw of a
        # single block is the only temporary
        stacked = None
        for j in range(seg.count):
            blk = transformer.dense_block_params(gen, cfg, dtype, device)
            if stacked is None:
                stacked = tree_map(lambda t: t.new_empty((seg.count,) + t.shape), blk)
            _zip(lambda dst, src: dst[j].copy_(src), stacked, blk)
        p[f"seg{i}"] = stacked
    return p


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _zip(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _zip(fn, a[k], b[k])
    else:
        fn(a, b)


def shard_params(cfg: ModelConfig, params: dict, ctx: ATPContext) -> dict:
    """This rank's shard of the global tree (consumed: its leaves are
    popped as they are cut, so a full-size model never exists twice)."""
    _check_dense(cfg)
    nspec = L.feat_spec(ctx)
    out = {"embed": L.cut(ctx, params.pop("embed"), L.embed_spec(ctx)),
           "final_norm": {k: L.cut(ctx, v, nspec)
                          for k, v in params.pop("final_norm").items()}}
    if not cfg.tie_embeddings:
        out["lm_head"] = L.cut(ctx, params.pop("lm_head"), L.head_spec(ctx))
    for i, _ in enumerate(segments(cfg)):
        out[f"seg{i}"] = transformer.shard_dense_block(
            ctx, cfg, params.pop(f"seg{i}"))
    return out


def layout_context(topo: MeshTopo, rank: int) -> ATPContext:
    """A context that knows ``rank``'s mesh coordinates but holds no process
    group: enough to cut shards (``shard_params``) outside a running job."""
    ax1, ax2 = tp_axis_names(topo)
    return ATPContext(topo=topo, ax1=ax1, ax2=ax2, dp_axes=dp_axis_names(topo),
                      coords=topo.coords(rank))


# ---------------------------------------------------------------------------
# Paged caches.
# ---------------------------------------------------------------------------


def init_paged_caches(cfg: ModelConfig, ctx: ATPContext,
                      pcfg: paging.PagedConfig, dtype=None, device=None):
    """This rank's block-paged k/v pools per segment, on ``device`` (CUDA
    unless named):
    ``{"seg{i}": {"k": [count, np, pg, kv_count, hd], "v": ...}}`` — the
    bank dim of the JAX pools' ``[count, np, pg, tp*kv_count, hd]`` cut to
    this rank.  bf16 pools only: the int8/fp8 pools are ROADMAP A9."""
    _check_dense(cfg)
    device = resolve_device(device)
    if pcfg.page_dtype != "bf16":
        raise NotImplementedError(
            f"page_dtype={pcfg.page_dtype!r}: quantized page pools are "
            f"ROADMAP A9")
    dtype = dtype or getattr(torch, cfg.dtype)
    plan = L.make_attn_plan(ctx, cfg.num_heads, cfg.num_kv_heads)
    caches = {}
    for i, seg in enumerate(segments(cfg)):
        shape = (seg.count, pcfg.num_pages, pcfg.page_size, plan.kv_count,
                 cfg.hd)
        caches[f"seg{i}"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                             "v": torch.zeros(shape, dtype=dtype, device=device)}
    return caches


# ---------------------------------------------------------------------------
# Embedding / head (vocab-parallel over ax1, feature over ax2).
# ---------------------------------------------------------------------------


def embed_tokens(ctx: ATPContext, cfg: ModelConfig, emb, tokens):
    """emb local [V/d1, h/d2]; tokens [b, s] -> x [b, s, h/d2]."""
    v_loc = emb.shape[0]
    rel = tokens.long() - ctx.index1() * v_loc
    ok = (rel >= 0) & (rel < v_loc)
    x = emb[rel.clamp(0, v_loc - 1)] * ok[..., None].to(emb.dtype)
    x = atp_boundary(ctx, x, ctx.ax1)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def lm_logits(ctx: ATPContext, cfg: ModelConfig, params, x):
    """x [b, s, h/d2] -> logits [b, s, V/d1] (ax2-replicated).  A tied head
    reads the embedding transposed, without a copy."""
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = atp_boundary(ctx, ops.matmul(x, w), ctx.ax2)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


# ---------------------------------------------------------------------------
# Forward.
# ---------------------------------------------------------------------------


def _window_pattern(cfg: ModelConfig, count: int) -> list[int]:
    """Per-layer sliding window sizes (0 = global) for alternating archs."""
    if not cfg.local_global_period:
        return [0] * count
    return [cfg.local_window if i % cfg.local_global_period == 0 else 0
            for i in range(count)]


def forward(ctx: ATPContext, cfg: ModelConfig, params, tokens, positions,
            caches: dict, paged: dict):
    """Paged forward.  tokens/positions [b, s]; caches from
    :func:`init_paged_caches` (written in place); paged = dict(table
    [b, mp], start [b]).  Returns the final-norm hidden [b, s, h/d2]."""
    _check_dense(cfg)
    x = embed_tokens(ctx, cfg, params["embed"], tokens)
    plan = L.make_attn_plan(ctx, cfg.num_heads, cfg.num_kv_heads)
    for i, seg in enumerate(segments(cfg)):
        sp, sc = params[f"seg{i}"], caches[f"seg{i}"]
        for j, window in enumerate(_window_pattern(cfg, seg.count)):
            x = transformer.dense_block(ctx, cfg, _layer(sp, j), x, positions,
                                        plan, window, _layer(sc, j), paged)
    return L.norm(ctx, cfg, x, params["final_norm"])


def paged_step(ctx: ATPContext, cfg: ModelConfig, params, tokens, start,
               table, caches):
    """One paged cache-write step — decode tick AND prefill chunk.

    tokens [b, s] (decode: b=slots, s=1; prefill chunk: b=1, s=chunk);
    start [b] per-slot absolute position of tokens[:, 0]; table [b, mp]
    page-table rows; caches from :func:`init_paged_caches`.

    Returns (logits [b, s, V/d1] for every input position, caches)."""
    b, s = tokens.shape
    positions = start[:, None].long() + torch.arange(s, device=tokens.device)[None, :]
    h = forward(ctx, cfg, params, tokens, positions, caches,
                {"table": table, "start": start})
    return lm_logits(ctx, cfg, params, h), caches

