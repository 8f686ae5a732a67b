"""Dense transformer block with ATP row/column-first tensor parallelism
(counterpart of ``repro.models.transformer``): the paged serving path, the
wave path over contiguous decode caches, and the cache-free path of
training (attention over the current sequence).

Per-block communication schedule (paper Fig. 6):
  f1: all-reduce(ax2) after the column-first fused q/k/v projection
  f2: all-reduce(ax1) after the row-first output projection
  f3: all-reduce(ax2) after the column-first fused up+gate projection
  f4: all-reduce(ax1) after the row-first down projection

The fused weights (``w_qkv`` = this rank's wq|wk|wv shards, ``w_upgate`` =
w_up|w_gate) are concatenated once, when parameters are sharded
(``lm.shard_params``), in the order the JAX block concatenates its local
shards on every call.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.atp import ATPContext, atp_linear, atp_mlp, grad_sync
from repro_torch.models import layers as L
from repro_torch.models import paging


def _normal(gen, shape, scale, dtype, device):
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def attn_params(gen, cfg: ModelConfig, dtype, device) -> dict:
    h, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = 1.0 / math.sqrt(h)
    p = {
        "wq": _normal(gen, (h, qd), s, dtype, device),
        "wk": _normal(gen, (h, kvd), s, dtype, device),
        "wv": _normal(gen, (h, kvd), s, dtype, device),
        "wo": _normal(gen, (qd, h), 1.0 / math.sqrt(qd), dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(qd, dtype=dtype, device=device)
        p["bk"] = torch.zeros(kvd, dtype=dtype, device=device)
        p["bv"] = torch.zeros(kvd, dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(cfg.hd, device=device)
        p["k_norm"] = torch.ones(cfg.hd, device=device)
    return p


def mlp_params(gen, cfg: ModelConfig, dtype, device) -> dict:
    h, ff = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(h)
    p = {"w_up": _normal(gen, (h, ff), s, dtype, device),
         "w_down": _normal(gen, (ff, h), 1.0 / math.sqrt(ff), dtype, device)}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        p["w_gate"] = _normal(gen, (h, ff), s, dtype, device)
    return p


def dense_block_params(gen, cfg: ModelConfig, dtype, device) -> dict:
    """One block's global params, with the JAX block's keys and
    distributions (norm params created at global size, sharded later)."""
    def nrm():
        return {k: v.to(device) for k, v in
                L.norm_params(cfg, cfg.d_model).items()}

    p = {"ln_attn": nrm(), "attn": attn_params(gen, cfg, dtype, device),
         "ln_mlp": nrm(), "mlp": mlp_params(gen, cfg, dtype, device)}
    if cfg.post_block_norms:
        p["ln_post_attn"] = nrm()
        p["ln_post_mlp"] = nrm()
    return p


def shard_dense_block(ctx: ATPContext, cfg: ModelConfig, p: dict,
                      lead: int = 1) -> dict:
    """This rank's shard of a (layer-stacked) dense block, with the q/k/v
    and up/gate weights fused per rank.  Pops the global leaves it consumed
    from ``p`` so their memory can go as soon as the fused copy exists."""
    cut = L.cut
    nspec = L.feat_spec(ctx)
    out = {}
    for name in ("ln_attn", "ln_mlp", "ln_post_attn", "ln_post_mlp"):
        if name in p:
            out[name] = {k: cut(ctx, v, nspec, lead) for k, v in p.pop(name).items()}
    a = p.pop("attn")
    col = L.col_w_spec(ctx)
    attn = {"w_qkv": torch.cat([cut(ctx, a.pop(k), col, lead)
                                for k in L.FUSED_LEAVES["w_qkv"]], dim=-1),
            "wo": cut(ctx, a.pop("wo"), L.row_w_spec(ctx), lead)}
    if cfg.qkv_bias:
        attn["b_qkv"] = torch.cat([cut(ctx, a.pop(k), L.col_b_spec(ctx), lead)
                                   for k in L.FUSED_LEAVES["b_qkv"]], dim=-1)
    if cfg.qk_norm:
        attn["q_norm"], attn["k_norm"] = a.pop("q_norm"), a.pop("k_norm")
    out["attn"] = attn
    m = p.pop("mlp")
    mlp = {"w_down": cut(ctx, m.pop("w_down"), L.row_w_spec(ctx), lead)}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        mlp["w_upgate"] = torch.cat([cut(ctx, m.pop(k), col, lead)
                                     for k in L.FUSED_LEAVES["w_upgate"]],
                                    dim=-1)
    else:
        mlp["w_up"] = cut(ctx, m.pop("w_up"), col, lead)
    out["mlp"] = mlp
    return out


def mlp_block(ctx: ATPContext, cfg: ModelConfig, p, x):
    """Feed-forward with column-first up(+gate), row-first down (f3/f4)."""
    if cfg.mlp_kind in ("swiglu", "geglu"):
        # one column-first GEMM for up+gate and a single f3 boundary; the
        # activation applies to the gate half only, so it stays outside
        # the GEMM's epilogue
        def gated(ug):
            u, g = ug.chunk(2, dim=-1)
            return u * (F.silu(g) if cfg.mlp_kind == "swiglu"
                        else F.gelu(g, approximate="tanh"))
        return atp_mlp(ctx, x, p["w_upgate"], p["w_down"], hidden=gated)
    return atp_mlp(ctx, x, p["w_up"], p["w_down"], activation="gelu")


def _qk_norm(q, gamma, eps):
    qf = q.float()
    inv = torch.rsqrt(qf.pow(2).mean(-1, keepdim=True) + eps)
    return (qf * inv * gamma.float()).to(q.dtype)


def attn_block(ctx: ATPContext, cfg: ModelConfig, p, x, positions,
               plan: L.AttnPlan, layer_window: int, cache: dict | None = None,
               paged: dict | None = None):
    """Attention.  x [b, s, h/d2]; positions [b, s] (training: ``0..s-1``
    in every row).  Paged: cache holds this layer's k/v pools [num_pages,
    page, kv_count, hd], paged carries the page-table rows ``table [b, mp]``
    and per-slot ``start [b]``, and the pools are written in place.
    Contiguous (paged None): cache holds this layer's ``k``/``v`` [b,
    s_max, kv_count, hd] and ``len``, a 0-d int32 device tensor; this run's
    k/v land at rows ``len ..`` in place, the attention runs over the
    cache at q_offset ``len`` and kv_len ``len + s``, and ``len`` grows by s
    in place (no host sync: the step can be captured).  With no cache
    (training) the attention runs over the current sequence and writes
    nothing; where the plan leaves r ranks per head block, each takes 1/r
    of the query rows.  Returns the block output [b, s, h/d2]."""
    # f1: fused q/k/v projection, one boundary over ax2; the bias follows
    # the boundary (fused into the GEMM's epilogue when ax2 is size 1)
    qkv = atp_linear(ctx, x, p["w_qkv"], p.get("b_qkv"), kind="col",
                     chunked=False, plain=True)
    qd, kvd = cfg.q_dim // ctx.d1, cfg.kv_dim // ctx.d1
    qp, kp, vp = qkv[..., :qd], qkv[..., qd:qd + kvd], qkv[..., qd + kvd:]
    q, k, v, _, rid = L.split_qkv_heads(ctx, cfg, qp, kp, vp, plan)
    if cfg.qk_norm:
        # the gains meet only this rank's heads: one gradient reduction
        q = _qk_norm(q, grad_sync(ctx, p["q_norm"], ctx.tp_axes),
                     cfg.norm_eps)
        k = _qk_norm(k, grad_sync(ctx, p["k_norm"], ctx.tp_axes),
                     cfg.norm_eps)
    if cfg.mrope_sections:
        raise NotImplementedError("M-RoPE (qwen2-vl) is ROADMAP A10")
    q_pos = positions
    if cache is None and plan.r > 1:
        # the r leftover ranks split the query rows (k/v keep the sequence)
        s_r = q.shape[1] // plan.r
        q = q.narrow(1, rid * s_r, s_r)
        q_pos = positions.narrow(1, rid * s_r, s_r)
    if cfg.use_rope:
        q = L.apply_rope(q, q_pos, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        b, s = x.shape[:2]
        o = L.attention_core(cfg, q, k, v, q_offset=q_pos[:, 0].int(),
                             kv_len=torch.full((b,), s, dtype=torch.int32,
                                               device=x.device),
                             window=layer_window)
        o = L.core_output_gather(ctx, cfg, o, plan, seq_split=True)
        return atp_linear(ctx, o, p["wo"], kind="row")

    if paged is None:
        o = _contiguous_attention(cfg, cache, q, k, v, layer_window)
        o = L.core_output_gather(ctx, cfg, o, plan)
        return atp_linear(ctx, o, p["wo"], kind="row")
    # scatter this run's k/v through the slot page tables, then attend over
    # each slot's mapped pages (garbage-page reads are masked by start + s)
    table, start = paged["table"], paged["start"]
    paging.append_tokens(cache["k"], table, start, k)
    paging.append_tokens(cache["v"], table, start, v)
    kk = paging.gather_pages(cache["k"], table)
    vv = paging.gather_pages(cache["v"], table)
    o = L.attention_core(cfg, q, kk, vv, q_offset=start,
                         kv_len=start + q.shape[1], window=layer_window)
    o = L.core_output_gather(ctx, cfg, o, plan)
    # f2: row-first output projection, boundary over ax1
    return atp_linear(ctx, o, p["wo"], kind="row")


def _contiguous_attention(cfg: ModelConfig, cache: dict, q, k, v,
                          layer_window: int):
    """This run's k/v written at ``cache["len"]``, then the attention over
    the cache (s_max rows; the kernel reads only ``kv_len = len + s`` of
    them), then ``len += s``, all in place."""
    b, s = q.shape[:2]
    klen = cache["len"]
    rows = klen.long() + torch.arange(s, device=q.device)
    cache["k"].index_copy_(1, rows, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, rows, v.to(cache["v"].dtype))
    q_offset = klen.to(torch.int32).reshape(1).repeat(b)
    o = L.attention_core(cfg, q, cache["k"], cache["v"], q_offset=q_offset,
                         kv_len=q_offset + s, window=layer_window)
    klen.add_(s)
    return o


def dense_block(ctx: ATPContext, cfg: ModelConfig, p, x, positions, plan,
                layer_window: int, cache: dict | None = None,
                paged: dict | None = None):
    """With ``ctx.seq_parallel`` the residual stream x is sequence-sharded
    over ax1: the entry norms gather the sequence back, the row-first
    projections (f2/f4) reduce-scatter it; post-block norms and residual
    adds stay in the sequence-sharded domain."""
    sp = ctx.seq_parallel and cache is None
    h = L.norm(ctx, cfg, x, p["ln_attn"], gather_seq=sp)
    a = attn_block(ctx, cfg, p["attn"], h, positions, plan, layer_window,
                   cache, paged)
    if cfg.post_block_norms:
        a = L.norm(ctx, cfg, a, p["ln_post_attn"])
    x = x + a
    h = L.norm(ctx, cfg, x, p["ln_mlp"], gather_seq=sp)
    m = mlp_block(ctx, cfg, p["mlp"], h)
    if cfg.post_block_norms:
        m = L.norm(ctx, cfg, m, p["ln_post_mlp"])
    return x + m
