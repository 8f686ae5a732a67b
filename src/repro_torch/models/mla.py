"""DeepSeek-V3 Multi-head Latent Attention, ATP-sharded (counterpart of
``repro.models.mla``): the ``mla_dense`` and ``mla_moe`` layers.

Sharding, as in the reference:
  - the down-projections to the small latents (q: ``q_lora_rank``, kv:
    ``kv_lora_rank + qk_rope_head_dim``) take rows over ax2 and give
    latents replicated over every TP rank after one all-reduce over ax2;
  - the up-projections ``w_uq``/``w_ukv`` take their columns (heads) over
    ax1, and each ax2 rank takes its block of those heads locally (the
    reference's ``shard_slice``), so a rank owns ``H / (d1 d2)`` heads;
  - the attention core runs on those heads; its output is gathered over
    ax2 for the row-first ``wo``;
  - serving caches the latent (``ckv`` and the roped ``krope``),
    replicated over TP, and scores against it directly (the absorbed
    form): fp32 einsums, as the reference has them, outside any kernel.

Gradients follow the port's convention (``core.atp``): a replicated
activation that meets rank-specific weights takes a conjugate, a
replicated parameter whose gradient is rank-partial a ``grad_sync``.  The
block input is conjugated over ax1 (none under ``seq_parallel``, where the
entry norm's gather reduce-scatters its gradient), the latents over ax2
where the heads meet them, and the down-projection weights and latent
norm gains are synced over ax1; ``w_uq``/``w_ukv``, of which each ax2 rank
reads one block, over ax2.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.atp import (ATPContext, all_gather, atp_boundary,
                                  atp_linear, conjugate, grad_sync)
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe, paging, transformer


def mla_params(gen, cfg: ModelConfig, dtype, device) -> dict:
    """One layer's global MLA params with the reference's keys, shapes and
    scales (normal * scale; the latent norm gains fp32 ones)."""
    m = cfg.mla
    h, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    s = 1.0 / math.sqrt(h)
    normal = transformer._normal
    return {
        "w_dq": normal(gen, (h, m.q_lora_rank), s, dtype, device),
        "w_uq": normal(gen, (m.q_lora_rank, H * qk),
                       1 / math.sqrt(m.q_lora_rank), dtype, device),
        "w_dkv": normal(gen, (h, m.kv_lora_rank + m.qk_rope_head_dim), s,
                        dtype, device),
        "w_ukv": normal(gen, (m.kv_lora_rank,
                              H * (m.qk_nope_head_dim + m.v_head_dim)),
                        1 / math.sqrt(m.kv_lora_rank), dtype, device),
        "wo": normal(gen, (H * m.v_head_dim, h),
                     1 / math.sqrt(H * m.v_head_dim), dtype, device),
        "q_ln": torch.ones(m.q_lora_rank, device=device),
        "kv_ln": torch.ones(m.kv_lora_rank, device=device),
    }


def _down_spec(ctx: ATPContext):
    """``w_dq``/``w_dkv`` [h, rank]: rows over ax2, replicated output."""
    return (ctx.ax2, None)


def _up_spec(ctx: ATPContext):
    """``w_uq``/``w_ukv`` [rank, heads * dims]: heads over ax1."""
    return (None, ctx.ax1)


def _replicated(ctx: ATPContext):
    return ()


#: the TP axes each MLA leaf is cut over (``layers.cut`` specs)
SPECS = {"w_dq": _down_spec, "w_dkv": _down_spec, "w_uq": _up_spec,
         "w_ukv": _up_spec, "wo": L.row_w_spec, "q_ln": _replicated,
         "kv_ln": _replicated}


def shard_mla(ctx: ATPContext, p: dict, lead: int = 1) -> dict:
    """This rank's shard of (layer-stacked) MLA params; nothing is fused
    (the reference concatenates no local shards).  Pops what it cut."""
    return {k: L.cut(ctx, p.pop(k), spec(ctx), lead)
            for k, spec in SPECS.items()}


def layer_params(gen, cfg: ModelConfig, dtype, device, kind: str) -> dict:
    """One ``mla_dense`` (MLP) or ``mla_moe`` (MoE) layer's global params."""
    def nrm():
        return {k: v.to(device) for k, v in
                L.norm_params(cfg, cfg.d_model).items()}

    p = {"ln_attn": nrm(), "mla": mla_params(gen, cfg, dtype, device),
         "ln_mlp": nrm()}
    if kind == "mla_moe":
        p["moe"] = moe.moe_params(gen, cfg, dtype, device)
    else:
        p["mlp"] = transformer.mlp_params(gen, cfg, dtype, device)
    return p


def shard_layer(ctx: ATPContext, cfg: ModelConfig, p: dict,
                lead: int = 1) -> dict:
    """This rank's shard of (layer-stacked) MLA layers of either kind."""
    nspec = L.feat_spec(ctx)
    out = {name: {k: L.cut(ctx, v, nspec, lead)
                  for k, v in p.pop(name).items()}
           for name in ("ln_attn", "ln_mlp")}
    out["mla"] = shard_mla(ctx, p.pop("mla"), lead)
    if "moe" in p:
        out["moe"] = moe.shard_moe(ctx, cfg, p.pop("moe"), lead)
    else:
        out["mlp"] = transformer.shard_mlp(ctx, cfg, p.pop("mlp"), lead)
    return out


def heads_per_rank(ctx: ATPContext, cfg: ModelConfig) -> int:
    if cfg.num_heads % ctx.tp:
        raise ValueError(f"MLA heads ({cfg.num_heads}) must divide over "
                         f"the flat TP ranks ({ctx.tp})")
    return cfg.num_heads // ctx.tp


def _up(ctx: ATPContext, latent, w, per_head: int):
    """A latent through this rank's block of up-projection heads: the ax2
    block of the ax1-sharded columns (``w`` synced over ax2, since each ax2
    rank reads one block of it)."""
    n = w.shape[-1] // ctx.d2
    w = grad_sync(ctx, w, ctx.ax2).narrow(-1, ctx.index2() * n, n)
    u = ops.matmul(latent, w)
    return u.reshape(u.shape[:-1] + (n // per_head, per_head))


def mla_block(ctx: ATPContext, cfg: ModelConfig, p, x, positions,
              cache: dict | None = None, paged: dict | None = None):
    """x [b, s, h/d2] (the entry norm's output) -> the attention's output
    [b, s, h/d2].

    No cache (training, the cache-free prefill, the MTP draft block): q/k
    of ``qk_nope + qk_rope`` and v of ``v_head_dim`` per head through the
    attention kernel (``L.attention_core``, scale 1/sqrt of q's dim).
    Paged (serving): ``cache`` holds this layer's latent pools ``ckv [np,
    pg, rank]`` and ``krope [np, pg, rope]`` (int8/fp8 with ``ckv_scale``/
    ``krope_scale`` [np, pg] fp16 beside them), written in place through
    ``paged``'s table, start and write plan.  Contiguous (the wave):
    ``ckv [b, s_max, rank]``, ``krope`` and ``len``, written at ``len`` in
    place and ``len`` advanced.  Both cached forms score against the latent
    (the absorbed form) in fp32."""
    m = cfg.mla
    nope, rope, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    h_loc = heads_per_rank(ctx, cfg)
    # the block input meets full-width down-projections on every ax1 rank:
    # their gradients are ax1-partial (under seq_parallel the entry norm's
    # gather reduce-scatters them instead)
    xc = x if ctx.seq_parallel else conjugate(ctx, x, ctx.ax1)
    cq = atp_boundary(ctx, ops.matmul(xc, grad_sync(ctx, p["w_dq"],
                                                    ctx.ax1)), ctx.ax2)
    cq = ops.rmsnorm(cq, grad_sync(ctx, p["q_ln"], ctx.ax1),
                     eps=cfg.norm_eps)
    ckv_full = atp_boundary(ctx, ops.matmul(xc, grad_sync(ctx, p["w_dkv"],
                                                          ctx.ax1)), ctx.ax2)
    ckv = ops.rmsnorm(ckv_full[..., :m.kv_lora_rank],
                      grad_sync(ctx, p["kv_ln"], ctx.ax1), eps=cfg.norm_eps)
    k_rope = ckv_full[..., m.kv_lora_rank:]            # [b, s, rope]

    # the latents meet this rank's heads: their gradients are ax2-partial
    q = _up(ctx, conjugate(ctx, cq, ctx.ax2), p["w_uq"], nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = L.apply_rope(q_pe, positions, cfg.rope_theta)
    if cache is None:
        kv = _up(ctx, conjugate(ctx, ckv, ctx.ax2), p["w_ukv"], nope + dv)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        k_pe = L.apply_rope(conjugate(ctx, k_rope, ctx.ax2)[:, :, None, :],
                            positions, cfg.rope_theta)
        k = torch.cat([k_nope, k_pe.expand(k_nope.shape[:-1] + (rope,))],
                      dim=-1)
        qq = torch.cat([q_nope, q_pe], dim=-1)
        b, s = x.shape[:2]
        o = L.attention_core(cfg, qq, k, v.contiguous(),
                             q_offset=torch.zeros(b, dtype=torch.int32,
                                                  device=x.device),
                             kv_len=torch.full((b,), s, dtype=torch.int32,
                                               device=x.device))
    else:
        o = _absorbed(ctx, cfg, p, x, positions, q_nope, q_pe, ckv, k_rope,
                      cache, paged, h_loc)
    o = o.reshape(o.shape[0], o.shape[1], h_loc * dv)
    # back to the ax1-sharded layout of the row-first wo
    if ctx.ax2 is not None:
        o = all_gather(ctx, o, ctx.ax2, dim=-1)
    return atp_linear(ctx, o, p["wo"], kind="row")


def _absorbed(ctx: ATPContext, cfg: ModelConfig, p, x, positions, q_nope,
              q_pe, ckv, k_rope, cache, paged, h_loc):
    """The cached attention against the latent: ``W_uk`` absorbed into q,
    fp32 scores over the cached latent and roped keys, masked at each
    row's position, softmax, the latent-weighted sum and ``W_uv``."""
    m = cfg.mla
    nope, dv = m.qk_nope_head_dim, m.v_head_dim
    sq = x.shape[1]
    k_pe_new = L.apply_rope(k_rope[:, :, None, :], positions,
                            cfg.rope_theta)[:, :, 0]
    if paged is not None:
        table, start = paged["table"], paged["start"]
        pd = paging.pool_page_dtype(cache["ckv"])
        w = paged.get("write")
        paging.append_tokens_q(cache["ckv"], cache.get("ckv_scale"), table,
                               start, ckv, pd, w)
        paging.append_tokens_q(cache["krope"], cache.get("krope_scale"),
                               table, start, k_pe_new, pd, w)
        cckv = paging.gather_pages_q(cache["ckv"], cache.get("ckv_scale"),
                                     table, out_dtype=ckv.dtype)
        ckr = paging.gather_pages_q(cache["krope"], cache.get("krope_scale"),
                                    table, out_dtype=k_pe_new.dtype)
        qpos = start.long()[:, None] + torch.arange(sq, device=x.device)
    else:
        klen = cache["len"]
        rows = klen.long() + torch.arange(sq, device=x.device)
        cache["ckv"].index_copy_(1, rows, ckv.to(cache["ckv"].dtype))
        cache["krope"].index_copy_(1, rows, k_pe_new.to(cache["krope"].dtype))
        cckv, ckr = cache["ckv"], cache["krope"]
        qpos = (klen.long() + torch.arange(sq, device=x.device))[None, :]
        klen.add_(sq)
    w_ukv = p["w_ukv"].reshape(m.kv_lora_rank, -1, nope + dv)
    w_ukv = w_ukv.narrow(1, ctx.index2() * h_loc, h_loc)  # [rank, h_loc, .]
    w_uk, w_uv = w_ukv[..., :nope], w_ukv[..., nope:]
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk.to(q_nope.dtype))
    scores = (torch.einsum("bqhr,bkr->bhqk", q_abs.float(), cckv.float())
              + torch.einsum("bqhd,bkd->bhqk", q_pe.float(), ckr.float())
              ) / math.sqrt(nope + m.qk_rope_head_dim)
    kpos = torch.arange(cckv.shape[1], device=x.device)
    vis = kpos[None, None, :] <= qpos[:, :, None]        # [b|1, sq, S]
    scores = scores.masked_fill(~vis[:, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhqk,bkr->bqhr", probs, cckv.float())
    return torch.einsum("bqhr,rhd->bqhd", o_lat, w_uv.float()).to(x.dtype)


def mla_layer(ctx: ATPContext, cfg: ModelConfig, p, x, positions,
              cache: dict | None = None, paged: dict | None = None):
    """One ``mla_dense`` or ``mla_moe`` layer (the reference's
    ``_apply_block``): entry norm, MLA, residual; entry norm, the MLP (or
    the MoE FFN), residual.  Returns (x, the MoE aux loss or None).  Under
    ``seq_parallel`` (``mla_dense`` only: a plan masks it for MoE) the
    entry norms gather the sequence and ``wo``/the down projection
    reduce-scatter it."""
    sp = ctx.seq_parallel and cache is None
    h = L.norm(ctx, cfg, x, p["ln_attn"], gather_seq=sp)
    x = x + mla_block(ctx, cfg, p["mla"], h, positions, cache, paged)
    h = L.norm(ctx, cfg, x, p["ln_mlp"], gather_seq=sp)
    if "moe" in p:
        m, aux = moe.moe_block(ctx, cfg, p["moe"], h)
        return x + m, aux
    return x + transformer.mlp_block(ctx, cfg, p["mlp"], h), None
