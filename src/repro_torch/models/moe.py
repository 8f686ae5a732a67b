"""Mixture-of-Experts with expert parallelism over the flat TP ranks
(counterpart of ``repro.models.moe``).

The experts are cut over the d1*d2 flat TP ranks (EP), rank ``i1 * d2 +
i2`` holding experts ``[rank * e_loc, +e_loc)``: the group-rank order of
the flat TP group, which ``all_to_all`` sends in.  ATP's boundaries have
no role inside an expert; the block dispatches tokens by all-to-all:

  1. token scatter: an all-to-all over ax2 swaps the token blocks for the
     feature shards, then each ax1 rank takes its block of tokens (a free
     slice), so every flat TP rank holds 1/n of the tokens at full width;
  2. routing in fp32 (softmax, top-k renormalised) and the Switch aux loss,
     averaged over the flat TP group;
  3. capacity-bounded slots, a send buffer ``[n, e_loc * cap, h]`` and an
     all-to-all over the flat TP group;
  4. each local expert's FFN through the matmul kernel (up|gate fused per
     expert in ``w_upgate``, ``layers.FUSED_LEAVES``);
  5. the all-to-all back and the weighted combine;
  6. the token gather back to the block I/O spec: an all-gather over ax1
     (the reference places and psums, for JAX's invariance typing: twice
     the wire bytes) and the inverse all-to-all over ax2.

Where a step has fewer tokens than ranks (a decode tick) every rank keeps
all of them, runs its local experts only, and one all-reduce over the flat
TP group combines.  Every shape is static and no step syncs the host, so
the paged step stays capturable: a dropped slot is sent to a spare row by
index arithmetic, and every local expert runs, empty or not, as in the
reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.atp import (ATPContext, all_gather, all_to_all,
                                  atp_boundary, conjugate, grad_sync,
                                  scatter_slice, shard_slice)
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer


def moe_params(gen, cfg: ModelConfig, dtype, device) -> dict:
    """Global MoE params with the reference's keys and distributions: an
    fp32 router ``[h, e]`` and per-expert ``w_up``/``w_gate [e, h, ff]``
    and ``w_down [e, ff, h]`` (plus a dense ``shared`` MLP of
    ``num_shared`` experts' width)."""
    mc = cfg.moe
    h, ff, e = cfg.d_model, mc.d_ff_expert, mc.num_experts
    s = 1.0 / math.sqrt(h)
    normal = transformer._normal
    p = {"router": normal(gen, (h, e), 0.02, torch.float32, device),
         "w_up": normal(gen, (e, h, ff), s, dtype, device),
         "w_gate": normal(gen, (e, h, ff), s, dtype, device),
         "w_down": normal(gen, (e, ff, h), 1.0 / math.sqrt(ff), dtype,
                          device)}
    if mc.num_shared:
        p["shared"] = transformer.mlp_params(
            gen, cfg, dtype, device, d_ff=mc.d_ff_expert * mc.num_shared)
    return p


def expert_spec(ctx: ATPContext):
    """Expert-stacked weights ``[e, ...]``: experts over the flat TP axes
    (the reference's ``PartitionSpec(("tp1", "tp2"))``)."""
    return (ctx.tp_axes or None,)


def shard_moe(ctx: ATPContext, cfg: ModelConfig, p: dict,
              lead: int = 1) -> dict:
    """This rank's shard of (layer-stacked) MoE params: its experts, with
    each expert's up and gate fused into ``w_upgate [.., e_loc, h, 2 ff]``;
    the router replicated.  Pops the global leaves it consumed."""
    ep = expert_spec(ctx)
    out = {"router": p.pop("router"),
           "w_upgate": torch.cat([L.cut(ctx, p.pop(k), ep, lead)
                                  for k in L.FUSED_LEAVES["w_upgate"]],
                                 dim=-1),
           "w_down": L.cut(ctx, p.pop("w_down"), ep, lead)}
    if "shared" in p:
        out["shared"] = transformer.shard_mlp(ctx, cfg, p.pop("shared"), lead)
    return out


def _experts(p, xin):
    """Each local expert's SwiGLU FFN on its rows: ``xin [e_loc, rows, h]``
    -> ``[e_loc, rows, h]``, two matmul launches an expert."""
    ys = []
    for i in range(xin.shape[0]):
        up, gate = ops.matmul(xin[i], p["w_upgate"][i]).chunk(2, dim=-1)
        ys.append(ops.matmul(up * F.silu(gate), p["w_down"][i]))
    return torch.stack(ys)


def _to_features(ctx: ATPContext, t):
    """[T, h/d2] -> [T/d2, h]: the all-to-all over ax2 that trades each
    rank's feature shard of every token for every feature shard of its own
    block of tokens (a plain all-gather would mix the shards of other
    token blocks)."""
    if ctx.ax2 is None:
        return t
    d2, (T, hl) = ctx.d2, t.shape
    r = all_to_all(ctx, t, ctx.ax2)
    return r.view(d2, T // d2, hl).transpose(0, 1).reshape(T // d2, d2 * hl)


def _to_tokens(ctx: ATPContext, c):
    """[T/d2, h] -> [T, h/d2], the inverse of :func:`_to_features`."""
    if ctx.ax2 is None:
        return c
    d2, (tb, h) = ctx.d2, c.shape
    c = c.view(tb, d2, h // d2).transpose(0, 1).reshape(d2 * tb, h // d2)
    return all_to_all(ctx, c, ctx.ax2)


def route(ctx: ATPContext, cfg: ModelConfig, router, tokens):
    """fp32 routing of ``tokens [t, h]``: (the top-k expert ids [t, k], their
    renormalised gates [t, k], the aux loss).  The aux loss is the Switch
    load-balance term, averaged over the flat TP group (each rank routes
    its own tokens)."""
    mc = cfg.moe
    gates = torch.softmax(tokens.float() @ router, dim=-1)
    topv, topi = torch.topk(gates, mc.top_k, dim=-1)
    topv = topv / (topv.sum(-1, keepdim=True) + 1e-9)
    e = mc.num_experts
    first = (topi[:, :1] == torch.arange(e, device=topi.device)).float()
    aux = (gates.mean(0) * first.mean(0)).sum() * e
    if ctx.tp_axes:
        aux = atp_boundary(ctx, aux, ctx.tp_axes) / ctx.tp
    return topi, topv, aux


def moe_block(ctx: ATPContext, cfg: ModelConfig, p, x):
    """x [b, s, h/d2] -> (the same spec, the aux loss).  Capacity-dropped
    top-k routing (the reference's ``moe_block``).  Under autograd the
    router's gradient is synced over the flat TP group (``grad_sync``);
    on the replicated path the tokens' gradient, partial per rank's local
    experts, is conjugated over it."""
    mc = cfg.moe
    n, k = ctx.tp, mc.top_k
    b, s, hl = x.shape
    h, e = cfg.d_model, mc.num_experts
    e_loc = max(1, e // n)
    T = b * s
    t = x.reshape(T, hl)
    replicated = T % n != 0 or T // n == 0
    if replicated:
        # decode-sized steps: every rank keeps all tokens at full width
        tokens = conjugate(ctx, all_gather(ctx, t, ctx.ax2, dim=-1),
                           ctx.tp_axes)
    else:
        tokens = scatter_slice(ctx, _to_features(ctx, t), ctx.ax1, 0)

    router = grad_sync(ctx, p["router"], ctx.tp_axes)
    topi, topv, aux = route(ctx, cfg, router, tokens)

    # capacity-bounded slots: the position of each (token, choice) among
    # its expert's, in token-major, choice-minor order
    tn = tokens.shape[0]
    cap = max(1, int(mc.capacity_factor * tn * k / e))
    flat_e = topi.reshape(-1)
    flat_w = topv.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(e, device=x.device)).long()
    slot = (onehot.cumsum(0) * onehot).sum(-1) - 1
    keep = slot < cap
    dst = flat_e // e_loc
    tok_rep = tokens.repeat_interleave(k, dim=0)

    def combine(rows, y, live):
        """The rows of ``y`` each (token, choice) reads (0 where it was
        dropped), weighted by its gate and summed over the choices."""
        got = y.index_select(0, torch.where(live, rows, 0))
        got = torch.where(live[:, None], got, torch.zeros_like(got))
        return (got * flat_w[:, None].to(got.dtype)).view(tn, k, h).sum(1)

    if replicated:
        mine = keep & (dst == ctx.tp_index())
        rows = (flat_e % e_loc) * cap + slot
        spare = e_loc * cap   # the row a slot that is not mine lands in
        buf = tokens.new_zeros(spare + 1, h).index_add(
            0, torch.where(mine, rows, spare), tok_rep)[:spare]
        y = _experts(p, buf.view(e_loc, cap, h)).view(spare, h)
        combined = atp_boundary(ctx, combine(rows, y, mine), ctx.tp_axes)
        if ctx.ax2 is not None:
            combined = shard_slice(conjugate(ctx, combined, ctx.ax2),
                                   ctx.index2(), ctx.d2, dim=-1)
    else:
        # the send buffer [n, e_loc * cap, h], flat; a dropped slot goes to
        # the spare row past its end
        rows = dst * (e_loc * cap) + (flat_e % e_loc) * cap + slot
        spare = n * e_loc * cap
        send = tokens.new_zeros(spare + 1, h).index_add(
            0, torch.where(keep, rows, spare), tok_rep)[:spare]
        recv = all_to_all(ctx, send, ctx.tp_axes)
        xin = recv.view(n, e_loc, cap, h).transpose(0, 1).reshape(
            e_loc, n * cap, h)
        y = _experts(p, xin).view(e_loc, n, cap, h).transpose(0, 1)
        back = all_to_all(ctx, y.reshape(spare, h), ctx.tp_axes)
        combined = all_gather(ctx, combine(rows, back, keep), ctx.ax1, dim=0)
        combined = _to_tokens(ctx, combined)
    out = combined.reshape(b, s, hl)
    if mc.num_shared:
        out = out + transformer.mlp_block(ctx, cfg, p["shared"], x)
    return out, aux
