"""Shared model layers, ATP-sharded (counterpart of ``repro.models.layers``).

Activation convention between blocks (paper Fig. 6): replicated over tp1,
feature-sharded over tp2 — local shape ``[..., d_model/d2]``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.atp import (ATPContext, all_gather, atp_boundary,
                                  conjugate, grad_sync, seq_gather,
                                  shard_slice)
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# Shard cutting: the PartitionSpecs of repro.models.layers as functions that
# cut this rank's shard out of a global array.  A spec entry names the mesh
# axis a dim is split over (None: replicated).
# ---------------------------------------------------------------------------


def col_w_spec(ctx: ATPContext):
    """Column-first weight [K, N]: [Shard(1)@ax1, Shard(0)@ax2]."""
    return (ctx.ax2, ctx.ax1)


def row_w_spec(ctx: ATPContext):
    """Row-first weight [K, N]: [Shard(0)@ax1, Shard(1)@ax2]."""
    return (ctx.ax1, ctx.ax2)


def col_b_spec(ctx: ATPContext):
    return (ctx.ax1,)


def feat_spec(ctx: ATPContext):
    """1D feature param (norm scale): sharded like activations (ax2)."""
    return (ctx.ax2,)


def embed_spec(ctx: ATPContext):
    """Embedding [V, h]: vocab over ax1, features over ax2."""
    return (ctx.ax1, ctx.ax2)


def head_spec(ctx: ATPContext):
    """LM head [h, V]: rows over ax2, vocab over ax1."""
    return (ctx.ax2, ctx.ax1)


def cut(ctx: ATPContext, x: torch.Tensor, spec, lead: int = 0) -> torch.Tensor:
    """This rank's shard of global ``x`` under ``spec`` (one entry per dim
    after ``lead`` unsplit leading dims, e.g. the stacked layer dim).
    Returns ``x`` itself when nothing is split, else a contiguous copy."""
    sliced = False
    for i, axis in enumerate(spec):
        if axis is None:
            continue
        dim = lead + i
        n = ctx.topo.axis_size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axis}={n}")
        size = x.shape[dim] // n
        x = x.narrow(dim, ctx.coords[axis] * size, size)
        sliced = True
    return x.contiguous() if sliced else x


#: the port's fused leaves: each is this rank's shards of the JAX
#: package's leaves named here, concatenated in this order along the last
#: dim (``transformer.shard_dense_block``, ``mamba2.shard_mamba``)
FUSED_LEAVES = {"w_qkv": ("wq", "wk", "wv"), "b_qkv": ("bq", "bk", "bv"),
                "w_upgate": ("w_up", "w_gate"), "w_zx": ("w_z", "w_x")}


def fused_widths(cfg: ModelConfig, ctx: ATPContext, name: str,
                 width: int) -> tuple | None:
    """The widths along the last dim of the pieces of this rank's leaf
    ``name`` (``width`` wide), in ``FUSED_LEAVES`` order: q|k|v and their
    biases this rank's q and kv columns, up|gate and z|x two halves; None
    for a leaf that is not fused."""
    if name not in FUSED_LEAVES:
        return None
    if name in ("w_qkv", "b_qkv"):
        kvd = cfg.kv_dim // ctx.d1
        return (cfg.q_dim // ctx.d1, kvd, kvd)
    return (width // 2,) * 2


def split_fused(cfg: ModelConfig, ctx: ATPContext, name: str,
                t: torch.Tensor):
    """(the JAX package's leaf name, its piece) of this rank's fused leaf
    ``name``."""
    return zip(FUSED_LEAVES[name], t.split(
        fused_widths(cfg, ctx, name, t.shape[-1]), dim=-1))


# ---------------------------------------------------------------------------
# Norms.  The feature dim is ax2-sharded, so the reduction needs one tiny
# all-reduce over ax2 between the sum of squares and the scale; the
# statistic, the same on every ax2 rank, then scales each rank's own
# features (its conjugate sums its gradient over ax2).  The scale's
# gradient needs no reduction of its own: the norm output's gradient comes
# back complete through the column-first GEMM's input conjugate
# (``core.atp``).
#
# Under the sequence-parallel block I/O spec (``ctx.seq_parallel``) the
# input is also sequence-sharded over ax1: each rank normalises its own
# tokens, so the scale's gradient is ax1-partial and takes one
# ``grad_sync`` over ax1.  ``gather_seq`` (the block-entry norms) gathers
# the output back to the full sequence; its backward reduce-scatters the
# consumer's partial gradient (``atp.seq_gather(reduce_grad=True)``: the
# column-first GEMM behind it takes no conjugate).
# ---------------------------------------------------------------------------


def _seq_out(ctx: ATPContext, out, gather_seq: bool):
    if not gather_seq:
        return out
    return seq_gather(ctx, out, dim=out.dim() - 2, reduce_grad=True)


def _seq_param(ctx: ATPContext, p):
    return grad_sync(ctx, p, ctx.ax1) if ctx.seq_parallel else p


def rms_norm(ctx: ATPContext, x, gamma, eps: float = 1e-6,
             plus_one: bool = False, gather_seq: bool = False):
    """RMSNorm of this rank's features: the whole-row kernel at d2 = 1;
    at d2 > 1 ``ops.split_rmsnorm``, whose partial and apply kernels sit
    around the all-reduce of the rows' sums over ax2, forward (sum x^2)
    and backward (sum dy gamma x)."""
    gamma = _seq_param(ctx, gamma)
    g = (1.0 + gamma) if plus_one else gamma
    if ctx.ax2 is None:
        out = ops.rmsnorm(x, g, eps=eps)
    else:
        out = ops.split_rmsnorm(
            x, g, width=x.shape[-1] * ctx.d2, eps=eps,
            reduce=lambda t: atp_boundary(ctx, t, ctx.ax2))
    return _seq_out(ctx, out, gather_seq)


def layer_norm(ctx: ATPContext, x, gamma, beta, eps: float = 1e-5,
               gather_seq: bool = False):
    gamma, beta = _seq_param(ctx, gamma), _seq_param(ctx, beta)
    xf = x.float()
    d = x.shape[-1] * ctx.d2
    mu = conjugate(ctx, atp_boundary(ctx, xf.sum(-1, keepdim=True),
                                     ctx.ax2) / d, ctx.ax2)
    ss = atp_boundary(ctx, ((xf - mu) ** 2).sum(-1, keepdim=True), ctx.ax2)
    inv = conjugate(ctx, torch.rsqrt(ss / d + eps), ctx.ax2)
    out = ((xf - mu) * inv * gamma.float() + beta.float()).to(x.dtype)
    return _seq_out(ctx, out, gather_seq)


def norm(ctx: ATPContext, cfg: ModelConfig, x, p, gather_seq: bool = False):
    if cfg.norm_kind == "layernorm":
        return layer_norm(ctx, x, p["scale"], p["bias"], cfg.norm_eps,
                          gather_seq=gather_seq)
    plus_one = cfg.name.startswith("gemma2")
    return rms_norm(ctx, x, p["scale"], cfg.norm_eps, plus_one=plus_one,
                    gather_seq=gather_seq)


def norm_params(cfg: ModelConfig, d: int):
    if cfg.norm_kind == "layernorm":
        return {"scale": torch.ones(d), "bias": torch.zeros(d)}
    init = torch.zeros if cfg.name.startswith("gemma2") else torch.ones
    return {"scale": init(d)}


# ---------------------------------------------------------------------------
# RoPE (split-half convention).
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None):
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: [b, s, heads, hd]; positions: [b, s] int."""
    hd = x.shape[-1]
    ang = positions[..., None].float() * rope_freqs(hd, theta, x.device)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention sharding plan.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnPlan:
    """Static plan for sharding the attention core over d1*d2 flat ranks.

    g          : number of head blocks (ranks holding distinct q heads)
    q_loc      : q heads per block
    r          : leftover rank factor (redundant compute in decode)
    q_regroup  : q must be all-gathered over ax1 (Hq % d1 != 0)
    kv_regroup : k/v must be all-gathered over ax1 (KV % d1 != 0)
    """

    g: int
    q_loc: int
    r: int
    h2: int
    q_regroup: bool
    kv_regroup: bool
    kv_count: int
    ratio: int  # q heads per kv head


def make_attn_plan(ctx: ATPContext, num_heads: int, num_kv: int) -> AttnPlan:
    n, d1, d2 = ctx.tp, ctx.d1, ctx.d2
    q_regroup = num_heads % d1 != 0
    if q_regroup:
        g = math.gcd(num_heads, n)
        h2 = 1
    else:
        h2 = math.gcd(num_heads // d1, d2)
        g = d1 * h2
    q_loc = num_heads // g
    r = n // g
    ratio = max(1, num_heads // num_kv)
    kv_count = max(1, q_loc // ratio)
    kv_regroup = num_kv % d1 != 0
    return AttnPlan(g=g, q_loc=q_loc, r=r, h2=h2, q_regroup=q_regroup,
                    kv_regroup=kv_regroup, kv_count=kv_count, ratio=ratio)


def _block_and_r_index(ctx: ATPContext, plan: AttnPlan) -> tuple[int, int]:
    """(head-block id, r-index) for this rank."""
    if plan.q_regroup:
        i = ctx.tp_index()
        return i // plan.r, i % plan.r
    i2 = ctx.index2()
    return ctx.index1() * plan.h2 + i2 // plan.r, i2 % plan.r


def split_qkv_heads(ctx: ATPContext, cfg: ModelConfig, qp, kp, vp,
                    plan: AttnPlan):
    """qp/kp/vp: per-part GEMM outputs, each ``[..., part_dim/d1]``
    ax1-sharded and ax2-replicated.

    Returns this core rank's (q [b,s,q_loc,hd], k/v [b,s,kv_count,hd],
    block id, r index).  Under autograd, each part (the same on every ax2
    rank, and after a regroup's gather on every ax1 rank too) meets the
    rank's own heads or rows: its conjugate sums the heads' gradients over
    those axes."""
    hd, d1 = cfg.hd, ctx.d1
    bid, rid = _block_and_r_index(ctx, plan)
    qp, kp, vp = (conjugate(ctx, t, ctx.ax2) for t in (qp, kp, vp))

    if plan.q_regroup:
        q = all_gather(ctx, qp, ctx.ax1, dim=-1) if ctx.ax1 else qp
        q = conjugate(ctx, q, ctx.ax1)
        q = q.reshape(q.shape[:-1] + (cfg.num_heads, hd))
        q = q.narrow(-2, bid * plan.q_loc, plan.q_loc)
    else:
        q = qp.reshape(qp.shape[:-1] + (cfg.num_heads // d1, hd))
        sub = (bid % plan.h2) if plan.h2 > 1 else 0
        q = q.narrow(-2, sub * plan.q_loc, plan.q_loc)

    if plan.kv_regroup:
        k = all_gather(ctx, kp, ctx.ax1, dim=-1) if ctx.ax1 else kp
        v = all_gather(ctx, vp, ctx.ax1, dim=-1) if ctx.ax1 else vp
        k, v = conjugate(ctx, k, ctx.ax1), conjugate(ctx, v, ctx.ax1)
        k = k.reshape(k.shape[:-1] + (cfg.num_kv_heads, hd))
        v = v.reshape(v.shape[:-1] + (cfg.num_kv_heads, hd))
        kv_start = (bid * plan.q_loc) // plan.ratio
    else:
        k = kp.reshape(kp.shape[:-1] + (cfg.num_kv_heads // d1, hd))
        v = vp.reshape(vp.shape[:-1] + (cfg.num_kv_heads // d1, hd))
        local_q_start = (bid % plan.h2) * plan.q_loc if plan.h2 > 1 else 0
        kv_start = local_q_start // plan.ratio
    k = k.narrow(-2, kv_start, plan.kv_count)
    v = v.narrow(-2, kv_start, plan.kv_count)
    return q, k, v, bid, rid


def _merge_r(gathered, r: int, seq_split: bool):
    """[n, r, b, s_r, F] -> [n, b, s, F]: the r ranks' rows of the sequence
    concatenated (``seq_split``), or copy 0 of r redundant ones (decode)."""
    n, _, b, s_r, f = gathered.shape
    if seq_split and r > 1:
        return gathered.permute(0, 2, 1, 3, 4).reshape(n, b, r * s_r, f)
    return gathered[:, 0]


def core_output_gather(ctx: ATPContext, cfg: ModelConfig, o, plan: AttnPlan,
                       seq_split: bool = False):
    """o: [b, s_r, q_loc, hd] core output -> [b, s, q_dim/d1],
    ax2-replicated.  ``seq_split``: the r leftover ranks each took a slice
    of the query rows (training, a full sequence); else they hold redundant
    copies (decode), and one copy per head block is kept."""
    b, s = o.shape[:2]
    o = o.reshape(b, s, plan.q_loc * cfg.hd)
    if ctx.tp == 1:
        return o
    if plan.q_regroup:
        gathered = all_gather(ctx, o, ctx.tp_axes, dim=0, tiled=False)
        # entries ordered by flat index = bid * r + rid
        gathered = _merge_r(gathered.reshape((plan.g, plan.r) + o.shape),
                            plan.r, seq_split)
        # heads: [g, b, s, F] -> [b, s, g*F], then this rank's ax1 part
        full = gathered.permute(1, 2, 0, 3).reshape(
            b, gathered.shape[2], plan.g * o.shape[2])
        return shard_slice(conjugate(ctx, full, ctx.ax1), ctx.index1(),
                           ctx.d1, dim=2)
    if ctx.ax2 is None:
        return o
    gathered = all_gather(ctx, o, ctx.ax2, dim=0, tiled=False)  # [d2, b, s, F]
    gathered = _merge_r(gathered.reshape((plan.h2, plan.r) + o.shape),
                        plan.r, seq_split)
    return gathered.permute(1, 2, 0, 3).reshape(
        b, gathered.shape[2], plan.h2 * o.shape[2])


# ---------------------------------------------------------------------------
# Attention core.
# ---------------------------------------------------------------------------


def attention_core(cfg: ModelConfig, q, k, v, q_offset, kv_len,
                   window: int = 0):
    """q: [b, sq, hq, hd]; k/v: [b, skv, hkv, hd]; q_offset/kv_len [b].

    Causal attention at per-row offsets and lengths through the
    flash-attention kernel (plain version on the CPU): query row i of batch
    row b sits at ``q_offset[b] + i`` and sees keys ``< kv_len[b]``."""
    return ops.flash_attention(q, k, v, q_offset, kv_len, causal=True,
                               window=window, softcap=cfg.attn_softcap)
