"""xLSTM blocks (mLSTM + sLSTM), ATP-sharded (counterpart of
``repro.models.xlstm``): the paged serving path, where every call carries
its rows' recurrent state, and the cache-free training path, which starts
from zeros.

mLSTM: the matrix memory C_t = f_t C_{t-1} + i_t v_t k_t^T with readout
h_t = (C_t q_t) / max(|n_t . q_t|, 1), computed chunkwise, the normalizer n
folded in as an extra value channel of ones (state ``[b, nh, dk, dv+1]``).
Sharding, as in the JAX block:
  - up/z projections: one column-first GEMM (``w_uz``, this rank's w_up
    and w_z column shards fused in the order the JAX block concatenates
    them) and one boundary over ax2, then a d2 sub-slice per rank.  The
    columns are head-major, so a rank's flat slice is its (head block,
    value-dim slice) shard: ``mlstm_plan`` gives (head shard g, value-dim
    shard r) with g * r = tp;
  - q/k and the i/f gates come from the block input: q/k column-first and
    gathered over ax1, the gates from ``w_if`` (rows over ax2, a
    replicated output); every rank slices its own heads;
  - the conv is depthwise on the local channels (``mamba2.causal_conv``);
  - the down projection's rows are flat-sharded: one all-reduce over both
    TP axes, then the free ax2 feature slice.
The chunkwise scan, the per-head group norm (eps 1e-6) and the gates are
plain torch, as the JAX block computes them outside any Pallas kernel; the
projections run through ``kernels.ops.matmul`` and the entry norm through
``layers.rms_norm``.  Where r > 1 a head's value dim lies on r ranks, and
its group norm's sum of squares is summed over them (a [b, s, g]
all-reduce): the JAX block normalises each rank's slice on its own, so its
result on such a mesh departs from one device's, where the port's does
not (ROADMAP §C).

sLSTM: sequential and small, so replicated over TP: the block input is
gathered to full width over ax2, the recurrence runs as a loop over
positions in fp32 (``w_gates`` and ``r_gates`` are fp32 whatever the model
dtype: the input product stays a plain fp32 ``torch.matmul``), and each
ax2 rank keeps its feature slice of the output.  Its FFN (d_model ->
int(1.3 d_model) -> d_model) runs through ``ops.matmul`` with the tanh
gelu in the epilogue.

Under autograd (``core.atp``'s typing, the JAX package's vma path): the
up/z output, the same on every ax2 rank, is conjugated over ax2 before
each rank takes its slice; the gathered q/k and the gate pre-activations
meet only this rank's heads, so q/k is conjugated over the flat TP axes
and the gates over ax2, with ``w_if`` (replicated over ax1) synced over
ax1 and ``b_if`` (added past the boundary) over the flat TP axes; the
flat-sharded leaves (``conv``, ``gn``, ``w_down``) hold their own complete
gradients.  The sLSTM's output is conjugated over ax2 before the slice, so
the whole replicated recurrence sees the complete gradient and its leaves
need no reduction of their own: the JAX package's legacy path reduces each
leaf's rank-partial gradient with a ``grad_sync`` instead (its vma path
with a barrier on the recurrence's output), the same sum.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.atp import (ATPContext, all_gather, atp_boundary,
                                  atp_linear, conjugate, grad_sync,
                                  shard_slice)
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.mamba2 import causal_conv
from repro_torch.models.transformer import _normal

#: the leaf names of the JAX package's sLSTM, every one replicated over TP
SLSTM_LEAVES = ("ln", "w_gates", "r_gates", "b_gates", "gn", "w_ff1",
                "w_ff2")


def mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_inner, heads, q/k dim, value dim)."""
    d_inner = int(cfg.ssm.proj_factor * cfg.d_model)
    nh = cfg.num_heads
    dv = d_inner // nh
    return d_inner, nh, dv // 2, dv


def mlstm_plan(ctx: ATPContext, cfg: ModelConfig) -> tuple[int, int]:
    """(head shard g, value-dim shard r), g * r == the flat TP size."""
    _, nh, _, dv = mlstm_dims(cfg)
    g = math.gcd(nh, ctx.tp)
    r = ctx.tp // g
    if dv % r:
        raise ValueError(f"the mLSTM value dim {dv} does not split over "
                         f"the {r} ranks left after the heads")
    if nh // g != 1 and r != 1:
        raise ValueError("the flat column slice needs one head per block "
                         "(or r == 1)")
    return g, r


def _flat(ctx: ATPContext):
    return ctx.tp_axes or None


#: how each of the port's mLSTM leaves is cut, by the JAX
#: ``mlstm_param_specs`` (``w_uz`` is the fused w_up | w_z)
MLSTM_SPECS = {"ln": L.feat_spec, "w_uz": L.col_w_spec,
               "conv": lambda ctx: (None, _flat(ctx)),
               "w_qk": L.col_w_spec, "w_if": lambda ctx: (ctx.ax2, None),
               "b_if": lambda ctx: (),
               "w_down": lambda ctx: (_flat(ctx), None),
               "gn": lambda ctx: (_flat(ctx),)}
SLSTM_SPECS = {k: (lambda ctx: ()) for k in SLSTM_LEAVES}


def mlstm_params(gen, cfg: ModelConfig, dtype, device) -> dict:
    """One mLSTM block's global params with the JAX block's keys, scales
    and dtypes (``ln``, ``conv``, ``b_if`` and ``gn`` fp32)."""
    h = cfg.d_model
    d_inner, nh, dk, _ = mlstm_dims(cfg)
    s = 1.0 / math.sqrt(h)
    f32 = torch.float32
    return {
        "ln": torch.ones(h, device=device),
        "w_up": _normal(gen, (h, d_inner), s, dtype, device),
        "w_z": _normal(gen, (h, d_inner), s, dtype, device),
        "conv": _normal(gen, (cfg.ssm.conv_kernel, d_inner), 0.5, f32,
                        device),
        "w_qk": _normal(gen, (h, 2 * nh * dk), s, dtype, device),
        "w_if": _normal(gen, (h, 2 * nh), s, dtype, device),
        "b_if": torch.zeros(2 * nh, device=device),
        "w_down": _normal(gen, (d_inner, h), 1.0 / math.sqrt(d_inner),
                          dtype, device),
        "gn": torch.ones(d_inner, device=device),
    }


def slstm_params(gen, cfg: ModelConfig, dtype, device) -> dict:
    """One sLSTM block's global params: gates, recurrence, norms in fp32,
    the FFN in ``dtype``."""
    h, nh = cfg.d_model, cfg.num_heads
    dh, d_ff = h // nh, int(1.3 * h)
    s = 1.0 / math.sqrt(h)
    f32 = torch.float32
    return {
        "ln": torch.ones(h, device=device),
        "w_gates": _normal(gen, (h, 4 * h), s, f32, device),      # z i f o
        "r_gates": _normal(gen, (nh, dh, 4 * dh), 1.0 / math.sqrt(dh), f32,
                           device),
        "b_gates": torch.zeros(4 * h, device=device),
        "gn": torch.ones(h, device=device),
        "w_ff1": _normal(gen, (h, d_ff), s, dtype, device),
        "w_ff2": _normal(gen, (d_ff, h), 1.0 / math.sqrt(d_ff), dtype,
                         device),
    }


def shard_xlstm(ctx: ATPContext, p: dict) -> dict:
    """This rank's shard of an xlstm segment's params (the mLSTM leaves
    stacked ``[count, inner-1, ...]``, the sLSTM's ``[count, ...]``), by
    the JAX specs, w_up | w_z fused per rank.  Pops what it cut."""
    m, cut = p.pop("mlstm"), L.cut
    col = L.col_w_spec(ctx)
    out = {"w_uz": torch.cat([cut(ctx, m.pop(k), col, 2)
                              for k in L.FUSED_LEAVES["w_uz"]], dim=-1)}
    for k, spec in MLSTM_SPECS.items():
        if k != "w_uz":
            out[k] = cut(ctx, m.pop(k), spec(ctx), 2)
    return {"mlstm": out, "slstm": p.pop("slstm")}


def mlstm_chunked(q, k, v, li, lf, chunk: int, state=None):
    """Chunkwise mLSTM.  q, k [b, s, nh, dk]; v [b, s, nh, dv]; li, lf [b,
    s, nh] log input/forget gates (fp32); state [b, nh, dk, dv+1] fp32 or
    None for zeros.  Returns (h [b, s, nh, dv] in q's dtype, the state
    after the last position)."""
    b, s, nh, dk = q.shape
    dv = v.shape[-1]
    nc = max(1, s // chunk)
    cl = s // nc
    va = torch.cat([v, v.new_ones(v.shape[:-1] + (1,))], dim=-1)
    qr = q.reshape(b, nc, cl, nh, dk).float()
    kr = k.reshape(b, nc, cl, nh, dk).float()
    vr = va.reshape(b, nc, cl, nh, dv + 1).float()
    lir = li.reshape(b, nc, cl, nh)
    lc = torch.cumsum(lf.reshape(b, nc, cl, nh), dim=2)   # cumulative log f
    seg = lc[:, :, :, None, :] - lc[:, :, None, :, :]      # [b, nc, t, u, nh]
    causal = torch.ones(cl, cl, dtype=torch.bool, device=q.device).tril()
    # the masked entries' exponent would overflow: mask before the exp
    decay = torch.exp(seg.masked_fill(~causal[None, None, :, :, None],
                                      float("-inf")))
    qk = torch.einsum("bnthd,bnuhd->bntuh", qr, kr) / math.sqrt(dk)
    w = qk * decay * torch.exp(lir)[:, :, None, :, :]
    h_intra = torch.einsum("bntuh,bnuhe->bnthe", w, vr)

    dec_end = torch.exp(lc[:, :, -1:, :] - lc + lir)       # [b, nc, cl, nh]
    S = torch.einsum("bnuhd,bnuhe->bnhde", kr * dec_end[..., None], vr)
    gain = torch.exp(lc[:, :, -1, :])                      # [b, nc, nh]
    carry = (S.new_zeros(S[:, 0].shape) if state is None
             else state.float())
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * gain[:, c, :, None, None] + S[:, c]
    h_cross = (torch.einsum("bnthd,bnhde->bnthe", qr,
                            torch.stack(entering, dim=1))
               * torch.exp(lc)[..., None] / math.sqrt(dk))
    ha = (h_intra + h_cross).reshape(b, s, nh, dv + 1)
    out = ha[..., :dv] / ha[..., dv:].abs().clamp(min=1.0)
    return out.to(q.dtype), carry


def mlstm_step(q, k, v, li, lf, state):
    """One position.  q, k [b, 1, nh, dk]; v [b, 1, nh, dv]; li, lf [b, 1,
    nh]; state [b, nh, dk, dv+1].  Returns (h [b, 1, nh, dv], new state
    fp32)."""
    dk, dv = q.shape[-1], v.shape[-1]
    va = torch.cat([v, v.new_ones(v.shape[:-1] + (1,))], dim=-1)[:, 0]
    f = torch.exp(lf[:, 0])[:, :, None, None]
    i = torch.exp(li[:, 0])[:, :, None, None]
    new = state.float() * f + i * torch.einsum(
        "bhd,bhe->bhde", k[:, 0].float(), va.float())
    ha = torch.einsum("bhd,bhde->bhe", q[:, 0].float(), new) / math.sqrt(dk)
    out = ha[..., :dv] / ha[..., dv:].abs().clamp(min=1.0)
    return out[:, None].to(q.dtype), new


def mlstm_block(ctx: ATPContext, cfg: ModelConfig, p, x, state=None):
    """x [b, s, h/d2].  state: this call's rows of the layer's pools,
    ``conv [b, k-1, d_inner/n]`` and ``C [b, nh/g, dk, dv/r+1]`` fp32, or
    None (training: the conv and the scan start from zeros).  Returns (x +
    block output, the new state or None)."""
    d_inner, nh, dk, dv = mlstm_dims(cfg)
    g, r = mlstm_plan(ctx, cfg)
    hb = ctx.tp_index() // r          # head block (one head where r > 1)
    nh_loc, dv_loc = nh // g, dv // r
    i2 = ctx.index2()

    h_in = L.rms_norm(ctx, x, p["ln"], cfg.norm_eps)
    # up|z: one column-first GEMM and boundary, split per part BEFORE the d2
    # sub-slice: the flat slice of the head-major columns is this rank's
    # (head block, value-dim slice)
    uz = atp_linear(ctx, h_in, p["w_uz"], kind="col", chunked=False,
                    plain=True)
    u, z = conjugate(ctx, uz, ctx.ax2).chunk(2, dim=-1)
    u = shard_slice(u, i2, ctx.d2, dim=-1)             # [b, s, d_inner/n]
    z = shard_slice(z, i2, ctx.d2, dim=-1)
    u_c, conv_state = causal_conv(u, p["conv"],
                                  None if state is None else state["conv"])
    v = F.silu(u_c).unflatten(-1, (nh_loc, dv_loc))

    # q|k: column-first over ax1, then gathered: every rank holds every
    # head's q/k and takes its own
    qk = atp_linear(ctx, h_in, p["w_qk"], kind="col", chunked=False,
                    plain=True)
    if ctx.ax1 is not None:
        qk = all_gather(ctx, qk, ctx.ax1, dim=-1)
    qk = conjugate(ctx, qk, ctx.tp_axes)
    q = qk[..., :nh * dk].unflatten(-1, (nh, dk)).narrow(2, hb * nh_loc,
                                                          nh_loc)
    k = qk[..., nh * dk:].unflatten(-1, (nh, dk)).narrow(2, hb * nh_loc,
                                                          nh_loc)
    # i|f gates: rows over ax2, a replicated output
    gates = atp_linear(ctx, h_in, grad_sync(ctx, p["w_if"], ctx.ax1),
                       kind="col", chunked=False, plain=True)
    gates = (conjugate(ctx, gates, ctx.ax2).float()
             + grad_sync(ctx, p["b_if"], ctx.tp_axes))
    li = F.logsigmoid(gates[..., :nh]).narrow(-1, hb * nh_loc, nh_loc)
    lf = F.logsigmoid(gates[..., nh:]).narrow(-1, hb * nh_loc, nh_loc)

    new_state = None
    if state is None:
        y, _ = mlstm_chunked(q, k, v, li, lf, cfg.ssm.chunk)
    else:
        if q.shape[1] == 1:
            y, C = mlstm_step(q, k, v, li, lf, state["C"])
        else:                                          # prefill into state
            y, C = mlstm_chunked(q, k, v, li, lf, cfg.ssm.chunk,
                                 state=state["C"])
        new_state = {"conv": conv_state, "C": C}

    # per-head group norm, then the output gate from the local z slice
    yf = y.float()
    ss = yf.pow(2).sum(-1, keepdim=True)               # [b, s, nh_loc, 1]
    if r > 1:
        # the head's value dim is split over r ranks: its sum of squares is
        # their sum (each rank's placed at its head block, one [b, s, g]
        # all-reduce over the flat TP ranks)
        placed = F.pad(ss[..., 0], (hb, g - hb - 1))
        total = conjugate(ctx, atp_boundary(ctx, placed, _flat(ctx)),
                          _flat(ctx))
        ss = total.narrow(-1, hb, 1)[..., None]
    inv = torch.rsqrt(ss / dv + 1e-6)
    y = (yf * inv * p["gn"].reshape(nh_loc, dv_loc)).to(y.dtype)
    y = (y * F.silu(z.unflatten(-1, (nh_loc, dv_loc)))).flatten(-2)

    # down projection: rows flat-sharded, one all-reduce over both TP axes,
    # then this ax2 rank's features
    out = atp_boundary(ctx, ops.matmul(y, p["w_down"]), _flat(ctx))
    out = shard_slice(conjugate(ctx, out, ctx.ax2), i2, ctx.d2, dim=-1)
    return x + out, new_state


def rms_full(x, gamma, eps: float):
    """RMSNorm over the whole last dim in fp32 (the result stays fp32)."""
    xf = x.float()
    return xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * gamma


def slstm_block(ctx: ATPContext, cfg: ModelConfig, p, x, state=None):
    """x [b, s, h/d2]; the recurrence runs on the full-width activations,
    the same on every TP rank.  state: this call's rows of the layer's
    pools, ``c``, ``n``, ``h`` [b, nh, dh] fp32, or None (zeros; training).
    Returns (x + block output, the new state or None)."""
    nh, h = cfg.num_heads, cfg.d_model
    dh = h // nh
    b, s = x.shape[:2]
    xg = all_gather(ctx, x, ctx.ax2, dim=-1) if ctx.ax2 is not None else x
    pre = (torch.matmul(rms_full(xg, p["ln"], cfg.norm_eps), p["w_gates"])
           + p["b_gates"]).unflatten(-1, (nh, 4 * dh))      # [b, s, nh, 4dh]
    if state is None:
        c = n = hs = pre.new_zeros(b, nh, dh)
    else:
        c, n, hs = (state[k].float() for k in ("c", "n", "h"))
    ys = []
    for t in range(s):
        gts = pre[:, t] + torch.einsum("bhd,hde->bhe", hs, p["r_gates"])
        zt = torch.tanh(gts[..., :dh])
        i, f, o = torch.sigmoid(gts[..., dh:]).chunk(3, dim=-1)
        c = f * c + i * zt
        n = f * n + i
        hs = o * (c / n.clamp(min=1.0))
        ys.append(hs)
    y = rms_full(torch.stack(ys, dim=1).reshape(b, s, h), p["gn"],
                 cfg.norm_eps).to(x.dtype)
    y = ops.matmul(ops.matmul(y, p["w_ff1"], activation="gelu"), p["w_ff2"])
    # back to the block I/O feature shard
    y = shard_slice(conjugate(ctx, y, ctx.ax2), ctx.index2(), ctx.d2, dim=-1)
    new_state = None if state is None else {"c": c, "n": n, "h": hs}
    return x + y, new_state
