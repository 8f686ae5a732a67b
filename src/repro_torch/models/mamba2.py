"""Mamba2 (SSD) block, ATP-sharded (counterpart of ``repro.models.mamba2``):
the paged serving path, where every call carries the slot's recurrent
state, and the cache-free training path, which starts from zeros.

Sharding (as in the JAX block): SSD heads split over the flat d1*d2 TP
ranks; ATP applies to the projections:
  - z/x projection: column-first over ax1 (one fused GEMM ``w_zx``, one
    boundary over ax2), then a d2 sub-slice per rank;
  - B/C/dt projection: rows over ax2, all-reduced to a replicated output
    (B and C are shared by all heads, one group; dt is sliced per head
    block);
  - out projection: row-first, after an all-gather of the heads over ax2.

The scan runs through ``kernels.ops.ssd_scan`` for prefill chunks and
one-token steps alike (at s = 1 it is ``ssd_step``), reading and writing the
slot's row of the layer's SSD state pool in place; in training it starts
from zeros and its final state is dropped.  The grouped RMSNorm and its
SiLU gate run through ``kernels.ops.group_rmsnorm``, the rmsnorm kernel
with a per-head scale.  The causal conv is plain torch, as in JAX.

Under autograd (``core.atp``'s typing): the z|x and B|C|dt outputs, the
same on every ax2 rank, meet each rank's own heads, so each is
conjugated over ax2; ``w_bcdt``, replicated over ax1 while its gradient
stays ax1-partial, is synced over ax1; the replicated per-head leaves
(``dt_bias``, ``conv``, ``A_log``, ``D``, ``gn``), sliced to each flat
rank's heads, are synced over the TP axes, each exactly once, at the
reference's sites.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.atp import (ATPContext, all_gather, atp_linear,
                                  conjugate, grad_sync, shard_slice)
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import _normal


def mamba_dims(cfg: ModelConfig) -> tuple[int, int]:
    """(d_inner, SSD heads)."""
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    return d_inner, d_inner // sc.head_dim


def mamba_params(gen, cfg: ModelConfig, dtype, device) -> dict:
    """One block's global params with the JAX block's keys, scales and
    dtypes: the projections in ``dtype``; ``conv``, ``A_log``, ``D``,
    ``dt_bias``, ``ln`` and ``gn`` in fp32 whatever the model dtype."""
    sc, h = cfg.ssm, cfg.d_model
    d_inner, nheads = mamba_dims(cfg)
    s = 1.0 / math.sqrt(h)
    f32 = torch.float32
    return {
        "w_z": _normal(gen, (h, d_inner), s, dtype, device),
        "w_x": _normal(gen, (h, d_inner), s, dtype, device),
        "w_bcdt": _normal(gen, (h, 2 * sc.d_state + nheads), s, dtype, device),
        "conv": _normal(gen, (sc.conv_kernel, d_inner + 2 * sc.d_state), 0.5,
                        f32, device),
        "A_log": torch.zeros(nheads, device=device),
        "D": torch.ones(nheads, device=device),
        "dt_bias": torch.zeros(nheads, device=device),
        "w_out": _normal(gen, (d_inner, h), 1.0 / math.sqrt(d_inner), dtype,
                         device),
        "ln": torch.ones(h, device=device),
        "gn": torch.ones(d_inner, device=device),
    }


def shard_mamba(ctx: ATPContext, p: dict, lead: int) -> dict:
    """This rank's shard of (stacked) Mamba2 params, by the JAX
    ``mamba_param_specs``: ``w_z``/``w_x`` column-first, fused per rank as
    ``w_zx`` in the order the JAX block concatenates its local shards;
    ``w_bcdt`` rows over ax2; ``w_out`` row-first; ``ln`` like the
    activations.  ``conv``, ``A_log``, ``D``, ``dt_bias`` and ``gn`` stay
    replicated and are sliced per flat rank inside the block, as JAX does.
    ``lead`` counts the stacked leading dims; the global leaves are popped
    as they are cut."""
    cut, col = L.cut, L.col_w_spec(ctx)
    out = {"w_zx": torch.cat([cut(ctx, p.pop(k), col, lead)
                              for k in L.FUSED_LEAVES["w_zx"]], dim=-1),
           "w_bcdt": cut(ctx, p.pop("w_bcdt"), (ctx.ax2, None), lead),
           "w_out": cut(ctx, p.pop("w_out"), L.row_w_spec(ctx), lead),
           "ln": cut(ctx, p.pop("ln"), L.feat_spec(ctx), lead)}
    for k in ("conv", "A_log", "D", "dt_bias", "gn"):
        out[k] = p.pop(k)
    return out


def causal_conv(x, w, state=None):
    """Depthwise causal conv1d.  x [b, s, c]; w [k, c] (fp32); state
    [b, k-1, c], the previous inputs, or None for zeros.  Computed in fp32
    and cast to ``x.dtype``; returns (y, new_state in ``x.dtype``)."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros(x.shape[0], k - 1, x.shape[2])
    pad = torch.cat([state.to(x.dtype), x], dim=1)
    padf = pad.float()
    y = sum(padf[:, i:i + s] * w[i].float() for i in range(k))
    return y.to(x.dtype), pad[:, pad.shape[1] - (k - 1):]


def mamba_block(ctx: ATPContext, cfg: ModelConfig, p, x, state=None,
                ssd_pool=None, slot=None, fresh=None):
    """x [b, s, h/d2].  Serving: state holds this call's rows of the conv
    pools, ``conv_x [b, k-1, d_inner/n]`` and ``conv_bc [b, k-1, 2 ds]``;
    ``ssd_pool [slots, nh/n, hd, ds]`` fp32, the layer's SSD state pool,
    which the scan reads and writes in place at the rows ``slot [b]``
    (int32; the sentinel ``slots`` writes nothing), from zeros where
    ``fresh [b]``.  Training: no state and no pool, the conv and the scan
    start from zeros.  Returns (x + block output, new conv state or
    None)."""
    sc = cfg.ssm
    d_inner, nheads = mamba_dims(cfg)
    n = ctx.tp
    if nheads % n:
        raise ValueError(f"{nheads} SSD heads do not split over {n} TP ranks")
    nh_loc, ds = nheads // n, sc.d_state
    i2, flat = ctx.index2(), ctx.tp_index()
    b, s = x.shape[:2]

    h_in = L.rms_norm(ctx, x, p["ln"], cfg.norm_eps)
    # z|x: one column-first GEMM and boundary, split per part BEFORE the d2
    # sub-slice so the shard boundaries stay part-aligned
    zx = atp_linear(ctx, h_in, p["w_zx"], kind="col", chunked=False,
                    plain=True)
    z, xin = conjugate(ctx, zx, ctx.ax2).chunk(2, dim=-1)
    z = shard_slice(z, i2, ctx.d2, dim=-1)              # [b, s, d_inner/n]
    xin = shard_slice(xin, i2, ctx.d2, dim=-1)
    # B|C|dt: rows over ax2, so the ax2 boundary leaves it replicated
    bcdt = atp_linear(ctx, h_in, grad_sync(ctx, p["w_bcdt"], ctx.ax1),
                      kind="col", chunked=False, plain=True)
    bcdt = conjugate(ctx, bcdt, ctx.ax2)
    bc = bcdt[..., :2 * ds]
    dt = shard_slice(bcdt[..., 2 * ds:], flat, n, dim=-1)
    dt_bias = grad_sync(ctx, p["dt_bias"], ctx.tp_axes)
    dt = F.softplus(dt.float() + shard_slice(dt_bias, flat, n, 0))

    conv = grad_sync(ctx, p["conv"], ctx.tp_axes)
    xin_c, ns_x = causal_conv(xin, shard_slice(conv[:, :d_inner], flat, n, 1),
                              None if state is None else state["conv_x"])
    bc_c, ns_bc = causal_conv(bc, conv[:, d_inner:],
                              None if state is None else state["conv_bc"])
    xin_c, bc_c = F.silu(xin_c), F.silu(bc_c)
    heads = (nh_loc, sc.head_dim)
    A_log = shard_slice(grad_sync(ctx, p["A_log"], ctx.tp_axes), flat, n, 0)
    D = shard_slice(grad_sync(ctx, p["D"], ctx.tp_axes), flat, n, 0)
    y, _ = ops.ssd_scan(
        xin_c.unflatten(-1, heads), dt, A_log, bc_c[..., :ds],
        bc_c[..., ds:], D, chunk=sc.chunk, pool=ssd_pool, slot=slot,
        fresh=fresh)

    gn = shard_slice(grad_sync(ctx, p["gn"], ctx.tp_axes), flat, n,
                     0).reshape(heads)
    y = ops.group_rmsnorm(y, gn, gate=z.unflatten(-1, heads))
    y = y.reshape(b, s, nh_loc * sc.head_dim)
    # heads back to the ax1-sharded layout of the row-first out projection
    if ctx.ax2 is not None:
        y = all_gather(ctx, y, ctx.ax2, dim=-1)
    out = atp_linear(ctx, y, p["w_out"], kind="row")
    if state is None:
        return x + out, None
    return x + out, {"conv_x": ns_x, "conv_bc": ns_bc}
