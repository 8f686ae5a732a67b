"""Plain PyTorch versions of the kernels: the four forward kernels (the
matmul also with its pre-activation output, the attention also in the
training kernel's order, ``attention_train_ref``; and in its int8
``scale`` mode, ``matmul_int8_ref``), the backward kernels of
matmul, flash attention, rmsnorm (the block norm and the Mamba2 grouped,
gated norm) and the SSD scan, the matmul epilogue's activation
derivative, and the four pieces of the split rmsnorm (d2 > 1).

Each function computes what its hand-written kernel computes, in the
kernel's own argument layout.  The CPU takes them for every tensor that
lies on the CPU (``kernels.ops`` dispatches on the device), and
``chip_smoke.py`` holds each kernel against its plain version on the card.
The backward versions are written out (not autograd of the forward), so
that the card can compare kernel and plain output by output; the tests
hold them against ``torch.autograd`` of the plain forward.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def epilogue(out: torch.Tensor, bias=None, activation: str | None = None):
    """The matmul kernel's fused epilogue on an fp32 tile, in the order of
    the TPU kernel's ``_epilogue``: bias (broadcast over rows), then the
    activation (tanh-approximated gelu or silu)."""
    if bias is not None:
        out = out + bias.float()
    if activation == "gelu":
        out = F.gelu(out, approximate="tanh")
    elif activation == "silu":
        out = F.silu(out)
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return out


#: sqrt(2 / pi) of the tanh-approximated gelu
_GELU_C = math.sqrt(2.0 / math.pi)


def epilogue_bwd(z, dy, activation: str | None):
    """The gradient through the epilogue's activation: ``dy * act'(z)`` at
    the pre-activation ``z`` (after the bias), in fp32, cast to
    ``dy.dtype``: the plain version of ``csrc/act_bwd.cu``."""
    if activation is None:
        return dy
    zf, gf = z.float(), dy.float()
    if activation == "silu":
        sg = torch.sigmoid(zf)
        d = sg * (1.0 + zf * (1.0 - sg))
    elif activation == "gelu":
        th = torch.tanh(_GELU_C * (zf + 0.044715 * zf ** 3))
        d = 0.5 * (1.0 + th) + 0.5 * zf * (1.0 - th * th) * _GELU_C * (
            1.0 + 3 * 0.044715 * zf * zf)
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return (gf * d).to(dy.dtype)


def matmul_ref(a, b, bias=None, activation: str | None = None):
    """[M, K] @ [K, N] with an fp32 accumulator, the fused epilogue, and
    the result cast back to ``a.dtype``."""
    out = a.float() @ b.float()
    return epilogue(out, bias, activation).to(a.dtype)


def matmul_aux_ref(a, b, bias=None, activation: str | None = None):
    """``matmul_ref`` and its pre-activation, the matmul kernel's two
    outputs under autograd: ``(act(a @ b + bias), a @ b + bias)``, both
    from one fp32 product and each cast to ``a.dtype`` (so ``z`` is what
    ``matmul_ref`` gives with no activation, and the activation reads the
    unrounded sum)."""
    out = epilogue(a.float() @ b.float(), bias)
    return epilogue(out, None, activation).to(a.dtype), out.to(a.dtype)


def matmul_bwd_ref(a, b, dz):
    """The two products of a matmul's backward for ``a [M, K] @ b [K, N]``
    and the output gradient ``dz [M, N]``: dgrad ``dz @ b^T`` (cast to
    ``a.dtype``) and wgrad ``a^T @ dz`` (cast to ``b.dtype``), each with an
    fp32 accumulator."""
    da = (dz.float() @ b.float().t()).to(a.dtype)
    db = (a.float().t() @ dz.float()).to(b.dtype)
    return da, db


def matmul_split_ref(a, b, bias=None, activation: str | None = None, *,
                     k_ranges):
    """``matmul_ref`` as the split-K kernel computes it: one fp32 partial
    product per ``[k0, k1)`` of ``k_ranges`` (``MatmulPlan.k_ranges``),
    summed in split order, then the epilogue once on the full sum."""
    out = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32,
                      device=a.device)
    for k0, k1 in k_ranges:
        out = out + a[:, k0:k1].float() @ b[k0:k1].float()
    return epilogue(out, bias, activation).to(a.dtype)


def matmul_int8_ref(a, b, bias=None, *, scale, activation: str | None = None,
                    out_dtype=torch.bfloat16):
    """The matmul's int8 ``scale`` mode: int8 ``a [M, K] @ b [K, N]``
    summed exactly (in float64, exact while ``K * 127^2 < 2^53``: the
    kernel's int32 is exact too), then the epilogue in f32 in the TPU
    kernel's order: the dequant ``scale`` (an f32 scalar) first, then the
    bias, then the activation; cast to ``out_dtype``."""
    acc = (a.double() @ b.double()).float()
    out = acc * torch.as_tensor(scale, dtype=torch.float32,
                                device=acc.device)
    return epilogue(out, bias, activation).to(out_dtype)


def attention_mask(sq: int, skv: int, q_offset, kv_len, *, causal=True,
                   window: int = 0):
    """[b, sq, skv] bool: the mask of ``models.layers.attention_core``.

    ``qpos = q_offset[b] + i``; a key is visible when ``kpos <= qpos``
    (causal), ``kpos > qpos - window`` (window > 0) and
    ``kpos < kv_len[b]``."""
    dev = q_offset.device
    qpos = q_offset.long()[:, None, None] + torch.arange(sq, device=dev)[None, :, None]
    kpos = torch.arange(skv, device=dev)[None, None, :]
    mask = kpos < kv_len.long()[:, None, None]
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    return mask


def attention_ref(q, k, v, q_offset, kv_len, *, causal=True, window: int = 0,
                  softcap: float = 0.0):
    """q [b, sq, hq, d]; k/v [b, skv, hkv, d]; q_offset/kv_len [b] int.

    ``attention_core``'s math: fp32 scores scaled by 1/sqrt(d), optional
    tanh softcap, masked softmax, probabilities cast to ``q.dtype`` before
    the PV product.  GQA repeats each kv head over its ``hq // hkv`` q
    heads.  A row with no visible key returns zeros (the kernel's rule;
    the model never forms one)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    mask = attention_mask(sq, skv, q_offset, kv_len, causal=causal,
                          window=window)[:, None]
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1) * mask.any(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def _scores(q, k, q_offset, kv_len, causal, window, softcap):
    """fp32 scaled (and softcapped) scores ``[b, hq, sq, skv]``, with GQA's
    k repeated, and the visibility mask ``[b, 1, sq, skv]``."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hq // hkv > 1:
        k = k.repeat_interleave(hq // hkv, dim=2)
    raw = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    x = softcap * torch.tanh(raw / softcap) if softcap else raw
    mask = attention_mask(sq, skv, q_offset, kv_len, causal=causal,
                          window=window)[:, None]
    return x, mask


def attention_lse_ref(q, k, v, q_offset, kv_len, *, causal=True,
                      window: int = 0, softcap: float = 0.0):
    """``attention_ref`` and each row's log-sum-exp of its visible scaled
    (softcapped) scores, fp32 ``[b, hq, sq]`` (-inf for a row with no
    visible key): what the forward kernel writes for the backward."""
    x, mask = _scores(q, k, q_offset, kv_len, causal, window, softcap)
    lse = torch.logsumexp(x.masked_fill(~mask, -torch.inf), dim=-1)
    out = attention_ref(q, k, v, q_offset, kv_len, causal=causal,
                        window=window, softcap=softcap)
    return out, lse


#: the training attention kernel's row tile, and its key tile at head dims
#: up to 128
TRAIN_TILE = 128


def train_keys(d: int) -> int:
    """The training kernel's key tile at head dim ``d``: ``TRAIN_TILE``,
    or 64 at head dim 256 (its instance there, whose 64 x 256 fp32 O
    leaves room for no larger S)."""
    return 64 if d > 128 else TRAIN_TILE


def train_key_tiles(row_tile: int, q_offset: int, kv_len: int, sq: int,
                    skv: int, causal: bool, window: int,
                    keys: int = TRAIN_TILE) -> range:
    """The key tiles (of ``keys``) that the training attention kernel's
    row tile ``row_tile`` (of ``TRAIN_TILE``) walks for a batch row's
    ``q_offset`` and ``kv_len``, as the kernel computes them: every tile
    that holds a key some row of the tile sees (the kernel walks them last
    first)."""
    klen = max(0, min(kv_len, skv))
    p0 = TRAIN_TILE * row_tile
    k_end, k_begin = klen, 0
    if causal:
        k_end = min(k_end, min(p0 + TRAIN_TILE, sq) + q_offset)
    if window > 0:
        k_begin = max(0, p0 + q_offset - window + 1)
    kt0 = k_begin // keys
    nt = -(-(k_end - kt0 * keys) // keys) if k_end > k_begin else 0
    return range(kt0, kt0 + nt)


def attention_train_ref(q, k, v, q_offset, kv_len, *, causal=True,
                        window: int = 0, softcap: float = 0.0):
    """``attention_lse_ref`` as the training kernel (``flash_attention_train
    .cu``) computes it: per batch row and row tile of 128 positions (all q
    heads at once, each reading its kv head), the key tiles (of
    ``train_keys(d)``: 128, or 64 at head dim 256) that the tile's rows can
    see, last first; the scores masked only on tiles that cross the
    diagonal, kv_len or the window's edge; an online
    softmax in the log2 domain (``p = 2^(s c - m c)`` with ``c = log2(e) /
    sqrt(d)`` and m the raw scores' running max, or the capped scores and
    ``c = log2(e)`` with a softcap), the sum and O rescaled by the max's
    change; P cast to ``q.dtype`` for the PV product (rounded for bf16
    inputs, exact for fp32 ones).  Returns (out in ``q.dtype``, fp32
    log-sum-exp ``[b, hq, sq]``, -inf and zeros for a row that sees no
    key)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    tile, keys_n = TRAIN_TILE, train_keys(d)
    scale = 1.0 / math.sqrt(d)
    c = math.log2(math.e) * (1.0 if softcap else scale)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)  # [b, h, s, d]
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    out = torch.zeros(b, hq, sq, d, device=q.device)
    lse = torch.full((b, hq, sq), -torch.inf, device=q.device)
    for bi in range(b):
        qoff, klen = int(q_offset[bi]), max(0, min(int(kv_len[bi]), skv))
        for t in range(-(-sq // tile)):
            p0 = tile * t
            rows = slice(p0, min(p0 + tile, sq))
            qt = q[bi, rows].float().transpose(0, 1)           # [h, r, d]
            qpos = qoff + torch.arange(p0, rows.stop, device=q.device)
            m = torch.full(qt.shape[:2], -torch.inf, device=q.device)
            l = torch.zeros_like(m)
            o = torch.zeros_like(qt)
            for kt in reversed(train_key_tiles(t, qoff, klen, sq, skv,
                                               causal, window, keys_n)):
                k0 = keys_n * kt
                keys = slice(k0, min(k0 + keys_n, skv))
                s = qt @ kf[bi, :, keys].transpose(1, 2)       # [h, r, keys]
                if softcap:
                    s = softcap * torch.tanh(s * (scale / softcap))
                whole = (k0 + keys_n <= klen
                         and (not causal or k0 + keys_n - 1 <= p0 + qoff)
                         and (window <= 0
                              or p0 + tile - 1 + qoff - k0 < window))
                if not whole:
                    kpos = torch.arange(k0, keys.stop, device=q.device)
                    vis = kpos[None, :] < klen
                    if causal:
                        vis = vis & (kpos[None, :] <= qpos[:, None])
                    if window > 0:
                        vis = vis & (kpos[None, :] > qpos[:, None] - window)
                    s = s.masked_fill(~vis, -torch.inf)
                mx = torch.maximum(m, s.amax(-1))
                mc = torch.where(mx == -torch.inf, torch.zeros_like(mx),
                                 mx * c)
                alpha = torch.exp2(m * c - mc)
                p = torch.exp2(s * c - mc[..., None])
                l = l * alpha + p.sum(-1)
                pv = p.to(q.dtype).float() @ vf[bi, :, keys]
                o = o * alpha[..., None] + pv
                m = mx
            seen = l > 0
            out[bi, :, rows] = o / torch.where(seen, l, torch.ones_like(l))[
                ..., None]
            lse[bi, :, rows] = torch.where(
                seen, (m * c + torch.log2(l)) * math.log(2.0),
                torch.full_like(l, -torch.inf))
    return out.transpose(1, 2).to(q.dtype), lse


def attention_bwd_ref(q, k, v, o, do, lse, q_offset, kv_len, *, causal=True,
                      window: int = 0, softcap: float = 0.0):
    """The flash-attention backward (FA2, probabilities recomputed from the
    forward's ``lse``), in fp32: with x the scaled, softcapped scores,
    ``P = exp(x - lse)`` on the visible keys, ``D = rowsum(dO o O)``,
    ``dV = P^T dO``, ``dP = dO V^T``, ``dX = P o (dP - D)``, ``dS = dX o
    (1 - tanh^2)`` (softcap), ``dQ = dS K / sqrt(d)``, ``dK = dS^T Q /
    sqrt(d)``; dK and dV summed over each kv head's group of q heads.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    x, mask = _scores(q, k, q_offset, kv_len, causal, window, softcap)
    p = torch.where(mask, torch.exp(x - lse[..., None]),
                    torch.zeros((), device=q.device))
    dof = do.float()
    kf, vf = k.float(), v.float()
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=2)
        vf = vf.repeat_interleave(rep, dim=2)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)          # [b, hq, sq]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    if softcap:
        ds = ds * (1.0 - (x / softcap) ** 2)
    scale = 1.0 / math.sqrt(d)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    if rep > 1:
        dk = dk.reshape(b, skv, hkv, rep, d).sum(3)
        dv = dv.reshape(b, skv, hkv, rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_split_ref(q, k, v, o, do, lse, q_offset, kv_len, *, parts,
                            causal=True, window: int = 0,
                            softcap: float = 0.0):
    """``attention_bwd_ref`` with dK and dV summed as the CUDA backward's
    split schedule sums them.  ``parts`` maps (bh, first key, end key) of
    each key tile -- bh = batch row * hkv + kv head -- to the row tiles of
    each of its items, in item order (``ops.AttentionBwdPlan.walk``); row
    tile t is q positions ``[64 (t // grp), +64)`` of the group's q head
    ``t % grp``.  Each item's partial sums its row tiles in order; a key tile's
    dK/dV is its partials summed in item order (zeros where no item
    covers it).  dQ as ``attention_bwd_ref``.  fp32."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    grp = hq // hkv
    x, mask = _scores(q, k, q_offset, kv_len, causal, window, softcap)
    p = torch.where(mask, torch.exp(x - lse[..., None]),
                    torch.zeros((), device=q.device))        # [b, hq, sq, skv]
    dof, qf = do.float(), q.float()
    vf = v.float().repeat_interleave(grp, dim=2)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)          # [b, hq, sq]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    if softcap:
        ds = ds * (1.0 - (x / softcap) ** 2)
    scale = 1.0 / math.sqrt(d)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds,
                      k.float().repeat_interleave(grp, dim=2)) * scale
    dk = torch.zeros(b, skv, hkv, d, device=q.device)
    dv = torch.zeros_like(dk)
    for (bh, k0, k1), items in parts.items():
        bi, kvh = divmod(bh, hkv)
        keys = slice(k0, k1)
        sum_k = sum_v = None
        for tiles in items:
            part_k = torch.zeros(keys.stop - keys.start, d, device=q.device)
            part_v = torch.zeros_like(part_k)
            for t in tiles:
                h = kvh * grp + t % grp
                rows = slice(64 * (t // grp), min(64 * (t // grp) + 64, sq))
                part_v = part_v + p[bi, h, rows, keys].T @ dof[bi, rows, h]
                part_k = part_k + ds[bi, h, rows, keys].T @ qf[bi, rows, h]
            sum_k = part_k if sum_k is None else sum_k + part_k
            sum_v = part_v if sum_v is None else sum_v + part_v
        dk[bi, keys, kvh] = sum_k * scale
        dv[bi, keys, kvh] = sum_v
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_split_ref(q, k, v, q_offset, kv_len, *, key_ranges,
                        causal=True, window: int = 0, softcap: float = 0.0):
    """``attention_ref`` as the split-KV kernel computes it: for each key
    range ``[k0, k1)`` of ``key_ranges`` (``AttentionPlan.key_ranges``) a
    partial output normalised over that range's visible keys and its
    log-sum-exp (-inf where the range shows a row no key); then per row
    ``O = sum_s exp(lse_s - L) O_s / sum_s exp(lse_s - L)`` with
    ``L = max_s lse_s``, merged in split order, and zeros where every
    split saw no key."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    mask = attention_mask(sq, skv, q_offset, kv_len, causal=causal,
                          window=window)[:, None]
    parts, lses = [], []
    for k0, k1 in key_ranges:
        s, m = scores[..., k0:k1], mask[..., k0:k1]
        seen = m.any(-1, keepdim=True)
        s = s.masked_fill(~m, -torch.inf)
        mx = torch.where(seen, s.amax(-1, keepdim=True),
                         torch.zeros_like(s[..., :1]))
        p = torch.exp(s - mx)                       # 0 where masked
        l = p.sum(-1, keepdim=True)
        probs = p / torch.where(seen, l, torch.ones_like(l))
        parts.append(torch.einsum("bhqk,bkhd->bhqd", probs.to(q.dtype).float(),
                                  v[:, k0:k1].float()))
        lses.append(torch.where(seen, mx + torch.log(l),
                                torch.full_like(l, -torch.inf)))
    lse = torch.stack(lses)                         # [splits, b, h, q, 1]
    L = lse.amax(0)
    w = torch.where(lse == -torch.inf, torch.zeros_like(lse),
                    torch.exp(lse - torch.where(L == -torch.inf,
                                                torch.zeros_like(L), L)))
    den = w.sum(0)
    out = torch.zeros_like(parts[0])
    for wz, part in zip(w, parts):
        out = out + wz * part
    out = out / torch.where(den > 0, den, torch.ones_like(den))
    return out.transpose(1, 2).to(q.dtype)


#: the serving kernel's decode instance at head dim 256
#: (``flash_attention.cu``'s ``flash_decode_kernel``): a tile of at most
#: ``DECODE_ROWS`` rows (q row x q head of a GQA group, one m16 fragment),
#: each 64-key tile walked by four warps, a quarter of ``DECODE_QUARTER``
#: keys each
DECODE_ROWS = 16
DECODE_QUARTER = 16


def attention_decode_ref(q, k, v, q_offset, kv_len, *, key_ranges,
                         causal=True, window: int = 0, softcap: float = 0.0,
                         keys: int = 64):
    """``attention_ref`` as the decode instance computes it: in each split
    (a key range of ``key_ranges``) the key tiles of ``keys`` from the one
    that holds the split's first visible key, each cut into quarters of
    ``DECODE_QUARTER`` keys; quarter w of every tile runs its own online
    softmax in the log2 domain (``p = 2^(x c - m c)`` over the scores x,
    raw with c = log2(e) / sqrt(d) or capped with c = log2(e), m their
    running max), P cast to ``q.dtype`` for the PV product; at the split's
    end the quarters merge (``M = max m_w``, weights ``2^((m_w - M) c)``)
    into the split's normalised partial and its log-sum-exp, and the splits
    merge as in ``attention_split_ref``.  Returns the output in
    ``q.dtype``."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = 1.0 / math.sqrt(d)
    c = math.log2(math.e) * (1.0 if softcap else scale)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)  # b h s d
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    raw = torch.einsum("bqhd,bhkd->bhqk", q.float(), kf)
    x = softcap * torch.tanh(raw * (scale / softcap)) if softcap else raw
    mask = attention_mask(sq, skv, q_offset, kv_len, causal=causal,
                          window=window)[:, None]
    out = torch.zeros(b, hq, sq, d, device=q.device)
    for bi in range(b):
        qoff, klen = int(q_offset[bi]), max(0, min(int(kv_len[bi]), skv))
        k_end = min(klen, qoff + sq) if causal else klen
        k_begin = max(0, qoff - window + 1) if window > 0 else 0
        parts, lses = [], []
        for s0, s1 in key_ranges:
            hi = min(k_end, s1)
            lo = max(k_begin, s0) // keys * keys
            stats = []
            for w in range(keys // DECODE_QUARTER):
                m = torch.full((hq, sq), -torch.inf, device=q.device)
                l = torch.zeros_like(m)
                o = torch.zeros(hq, sq, d, device=q.device)
                for t0 in range(lo, hi, keys):
                    k0 = t0 + w * DECODE_QUARTER
                    blk = slice(k0, min(k0 + DECODE_QUARTER, skv))
                    if k0 >= skv:
                        continue
                    vis = mask[bi, :, :, blk] & (
                        torch.arange(blk.start, blk.stop,
                                     device=q.device) < hi)
                    sb = x[bi, :, :, blk].masked_fill(~vis, -torch.inf)
                    mx = torch.maximum(m, sb.amax(-1))
                    mc = torch.where(mx == -torch.inf, torch.zeros_like(mx),
                                     mx * c)
                    alpha = torch.exp2(m * c - mc)
                    pb = torch.exp2(sb * c - mc[..., None])
                    l = l * alpha + pb.sum(-1)
                    o = o * alpha[..., None] + pb.to(q.dtype).float() @ \
                        vf[bi, :, blk]
                    m = mx
                stats.append((m, l, o))
            M = torch.stack([st[0] for st in stats]).amax(0)
            L = torch.zeros_like(M)
            O = torch.zeros(hq, sq, d, device=q.device)
            for m, l, o in stats:
                f = torch.where(m == -torch.inf, torch.zeros_like(m),
                                torch.exp2((m - M) * c))
                L = L + f * l
                O = O + f[..., None] * o
            seen = L > 0
            parts.append(O / torch.where(seen, L, torch.ones_like(L))[
                ..., None])
            lses.append(torch.where(seen, (M * c + torch.log2(L))
                                    * math.log(2.0),
                                    torch.full_like(L, -torch.inf)))
        lse = torch.stack(lses)                     # [splits, h, q]
        top = lse.amax(0)
        wz = torch.where(lse == -torch.inf, torch.zeros_like(lse),
                         torch.exp(lse - torch.where(top == -torch.inf,
                                                     torch.zeros_like(top),
                                                     top)))
        den = wz.sum(0)
        acc = torch.zeros(hq, sq, d, device=q.device)
        for z, part in zip(wz, parts):
            acc = acc + z[..., None] * part
        out[bi] = acc / torch.where(den > 0, den, torch.ones_like(den))[
            ..., None]
    return out.transpose(1, 2).to(q.dtype)


def rmsnorm_ref(x, gamma, eps: float = 1e-6):
    """Per row in fp32: ``x * rsqrt(mean(x^2) + eps) * gamma``, cast back
    to ``x.dtype``.  ``gamma`` arrives resolved (gemma's ``1 + gamma`` is
    the caller's job)."""
    xf = x.float()
    inv = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * inv * gamma.float()).to(x.dtype)


def rmsnorm_bwd_ref(x, gamma, dy, eps: float = 1e-6):
    """The rmsnorm backward per row in fp32: with ``r = rsqrt(mean(x^2) +
    eps)`` and ``xh = x r``, ``dx = r (gamma dy - xh mean(xh gamma dy))``
    (cast to ``x.dtype``) and ``dgamma = sum over rows of dy xh`` (fp32,
    gamma's shape)."""
    xf, gf = x.float(), dy.float()
    r = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    xh = xf * r
    gdy = gf * gamma.float()
    dx = r * (gdy - xh * (xh * gdy).mean(-1, keepdim=True))
    dgamma = (gf * xh).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dgamma.to(gamma.dtype)


# The split norm (d2 > 1): each rank holds a slice ``x [..., w]`` of rows
# ``width`` wide; the row sums of its two reductions are all-reduced over
# the slices between a partial and an apply piece, forward and backward.


def rmsnorm_ss_ref(x):
    """The forward partial: per row of the slice, the fp32 sum of squares
    ``[...]``."""
    xf = x.float()
    return (xf * xf).sum(-1)


def rmsnorm_apply_ref(x, gamma, ss, width: int, eps: float = 1e-6):
    """The forward apply, from the row sums ``ss`` of the whole rows:
    ``rstd = rsqrt(ss / width + eps)`` (fp32 ``[...]``) and ``y = x rstd
    gamma`` cast to ``x.dtype``.  Returns ``(y, rstd)``."""
    rstd = torch.rsqrt(ss / width + eps)
    return (x.float() * rstd[..., None] * gamma.float()).to(x.dtype), rstd


def rmsnorm_bwd_partial_ref(x, gamma, dy, rstd):
    """The backward partial, from the forward's ``rstd``: per row the fp32
    ``dot = sum_j dy_j gamma_j x_j`` over the slice, and the slice's
    ``dgamma = sum over rows of dy x rstd`` (fp32, gamma's dtype).
    Returns ``(dot, dgamma)``."""
    xf, gf = x.float(), dy.float()
    dot = (gf * gamma.float() * xf).sum(-1)
    dgamma = (gf * xf * rstd[..., None]).reshape(-1, x.shape[-1]).sum(0)
    return dot, dgamma.to(gamma.dtype)


def rmsnorm_bwd_apply_ref(x, gamma, dy, rstd, dot, width: int):
    """The backward apply, from the row sums ``dot`` of the whole rows:
    ``dx = rstd (gamma dy - x rstd^2 dot / width)`` in fp32, cast to
    ``x.dtype``."""
    r = rstd[..., None]
    dx = r * (gamma.float() * dy.float()
              - x.float() * (r * r) * dot[..., None] / width)
    return dx.to(x.dtype)


def group_rmsnorm_ref(y, gamma, eps: float = 1e-6, gate=None):
    """The Mamba2 grouped RMSNorm: ``rmsnorm_ref`` over each row of
    ``y [..., G, w]`` with its group's row of ``gamma [G, w]``; with a
    ``gate`` of y's shape, times ``silu(gate)`` in y's dtype (in bf16 the
    norm and silu(gate) are each rounded once, then their product)."""
    out = rmsnorm_ref(y, gamma, eps)
    return out if gate is None else out * F.silu(gate)


def group_rmsnorm_bwd_ref(y, gamma, dout, eps: float = 1e-6, gate=None):
    """The backward of ``group_rmsnorm_ref`` in fp32, for the output
    gradient ``dout``: with ``n = y r gamma[g]`` per row of ``y [..., G,
    w]`` (``r = rsqrt(mean(y^2) + eps)``) and ``dn = dout silu(gate)``
    (``dout`` without a gate), ``dy = r (gamma dn - yh mean(yh gamma
    dn))`` with ``yh = y r``, ``dgamma = sum over tokens of dn yh`` (fp32
    ``[G, w]``) and ``dgate = dout n silu'(gate)``.  Returns (dy in
    ``y.dtype``, dgamma, dgate in ``gate.dtype`` or None)."""
    yf, g = y.float(), gamma.float()
    r = torch.rsqrt(yf.pow(2).mean(-1, keepdim=True) + eps)
    yh = yf * r
    df = dout.float()
    dgate = None
    if gate is None:
        dn = df
    else:
        zf = gate.float()
        sg = torch.sigmoid(zf)
        dn = df * zf * sg
        dgate = (df * yh * g * sg * (1.0 + zf * (1.0 - sg))).to(gate.dtype)
    gdn = g * dn
    dy = r * (gdn - yh * (yh * gdn).mean(-1, keepdim=True))
    dgamma = (dn * yh).reshape(-1, *gamma.shape).sum(0)
    return dy.to(y.dtype), dgamma, dgate


def _ssd_chunks(s: int, chunk: int) -> list[tuple[int, int]]:
    """(start, length) of each chunk of an ``s``-long run.

    ``mamba2.ssd_chunked``'s rule where it applies: ``nc = max(1, s //
    chunk)`` chunks of ``s // nc`` (so an ``s`` shorter than ``chunk`` is
    one chunk of ``s``).  Where ``s % nc != 0`` (that function refuses
    such an ``s``) it falls back to the kernel's rule: chunks of ``chunk``
    and a ragged last one.  The result depends on the chunking only
    through rounding."""
    nc = max(1, s // chunk)
    if s % nc == 0:
        return [(i * (s // nc), s // nc) for i in range(nc)]
    return [(c0, min(chunk, s - c0)) for c0 in range(0, s, chunk)]


def ssd_ref(x, dt, A_log, B, C, D, chunk: int, state_in=None):
    """Mamba2 SSD scan with an initial and a final state (single group).

    x [b, s, nh, hd]; dt [b, s, nh] (softplus'd); A_log, D [nh]; B, C
    [b, s, ds]; state_in [b, nh, hd, ds] or None (zeros).  Returns
    (y [b, s, nh, hd] in ``x.dtype``, state_out [b, nh, hd, ds] fp32),
    computed in fp32.

    s = 1 is ``mamba2.ssd_step``'s algebra; longer runs are
    ``mamba2.ssd_chunked``'s, one chunk at a time: with ``la`` the
    within-chunk cumsum of ``dt * A`` (``A = -exp(A_log)``),
      y_t   = sum_{u<=t} exp(la_t - la_u) dt_u (C_t . B_u) x_u
              + exp(la_t) C_t . state + D x_t,
      state <- state exp(la_end) + sum_u exp(la_end - la_u) dt_u x_u B_u^T.
    The decay is selected before ``exp`` is trusted: for u > t the
    exponent is positive and may overflow, and ``where`` (not a 0/1
    product) keeps that out of the sum."""
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    A = -torch.exp(A_log.float())
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    Df = D.float()[None, :, None]
    state = (torch.zeros(b, nh, hd, ds, device=x.device) if state_in is None
             else state_in.float())
    if s == 1:
        g = torch.exp(dtf[:, 0] * A)                                # [b, nh]
        upd = torch.einsum("bhd,bs->bhds", xf[:, 0] * dtf[:, 0, :, None],
                           Bf[:, 0])
        state = state * g[:, :, None, None] + upd
        y = torch.einsum("bhds,bs->bhd", state, Cf[:, 0]) + Df * xf[:, 0]
        return y[:, None].to(x.dtype), state
    ys = []
    for c0, cl in _ssd_chunks(s, chunk):
        xc, dtc = xf[:, c0:c0 + cl], dtf[:, c0:c0 + cl]
        Bc, Cc = Bf[:, c0:c0 + cl], Cf[:, c0:c0 + cl]
        la = torch.cumsum(dtc * A, dim=1)                           # [b,t,nh]
        seg = la[:, :, None, :] - la[:, None, :, :]                 # [b,t,u,nh]
        causal = torch.ones(cl, cl, dtype=torch.bool, device=x.device).tril()
        decay = torch.where(causal[None, :, :, None], torch.exp(seg),
                            torch.zeros((), device=x.device))
        cb = torch.einsum("btn,bun->btu", Cc, Bc)
        w = cb[..., None] * decay * dtc[:, None, :, :]
        y = torch.einsum("btuh,buhd->bthd", w, xc)
        y = y + torch.einsum("btn,bhdn->bthd", Cc, state) * torch.exp(la)[..., None]
        ys.append(y)
        dec_end = torch.exp(la[:, -1:, :] - la) * dtc               # [b,u,nh]
        upd = torch.einsum("buhd,bun->bhdn", xc * dec_end[..., None], Bc)
        state = state * torch.exp(la[:, -1, :])[:, :, None, None] + upd
    y = torch.cat(ys, dim=1) + Df[:, None] * xf
    return y.to(x.dtype), state


def ssd_bwd_ref(x, dt, A_log, B, C, D, dy, chunk: int):
    """The backward of ``ssd_ref`` from a zero initial state with the final
    state dropped (the training path), for the output gradient ``dy``.
    Returns (dx, ddt, dA_log, dB, dC, dD), each in its input's dtype,
    computed in fp32 chunk by chunk (``_ssd_chunks``).

    First the state entering each chunk is recomputed forwards.  Then the
    chunks are walked last to first, carrying ``dS``, the gradient of the
    state leaving the chunk (zero after the last).  Per chunk and head,
    with ``la`` the within-chunk cumsum of ``dt A``, ``G_t = exp(la_t)``,
    ``wv_u = exp(la_end - la_u) dt_u``, ``decay_tu = exp(la_t - la_u)``
    (u <= t, else 0), ``cb = C B^T``, ``M = dy x^T`` (over the head dim) and
    ``S`` the entering state:
      dx_u  = sum_t cb_tu decay_tu dt_u dy_t + D dy_u + wv_u dS B_u
      dC_t  = sum_h [sum_u M_tu decay_tu dt_u B_u + G_t dy_t^T S]
      dB_u  = sum_h [sum_t M_tu decay_tu dt_u C_t + wv_u x_u^T dS]
      dS   <- exp(la_end) dS + sum_t G_t dy_t C_t^T
    and through ``la``: ``Q = cb decay M``, ``P = Q dt_u``, ``r_u =
    x_u^T dS B_u``, ``c_t = G_t dy_t^T S C_t``,
      d la_t = sum_u P_tu - sum_u P_ut + c_t - wv_t r_t
               (+ exp(la_end) <dS, S> + sum_u wv_u r_u at the chunk's end),
      ddt_u  = sum_t Q_tu + exp(la_end - la_u) r_u + A sum_{t>=u} d la_t,
      dA     = sum_u dt_u sum_{t>=u} d la_t,  dA_log = A dA,
    and ``dD = sum dy x``."""
    b, s, nh, hd = x.shape
    dev = x.device
    A = -torch.exp(A_log.float())
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    dyf = dy.float()
    chunks = _ssd_chunks(s, chunk)
    entering, state = [], torch.zeros(b, nh, hd, B.shape[-1], device=dev)
    for c0, cl in chunks:
        entering.append(state)
        dtc = dtf[:, c0:c0 + cl]
        la = torch.cumsum(dtc * A, dim=1)
        wv = torch.exp(la[:, -1:] - la) * dtc
        state = state * torch.exp(la[:, -1])[:, :, None, None] + torch.einsum(
            "buhp,bun->bhpn", xf[:, c0:c0 + cl] * wv[..., None],
            Bf[:, c0:c0 + cl])
    dx, ddt = torch.zeros_like(xf), torch.zeros_like(dtf)
    dB, dC = torch.zeros_like(Bf), torch.zeros_like(Cf)
    dA, dD = torch.zeros(nh, device=dev), torch.zeros(nh, device=dev)
    dS = torch.zeros_like(state)
    for (c0, cl), S in reversed(list(zip(chunks, entering))):
        sl = slice(c0, c0 + cl)
        xc, dtc, Bc, Cc, dyc = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl], \
            dyf[:, sl]
        la = torch.cumsum(dtc * A, dim=1)                       # [b,t,h]
        la_end = la[:, -1]                                      # [b,h]
        G = torch.exp(la)
        wv = torch.exp(la_end[:, None] - la) * dtc              # [b,u,h]
        causal = torch.ones(cl, cl, dtype=torch.bool, device=dev).tril()
        decay = torch.where(causal[None, :, :, None],
                            torch.exp(la[:, :, None, :] - la[:, None, :, :]),
                            torch.zeros((), device=dev))        # [b,t,u,h]
        cb = torch.einsum("btn,bun->btu", Cc, Bc)
        M = torch.einsum("bthp,buhp->btuh", dyc, xc)
        Z = M * decay * dtc[:, None]                            # [b,t,u,h]
        Q = cb[..., None] * decay * M
        W = cb[..., None] * decay * dtc[:, None]
        dSB = torch.einsum("bhpn,bun->buhp", dS, Bc)
        dx[:, sl] = (torch.einsum("btuh,bthp->buhp", W, dyc)
                     + D.float()[None, None, :, None] * dyc
                     + wv[..., None] * dSB)
        YS = torch.einsum("bthp,bhpn->bthn", dyc, S)
        XdS = torch.einsum("buhp,bhpn->buhn", xc, dS)
        dC[:, sl] = (torch.einsum("btuh,bun->btn", Z, Bc)
                     + torch.einsum("bth,bthn->btn", G, YS))
        dB[:, sl] = (torch.einsum("btuh,btn->bun", Z, Cc)
                     + torch.einsum("buh,buhn->bun", wv, XdS))
        r = torch.einsum("buhn,bun->buh", XdS, Bc)
        c = G * torch.einsum("bthn,btn->bth", YS, Cc)
        P = Q * dtc[:, None]
        dla = P.sum(2) - P.sum(1) + c - wv * r
        dla[:, -1] += (torch.exp(la_end) * (dS * S).sum((-1, -2))
                       + (wv * r).sum(1))
        da = torch.flip(torch.cumsum(torch.flip(dla, [1]), 1), [1])
        ddt[:, sl] = Q.sum(1) + torch.exp(la_end[:, None] - la) * r + A * da
        dA += (dtc * da).sum((0, 1))
        dD += (dyc * xc).sum((0, 1, 3))
        dS = dS * torch.exp(la_end)[..., None, None] + torch.einsum(
            "bthp,btn->bhpn", dyc * G[..., None], Cc)
    return (dx.to(x.dtype), ddt.to(dt.dtype), (A * dA).to(A_log.dtype),
            dB.to(B.dtype), dC.to(C.dtype), dD.to(D.dtype))


def ssd_pool_ref(x, dt, A_log, B, C, D, chunk: int, pool, slot, fresh):
    """``ssd_ref`` on the rows of a state pool ``[slots, nh, hd, ds]``,
    updated in place: batch row i starts from pool row ``slot[i]``, or from
    zeros where ``fresh[i]``, and its final state is written back; a slot
    id outside ``[0, slots)`` is the sentinel of a masked row, which starts
    from zeros and writes nothing.  Returns (y, pool).  Raises where a live
    slot id appears twice (two rows would write one pool row)."""
    slots = pool.shape[0]
    live_ids = [i for i in slot.tolist() if 0 <= i < slots]
    if len(set(live_ids)) != len(live_ids):
        raise ValueError(f"a live slot id appears twice: {slot.tolist()}")
    sid = slot.long()
    live = (sid >= 0) & (sid < slots)
    read = (live & ~fresh.bool()).view(-1, 1, 1, 1)
    state = torch.where(read, pool.index_select(0, sid.clamp(0, slots - 1)),
                        torch.zeros((), dtype=pool.dtype, device=pool.device))
    y, state = ssd_ref(x, dt, A_log, B, C, D, chunk, state)
    rows = live.nonzero().flatten()
    pool.index_copy_(0, sid.index_select(0, rows),
                     state.index_select(0, rows).to(pool.dtype))
    return y, pool
