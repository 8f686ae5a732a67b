"""Plain PyTorch versions of the three kernels on the serving path.

Each function computes what its hand-written kernel computes, in the
kernel's own argument layout.  The CPU takes them for every tensor that
lies on the CPU (``kernels.ops`` dispatches on the device), and
``chip_smoke.py`` holds each kernel against its plain version on the card.
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


def matmul_ref(a, b, bias=None, activation: str | None = None):
    """[M, K] @ [K, N] with an fp32 accumulator, the fused epilogue, and
    the result cast back to ``a.dtype``."""
    out = a.float() @ b.float()
    return epilogue(out, bias, activation).to(a.dtype)


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


def rmsnorm_ref(x, gamma, eps: float = 1e-6):
    """Per row in fp32: ``x * rsqrt(mean(x^2) + eps) * gamma``, cast back
    to ``x.dtype``.  ``gamma`` arrives resolved (gemma's ``1 + gamma`` is
    the caller's job)."""
    xf = x.float()
    inv = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * inv * gamma.float()).to(x.dtype)
