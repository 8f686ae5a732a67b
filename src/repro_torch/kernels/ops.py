"""Kernel dispatch and launch counters.

Each wrapper takes the plain version (``kernels.ref``) for a tensor on the
CPU, launches its hand-written kernel for a tensor on a CUDA device, and
raises for anything the kernel does not take.  There is no fallback from
the kernel to the plain version.

``LAUNCHES`` counts kernel launches per wrapper: it grows by one where a
kernel is launched and nowhere else, so a run can show that its path went
through the kernels (``reset_launches`` before, read after).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

LAUNCHES = {"matmul": 0, "flash_attention": 0, "rmsnorm": 0}

_ACTIVATIONS = {None: 0, "gelu": 1, "silu": 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts if t is not None}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"}:
        raise ValueError(f"tensors must all lie on the CPU or all on one CUDA "
                         f"device, got {sorted(devs)}")
    return False


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def matmul(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
           *, activation: str | None = None) -> torch.Tensor:
    """``a [..., K] @ b [K, N]`` (+ bias [N], then gelu-tanh or silu).

    On CUDA: bf16 operands; ``b`` row-major ``[K, N]`` or the transpose of
    a row-major ``[N, K]`` (a tied embedding used as the head), read
    without a copy."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if _on_cpu(a, b, bias):
        return ref.matmul_ref(a, b, bias, activation)
    from repro_torch.kernels import _build

    lead, K = a.shape[:-1], a.shape[-1]
    if b.dim() != 2 or b.shape[0] != K:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    N = b.shape[1]
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or (
            bias is not None and bias.dtype != torch.bfloat16):
        raise TypeError("the CUDA matmul takes bf16 operands (int8 with a "
                        "dequant scale is ROADMAP A8)")
    if bias is not None and (bias.shape != (N,) or not bias.is_contiguous()):
        raise ValueError(f"bias must be contiguous [{N}]")
    if b.is_contiguous():
        b_trans = 0
    elif b.stride() == (1, K):
        b_trans = 1
    else:
        raise ValueError("b must be row-major [K, N] or the transpose of a "
                         "row-major [N, K]")
    a2 = a.reshape(-1, K).contiguous()
    M = a2.shape[0]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0:
        return out.reshape(*lead, N)
    vec = int(K % 8 == 0 and (b_trans or N % 8 == 0)
              and a2.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    err = _build.entry("matmul")(
        _ptr(a2), _ptr(b), _ptr(bias), _ptr(out), M, N, K, b_trans,
        _ACTIVATIONS[activation], vec, _stream(a))
    _check(err, "matmul")
    LAUNCHES["matmul"] += 1
    return out.reshape(*lead, N)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: torch.Tensor, kv_len: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q [b, sq, hq, d]; k/v [b, skv, hkv, d]; q_offset/kv_len [b] int.

    Query row i of batch row b sits at position ``q_offset[b] + i`` and sees
    keys ``j < kv_len[b]`` with ``j <= qpos`` (causal) and
    ``j > qpos - window`` (window > 0).  Scale 1/sqrt(d), optional tanh
    softcap.  GQA maps q head h to kv head ``h // (hq // hkv)``."""
    if _on_cpu(q, k, v, q_offset, kv_len):
        return ref.attention_ref(q, k, v, q_offset, kv_len, causal=causal,
                                 window=window, softcap=softcap)
    from repro_torch.kernels import _build

    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, skv, hkv, d) or v.shape != k.shape or hq % hkv:
        raise ValueError(f"attention shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if d not in (64, 128):
        raise ValueError(f"the CUDA flash attention takes head dim 64 or 128, "
                         f"got {d}")
    if {q.dtype, k.dtype, v.dtype} != {torch.bfloat16}:
        raise TypeError("the CUDA flash attention takes bf16 q/k/v")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    qo = q_offset.to(torch.int32).contiguous()
    kl = kv_len.to(torch.int32).contiguous()
    if qo.shape != (b,) or kl.shape != (b,):
        raise ValueError("q_offset and kv_len must be [b]")
    out = torch.empty_like(q)
    err = _build.entry("flash_attention")(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(qo), _ptr(kl), b, sq, skv,
        hq, hkv, d, int(causal), int(window), float(softcap), _stream(q))
    _check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6):
    """Per row of ``x [..., h]`` in fp32: ``x * rsqrt(mean(x^2)+eps) * gamma``
    (gamma already resolved), cast back to ``x.dtype``."""
    if _on_cpu(x, gamma):
        return ref.rmsnorm_ref(x, gamma, eps)
    from repro_torch.kernels.rmsnorm import rmsnorm_triton

    h = x.shape[-1]
    if gamma.shape != (h,):
        raise ValueError(f"gamma must be [{h}], got {tuple(gamma.shape)}")
    x2 = x.reshape(-1, h)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    out = rmsnorm_triton(x2, gamma.contiguous(), eps)
    LAUNCHES["rmsnorm"] += 1
    return out.reshape(x.shape)
