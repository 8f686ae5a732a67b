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

LAUNCHES = {"matmul": 0, "flash_attention": 0, "rmsnorm": 0, "ssd_scan": 0}

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
    if d not in (64, 112, 128):
        raise ValueError(f"the CUDA flash attention takes head dim 64, 112 "
                         f"or 128, got {d}")
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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *, chunk: int,
             state_in: torch.Tensor | None = None):
    """Mamba2 SSD scan from ``state_in`` (zeros when None).

    x [b, s, nh, hd]; dt [b, s, nh] (softplus'd); A_log, D [nh]; B, C
    [b, s, ds] (one group); state_in [b, nh, hd, ds].  Returns
    (y [b, s, nh, hd] in ``x.dtype``, state_out [b, nh, hd, ds] fp32).

    On CUDA: bf16 x, B, C (read through their strides, unit stride along
    the last dim); fp32 dt, A_log, D and state_in; hd = ds = 64 and
    ``chunk`` <= 64; any s >= 1."""
    if _on_cpu(x, dt, A_log, B, C, D, state_in):
        return ref.ssd_ref(x, dt, A_log, B, C, D, chunk, state_in)
    from repro_torch.kernels import _build

    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    if (dt.shape != (b, s, nh) or B.shape != (b, s, ds) or C.shape != B.shape
            or A_log.shape != (nh,) or D.shape != (nh,) or s < 1):
        raise ValueError(f"ssd_scan shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} B {tuple(B.shape)} C "
                         f"{tuple(C.shape)} A_log {tuple(A_log.shape)} D "
                         f"{tuple(D.shape)}")
    if hd != 64 or ds != 64 or not 1 <= chunk <= 64:
        raise ValueError(f"the CUDA ssd_scan takes head dim 64, state dim 64 "
                         f"and chunk <= 64, got {hd}, {ds}, {chunk}")
    if {x.dtype, B.dtype, C.dtype} != {torch.bfloat16}:
        raise TypeError("the CUDA ssd_scan takes bf16 x, B and C")
    if {dt.dtype, A_log.dtype, D.dtype} != {torch.float32}:
        raise TypeError("the CUDA ssd_scan takes fp32 dt, A_log and D")
    if state_in is not None:
        if state_in.shape != (b, nh, hd, ds) or state_in.dtype != torch.float32:
            raise ValueError(f"state_in must be fp32 [{b}, {nh}, {hd}, {ds}], "
                             f"got {state_in.dtype} {tuple(state_in.shape)}")
        state_in = state_in.contiguous()
    if x.stride(-1) != 1 or B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError("x, B and C need unit stride along their last dim")
    A_log, D = A_log.contiguous(), D.contiguous()
    y = torch.empty((b, s, nh, hd), dtype=x.dtype, device=x.device)
    state_out = torch.empty((b, nh, hd, ds), dtype=torch.float32,
                            device=x.device)
    err = _build.entry("ssd_scan")(
        _ptr(x), _ptr(dt), _ptr(A_log), _ptr(B), _ptr(C), _ptr(D),
        _ptr(state_in), _ptr(y), _ptr(state_out), b, s, nh, hd, ds, chunk,
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2],
        _stream(x))
    _check(err, "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return y, state_out
