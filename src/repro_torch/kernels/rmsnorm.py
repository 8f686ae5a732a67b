"""RMSNorm over rows, a Triton kernel for the H100.

Replaces ``src/repro/kernels/rmsnorm.py::rmsnorm`` (body ``_rmsnorm_kernel``,
``pallas_call`` at line 30): per row in fp32, ``x * rsqrt(mean(x^2) + eps)
* gamma``, cast back to ``x.dtype``.

What bounds it on the H100: bytes.  It reads each row once and writes it
once, with a handful of flops per element.  The kernel is one program per
row that holds the whole row in registers (``BLOCK`` = the next power of
two of the width), so the reduction and the scale share one read of ``x``:
the same single pass the TPU kernel made over a VMEM row block.

``triton`` is imported only on the first launch: this module must import
where there is no Triton (the CPU tests import every module).
"""
from __future__ import annotations

import torch

tl = None  # triton.language, bound on the first launch

_KERNEL = None


def _rmsnorm_kernel(x_ptr, g_ptr, y_ptr, stride_x, stride_y, n_cols, eps,
                    BLOCK: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < n_cols
    x = tl.load(x_ptr + row * stride_x + cols, mask=mask, other=0.0).to(tl.float32)
    inv = 1.0 / tl.sqrt(tl.sum(x * x, axis=0) / n_cols + eps)
    g = tl.load(g_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    y = x * inv * g
    tl.store(y_ptr + row * stride_y + cols, y.to(y_ptr.dtype.element_ty),
             mask=mask)


def _compiled():
    global _KERNEL, tl
    if _KERNEL is None:
        import triton
        import triton.language as tl  # noqa: F811 (binds the module global)

        _KERNEL = triton.jit(_rmsnorm_kernel)
    return _KERNEL


def rmsnorm_triton(x: torch.Tensor, gamma: torch.Tensor, eps: float):
    """x [rows, h] (unit stride along h) on a CUDA device; gamma [h]."""
    import triton

    rows, h = x.shape
    y = torch.empty_like(x)
    block = triton.next_power_of_2(h)
    _compiled()[(rows,)](x, gamma, y, x.stride(0), y.stride(0), h, eps,
                         BLOCK=block, num_warps=max(1, min(16, block // 256)))
    return y
