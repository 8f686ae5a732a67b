"""Int8 gradient compression for the data-parallel reduction, with error
feedback (counterpart of ``repro.optim.grad_compress``).

Per-tensor symmetric quantization in fp32, in the JAX package's order:
``scale = max(amax / 127, 1e-12)``, ``q = clip(round(g / scale), -127,
127)``, the gradient ``q * scale``.  With error feedback the residual
``g + err - q * scale`` is carried to the next step, itself quantized the
same way.

The functions take a gradient that is ALREADY summed over the
data-parallel ranks (``optim.adamw`` sums the ranks' partial gradients in
fp32 first, as its ``plain`` mode does), so every dp rank holds the same
values.  That is what the JAX package quantizes too: inside its
``shard_map``, ``jax.grad`` of a loss that is ``psum``'d over ``data``
gives every dp rank the same, already-summed gradient.  A probe with jax
0.9.0 on a host mesh of 2 dp ranks, a replicated ``w`` and the loss
``psum((x @ w).sum(), "data") / 4``: both ranks got ``[4.5 5.5 6.5]``,
the full gradient.  So the reference's ``pmax`` of the scale and its two
int32 ``psum``s (of ``q`` and of the residual's ``q``), each divided by the
dp degree, act on identical values and give ``q * scale`` back (bit for
bit where the dp degree is a power of two); its gradient's real reduction
is the fp32 ``psum`` that AD put in.  The port skips those three
collectives: ``axes`` only says whether there is a dp reduction at all,
and with none (an empty ``axes``) the gradient and ``err`` pass unchanged,
as in the reference.  Quantizing each rank's partial gradient before the
sum would shrink the wire, but it gives other numbers than the reference.
"""
from __future__ import annotations

import torch


def _quantize(gf: torch.Tensor, bits: int):
    """(q, scale) of fp32 ``gf``: the levels as fp32 integers and the
    tensor's scale (a 0-d tensor)."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp(gf.abs().max() / qmax, min=1e-12)
    return torch.clamp(torch.round(gf / scale), -qmax, qmax), scale


def compressed_psum_mean(g: torch.Tensor, axes, bits: int = 8):
    """The quantized dp mean of a dp-invariant gradient (no error
    feedback): ``q * scale`` in ``g.dtype``."""
    if not axes:
        return g
    q, scale = _quantize(g.float(), bits)
    return (q * scale).to(g.dtype)


def compressed_psum_mean_ef(g: torch.Tensor, err: torch.Tensor, axes,
                            bits: int = 8):
    """The error-feedback variant: returns ``(gradient, new_err)``, the
    gradient ``q * scale`` of ``g + err`` (in ``g.dtype``) and the new
    residual, quantized (fp32, ``err``'s shape)."""
    if not axes:
        return g, err
    gf = g.float() + err
    q, scale = _quantize(gf, bits)
    new_err = compressed_psum_mean(gf - q * scale, axes, bits=bits)
    return (q * scale).to(g.dtype), new_err
