"""AdamW with optional ZeRO-1 sharding over the data-parallel axes
(counterpart of ``repro.optim.adamw``).

Runs on each rank after its backward.  The gradients it gets are LOCAL:
each rank's backward gives its own tokens' share of the gradient of the
global mean loss (``lm.train_loss``), complete over the TP axes
(``core.atp``).  Three gradient-reduction modes:

  plain      : all-reduce (sum) the grads over dp, then full AdamW on every
               DP rank (ZeRO-0);
  zero1      : reduce-scatter (sum) the flattened, padded grads over dp ->
               shard-local AdamW on this rank's 1/dp of each leaf ->
               all-gather the updated shards.  The fp32 m/v live only for
               the owned shard.  With no data-parallel axis zero1 is
               full-state AdamW;
  compressed : plain's fp32 sum, then each leaf quantized to int8 levels
               with error feedback (``optim.grad_compress``: the residual
               is carried in the state's fp32 ``err``), then full AdamW.

The data-parallel axes are one (data, or pod) or two (pod and data: one
flat group over both, ``ATPContext.group``).  The JAX package's ``pmean``
of a dp-invariant gradient and its ``psum_scatter / dp`` of one are these
sums of dp-partial ones; its ``compressed`` mode quantizes that same
dp-invariant gradient (``optim.grad_compress`` says why the port issues
none of its int8 collectives).

m and v are fp32 whatever the parameters' dtype, and the update is the
JAX package's: ``p - lr (u + wd p)`` in fp32, cast back.  Parameters are
updated in place (the JAX step returns new arrays; in place keeps one copy
of a full-size model's weights on the card).  The collectives issued here
are noted on an installed ``analysis.signature`` record under regions
``opt:grads``, ``opt:zero1`` and ``opt:grad_norm``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.analysis import signature as sig
from repro_torch.core.atp import ATPContext
from repro_torch.optim.grad_compress import compressed_psum_mean_ef

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    mode: str = "zero1"          # plain | zero1 | compressed
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then cosine decay to
    ``min_lr_ratio * lr`` at ``total_steps``."""
    if step < cfg.warmup_steps:
        return cfg.lr * min(1.0, (step + 1) / max(1, cfg.warmup_steps))
    prog = min(1.0, max(0.0, (step - cfg.warmup_steps)
                        / max(1, cfg.total_steps - cfg.warmup_steps)))
    return cfg.lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5
                     * (1 + math.cos(math.pi * prog)))


def _check_mode(mode: str) -> None:
    if mode not in ("plain", "zero1", "compressed"):
        raise ValueError(f"unknown AdamW mode {mode!r}")


def zero1_banked(mode: str, ctx: ATPContext) -> bool:
    """Whether m/v hold only this rank's shard: zero1 with a dp axis."""
    return mode == "zero1" and bool(ctx.dp_axes)


def tree_leaves(tree) -> list:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, it):
    """A nested dict shaped like ``like`` with leaves from ``it``."""
    if isinstance(like, dict):
        return {k: tree_unflatten(v, it) for k, v in like.items()}
    return next(it)


def init_opt_state(params, ctx: ATPContext, mode: str = "zero1") -> dict:
    """fp32 m/v per leaf of this rank's params: the leaf's shape, or, under
    zero1 with dp > 1, this rank's ``ceil(numel / dp)`` flat shard of it.
    ``compressed`` adds ``err``: the error-feedback residual, fp32 in each
    leaf's shape (never banked)."""
    _check_mode(mode)
    banked = zero1_banked(mode, ctx)

    def state(p):
        shape = (math.ceil(p.numel() / ctx.dp),) if banked else p.shape
        return {"m": torch.zeros(shape, dtype=torch.float32, device=p.device),
                "v": torch.zeros(shape, dtype=torch.float32, device=p.device)}

    states = iter(map(state, tree_leaves(params)))
    out = {"step": 0, "leaves": tree_unflatten(params, states)}
    if mode == "compressed":
        out["err"] = tree_unflatten(params, iter(
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in tree_leaves(params)))
    return out


def global_grad_norm(grads, ctx: ATPContext, rep=None) -> torch.Tensor:
    """L2 norm of the GLOBAL gradient from this rank's (dp-reduced) grads:
    a leaf that ``rep`` TP ranks hold alike counts once, and the sum is
    all-reduced over the TP axes."""
    leaves = tree_leaves(grads)
    reps = tree_leaves(rep) if rep is not None else [1] * len(leaves)
    sq = sum(g.float().square().sum() / r for g, r in zip(leaves, reps))
    return _tp_sum(ctx, sq).sqrt()


def _note(op: str, axes, elems: int, dtype, region: str) -> None:
    """Note one optimizer collective on the installed record (callers
    check ``sig.ACTIVE`` first)."""
    sig.ACTIVE.note(op, axes, elems, dtype, region=region)


def _tp_sum(ctx: ATPContext, x: torch.Tensor) -> torch.Tensor:
    if ctx.tp_axes:
        import torch.distributed as dist

        if sig.ACTIVE is not None:
            _note("psum", ctx.tp_axes, x.numel(), x.dtype, "opt:grad_norm")
        dist.all_reduce(x, group=ctx.group(ctx.tp_axes))
    return x


def _adam(cfg: AdamWConfig, p32, g32, st, lr: float, bc1: float, bc2: float):
    """One AdamW update of the fp32 values ``p32`` (in place on ``st``'s
    m and v); returns the new fp32 values, ``p - lr (u + wd p)`` with
    ``u = (m / bc1) / (sqrt(v / bc2) + eps)``, written as ``p (1 - lr wd)
    - (lr / bc1) m / (sqrt(v / bc2) + eps)``: each term one pass over the
    leaf (the update is bound by these passes' bytes)."""
    m = st["m"].lerp_(g32, 1 - cfg.b1)
    v = st["v"].mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
    denom = (v / bc2).sqrt_().add_(cfg.eps)
    return p32.mul(1 - lr * cfg.weight_decay).addcdiv_(m, denom,
                                                       value=-lr / bc1)


@torch.no_grad()
def apply_adamw(cfg: AdamWConfig, ctx: ATPContext, params, grads, opt_state,
                replication_factor=None, pieces=None):
    """One optimizer step on this rank's params (updated in place) from its
    LOCAL grads.  Returns (params, new opt_state, metrics{lr, grad_norm});
    under ``compressed`` the state's ``err`` is updated in place.
    ``pieces`` (``lm.fused_pieces``): per leaf, the widths along its last
    dim of the JAX package's leaves it fuses, or None; ``compressed``
    quantizes each piece with its own scale, as the reference quantizes
    its leaves, and needs them (a fused leaf quantized whole gives other
    numbers than the reference's)."""
    _check_mode(cfg.mode)
    if cfg.mode == "compressed" and pieces is None:
        raise ValueError("the compressed AdamW needs the fused leaves' "
                         "pieces (lm.fused_pieces)")
    step = opt_state["step"]
    lr = lr_at(cfg, step)
    t = step + 1
    bc1, bc2 = 1 - cfg.b1 ** t, 1 - cfg.b2 ** t
    if zero1_banked(cfg.mode, ctx):
        gnorm = _zero1_step(cfg, ctx, params, grads, opt_state, lr, bc1, bc2,
                            replication_factor)
    else:
        if ctx.dp_axes:
            import torch.distributed as dist

            group, summed = ctx.group(ctx.dp_axes), []
            for g in tree_leaves(grads):
                g = g.clone()
                if sig.ACTIVE is not None:
                    _note("psum", ctx.dp_axes, g.numel(), g.dtype,
                          "opt:grads")
                dist.all_reduce(g, group=group)
                summed.append(g)
            grads = tree_unflatten(grads, iter(summed))
        if cfg.mode == "compressed":
            grads = _compress(ctx, grads, opt_state["err"], pieces)
        gnorm = global_grad_norm(grads, ctx, replication_factor)
        scale = _clip_scale(cfg, gnorm)
        for p, g, st in zip(tree_leaves(params), tree_leaves(grads),
                            _leaves_state(opt_state["leaves"])):
            p.copy_(_adam(cfg, p.float(), g.float() * scale, st, lr, bc1,
                          bc2))
    new_state = {**opt_state, "step": step + 1}
    return params, new_state, {"lr": lr, "grad_norm": gnorm}


def _compress(ctx: ATPContext, grads, err, pieces):
    """The dp-summed ``grads`` quantized leaf by leaf, and within a fused
    leaf piece by piece (``grad_compress``); the residuals are written into
    ``err`` in place."""
    out = []
    for g, e, w in zip(tree_leaves(grads), tree_leaves(err),
                       tree_leaves(pieces)):
        parts = []
        for gp, ep in zip(*((g.split(w, -1), e.split(w, -1)) if w
                            else ((g,), (e,)))):
            gp, new_err = compressed_psum_mean_ef(gp, ep, ctx.dp_axes)
            if new_err is not ep:
                ep.copy_(new_err)   # a view of the leaf's err
            parts.append(gp)
        out.append(parts[0] if len(parts) == 1 else torch.cat(parts, -1))
    return tree_unflatten(grads, iter(out))


def _leaves_state(tree) -> list:
    """The {m, v} dicts of an opt_state's leaves tree, in leaf order."""
    if "m" in tree and not isinstance(tree["m"], dict):
        return [tree]
    return [x for v in tree.values() for x in _leaves_state(v)]


def _clip_scale(cfg: AdamWConfig, gnorm: torch.Tensor):
    if not cfg.grad_clip:
        return 1.0
    return torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)


def _zero1_step(cfg, ctx, params, grads, opt_state, lr, bc1, bc2, rep):
    """ZeRO-1: reduce-scatter grads over dp, shard-local Adam, all-gather.
    Returns the global grad norm."""
    import torch.distributed as dist

    group, dp, me = ctx.group(ctx.dp_axes), ctx.dp, ctx.dp_index()
    gloo = dist.get_backend(group) == "gloo"
    shards = []
    for g in tree_leaves(grads):
        k = math.ceil(g.numel() / dp)
        flat = torch.zeros(dp * k, dtype=torch.float32, device=g.device)
        flat[:g.numel()] = g.reshape(-1)
        if sig.ACTIVE is not None:
            _note("psum" if gloo else "reduce_scatter", ctx.dp_axes,
                  flat.numel(), flat.dtype, "opt:zero1")
        if gloo:   # gloo has no reduce-scatter: sum all, keep this shard
            dist.all_reduce(flat, group=group)
            shards.append(flat[me * k:(me + 1) * k])
        else:
            out = torch.empty(k, dtype=torch.float32, device=g.device)
            dist.reduce_scatter_tensor(out, flat, group=group)
            shards.append(out)
    reps = tree_leaves(rep) if rep is not None else [1] * len(shards)
    sq = sum(s.square().sum() / r for s, r in zip(shards, reps))
    if sig.ACTIVE is not None:
        _note("psum", ctx.dp_axes, sq.numel(), sq.dtype, "opt:grad_norm")
    dist.all_reduce(sq, group=group)
    gnorm = _tp_sum(ctx, sq).sqrt()
    scale = _clip_scale(cfg, gnorm)
    for p, gs, st in zip(tree_leaves(params), shards,
                         _leaves_state(opt_state["leaves"])):
        k = gs.numel()
        flat = torch.zeros(dp * k, dtype=torch.float32, device=p.device)
        flat[:p.numel()] = p.reshape(-1)
        new = _adam(cfg, flat[me * k:(me + 1) * k], gs * scale, st, lr, bc1,
                    bc2)
        parts = [torch.empty_like(new) for _ in range(dp)]
        if sig.ACTIVE is not None:
            _note("all_gather", ctx.dp_axes, dp * new.numel(), new.dtype,
                  "opt:zero1")
        dist.all_gather(parts, new.contiguous(), group=group)
        p.copy_(torch.cat(parts)[:p.numel()].reshape(p.shape).to(p.dtype))
    return gnorm
