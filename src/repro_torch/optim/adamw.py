"""AdamW with optional ZeRO-1 sharding over the data-parallel axes
(counterpart of ``repro.optim.adamw``).

Runs on each rank after its backward.  The gradients it gets are LOCAL:
each rank's backward gives its own tokens' share of the gradient of the
global mean loss (``lm.train_loss``), complete over the TP axes
(``core.atp``).  Two gradient-reduction modes:

  plain : all-reduce (sum) the grads over dp, then full AdamW on every DP
          rank (ZeRO-0);
  zero1 : reduce-scatter (sum) the flattened, padded grads over dp ->
          shard-local AdamW on this rank's 1/dp of each leaf -> all-gather
          the updated shards.  The fp32 m/v live only for the owned shard.
          With no data-parallel axis zero1 is full-state AdamW.

The JAX package's ``pmean`` of a dp-invariant gradient and its
``psum_scatter / dp`` of one are these sums of dp-partial ones.  The
``compressed`` mode (int8 wire with error feedback) is ROADMAP A5b.

m and v are fp32 whatever the parameters' dtype, and the update is the
JAX package's: ``p - lr (u + wd p)`` in fp32, cast back.  Parameters are
updated in place (the JAX step returns new arrays; in place keeps one copy
of a full-size model's weights on the card).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.atp import ATPContext

_A5B = "is not ported yet (ROADMAP A5b)"


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    mode: str = "zero1"          # plain | zero1 (compressed: ROADMAP A5b)
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
    if mode == "compressed":
        raise NotImplementedError(f"AdamW mode 'compressed' {_A5B}")
    if mode not in ("plain", "zero1"):
        raise ValueError(f"unknown AdamW mode {mode!r}")


def _dp_group(ctx: ATPContext):
    if len(ctx.dp_axes) > 1:
        raise NotImplementedError(f"more than one data-parallel axis {_A5B}")
    return ctx.group(ctx.dp_axes[0])


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
    zero1 with dp > 1, this rank's ``ceil(numel / dp)`` flat shard of it."""
    _check_mode(mode)
    banked = zero1_banked(mode, ctx)

    def state(p):
        shape = (math.ceil(p.numel() / ctx.dp),) if banked else p.shape
        return {"m": torch.zeros(shape, dtype=torch.float32, device=p.device),
                "v": torch.zeros(shape, dtype=torch.float32, device=p.device)}

    states = iter(map(state, tree_leaves(params)))
    return {"step": 0, "leaves": tree_unflatten(params, states)}


def global_grad_norm(grads, ctx: ATPContext, rep=None) -> torch.Tensor:
    """L2 norm of the GLOBAL gradient from this rank's (dp-reduced) grads:
    a leaf that ``rep`` TP ranks hold alike counts once, and the sum is
    all-reduced over the TP axes."""
    leaves = tree_leaves(grads)
    reps = tree_leaves(rep) if rep is not None else [1] * len(leaves)
    sq = sum(g.float().square().sum() / r for g, r in zip(leaves, reps))
    return _tp_sum(ctx, sq).sqrt()


def _tp_sum(ctx: ATPContext, x: torch.Tensor) -> torch.Tensor:
    if ctx.tp_axes:
        import torch.distributed as dist

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
                replication_factor=None):
    """One optimizer step on this rank's params (updated in place) from its
    LOCAL grads.  Returns (params, new opt_state, metrics{lr, grad_norm})."""
    _check_mode(cfg.mode)
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

            group, summed = _dp_group(ctx), []
            for g in tree_leaves(grads):
                g = g.clone()
                dist.all_reduce(g, group=group)
                summed.append(g)
            grads = tree_unflatten(grads, iter(summed))
        gnorm = global_grad_norm(grads, ctx, replication_factor)
        scale = _clip_scale(cfg, gnorm)
        for p, g, st in zip(tree_leaves(params), tree_leaves(grads),
                            _leaves_state(opt_state["leaves"])):
            p.copy_(_adam(cfg, p.float(), g.float() * scale, st, lr, bc1,
                          bc2))
    new_state = {"step": step + 1, "leaves": opt_state["leaves"]}
    return params, new_state, {"lr": lr, "grad_norm": gnorm}


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

    group, dp, me = _dp_group(ctx), ctx.dp, ctx.dp_index()
    gloo = dist.get_backend(group) == "gloo"
    shards = []
    for g in tree_leaves(grads):
        k = math.ceil(g.numel() / dp)
        flat = torch.zeros(dp * k, dtype=torch.float32, device=g.device)
        flat[:g.numel()] = g.reshape(-1)
        if gloo:   # gloo has no reduce-scatter: sum all, keep this shard
            dist.all_reduce(flat, group=group)
            shards.append(flat[me * k:(me + 1) * k])
        else:
            out = torch.empty(k, dtype=torch.float32, device=g.device)
            dist.reduce_scatter_tensor(out, flat, group=group)
            shards.append(out)
    reps = tree_leaves(rep) if rep is not None else [1] * len(shards)
    sq = sum(s.square().sum() / r for s, r in zip(shards, reps))
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
        dist.all_gather(parts, new.contiguous(), group=group)
        p.copy_(torch.cat(parts)[:p.numel()].reshape(p.shape).to(p.dtype))
    return gnorm
