"""Step builders (counterpart of ``repro.launch.steps``): the paged serving
step and its vocab-parallel greedy pick, and the training step."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.atp import (ATPContext, all_reduce_max, all_reduce_min,
                                  make_context)
from repro_torch.core.mesh import MeshTopo, dp_axis_names, resolve_device
from repro_torch.models import lm
from repro_torch.optim import adamw


@dataclasses.dataclass
class StepInfo:
    ctx: ATPContext
    device: torch.device


def _greedy_pick(ctx: ATPContext, cfg: ModelConfig, logits):
    """Vocab-parallel greedy argmax.  logits [..., V/d1] -> token ids [...].

    Across ax1 the largest value wins and, among equal values, the lowest
    global token id (the JAX step's max / min-index rule)."""
    v_loc = logits.shape[-1]
    lf = logits.float()
    local_max, local_arg = lf.max(dim=-1)
    local_arg = local_arg.to(torch.int32) + ctx.index1() * v_loc
    if ctx.ax1 is None:
        return local_arg
    gmax = all_reduce_max(ctx, local_max.clone(), ctx.ax1)
    cand = torch.where(local_max >= gmax, local_arg,
                       torch.full_like(local_arg, 2 ** 30))
    return all_reduce_min(ctx, cand, ctx.ax1)


def build_paged_step(cfg: ModelConfig, topo: MeshTopo, device=None,
                     slots: int | None = None):
    """The paged cache-write step (decode tick AND prefill chunk).

    Returns ``(step, info)`` with ``step(params, tokens [b, s], start [b],
    table [b, mp], caches) -> (greedy tokens [b, s], caches)``; ``params``
    is this rank's shard (``lm.shard_params``) and ``caches`` come from
    ``lm.init_paged_caches`` and are written in place.  One function serves
    both shapes (prefill chunk b=1, decode tick b=slots); lengths and
    positions are runtime data.  A topology of more than one rank needs
    ``torch.distributed`` initialized with one process per rank.

    Recurrent kinds (mamba/zamba) need ``slots`` (the scheduler's
    ``batch_slots``, which sizes the state pools), and the step takes a
    5th input before the caches: ``slot [b]``, the per-row slot ids, with
    the sentinel ``slots`` for rows whose state must not change.  There is
    no speculative variant: the port's server refuses speculation, and a
    recurrent state could not roll a rejected draft back anyway."""
    needs_slot = lm.is_recurrent(cfg)
    if needs_slot and slots is None:
        raise ValueError("recurrent kinds (mamba/zamba) need "
                         "build_paged_step(..., slots=<scheduler batch_slots>)")
    device = resolve_device(device)
    ctx = make_context(topo, device_type=device.type)

    if needs_slot:
        @torch.no_grad()
        def step(params, tokens, start, table, slot, caches):
            logits, caches = lm.paged_step(ctx, cfg, params, tokens, start,
                                           table, caches, slot=slot)
            return _greedy_pick(ctx, cfg, logits), caches
    else:
        @torch.no_grad()
        def step(params, tokens, start, table, caches):
            logits, caches = lm.paged_step(ctx, cfg, params, tokens, start,
                                           table, caches)
            return _greedy_pick(ctx, cfg, logits), caches

    return step, StepInfo(ctx=ctx, device=device)


def build_train_step(cfg: ModelConfig, topo: MeshTopo,
                     opt_cfg: adamw.AdamWConfig | None = None,
                     chunks: int = 1, remat: bool = True, device=None):
    """One training step: the loss and its gradients through autograd (the
    kernels' backward on CUDA), then AdamW.

    Returns ``(step, info)`` with ``step(params, opt_state, batch) ->
    (params, opt_state, metrics)``: ``params`` is this rank's shard
    (``lm.shard_params``), updated in place; ``opt_state`` from
    ``adamw.init_opt_state(params, info.ctx, opt_cfg.mode)``; ``batch``
    this dp rank's ``tokens`` and ``labels [b, s]`` on the device;
    ``metrics`` the loss and the global grad norm (0-d tensors) and the
    learning rate.  ``remat`` recomputes each block's activations in the
    backward.  A topology of more than one rank needs
    ``torch.distributed`` initialized with one process per rank."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    device = resolve_device(device)
    lm.check_trainable(cfg)
    if len(dp_axis_names(topo)) > 1:
        raise NotImplementedError("more than one data-parallel axis is "
                                  "ROADMAP A5b")
    ctx = make_context(topo, chunks=chunks, device_type=device.type)

    def step(params, opt_state, batch):
        leaves = adamw.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = lm.train_loss(ctx, cfg, params, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        grads = adamw.tree_unflatten(params, iter(grads))
        params, opt_state, metrics = adamw.apply_adamw(
            opt_cfg, ctx, params, grads, opt_state,
            lm.replication_factors(cfg, ctx, params))
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return step, StepInfo(ctx=ctx, device=device)
