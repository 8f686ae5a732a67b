"""Step builders (counterpart of ``repro.launch.steps``): the paged serving
step and the wave's decode step over contiguous caches, each captured as
one CUDA graph per input shape (the counterpart of the reference's
``jax.jit``), with their vocab-parallel greedy pick; the cache-free
prefill; the training step.  Each builder takes a ``ParallelPlan`` or a
topology, and both go through :func:`resolve_ctx`."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.analysis.signature import region
from repro_torch.configs.base import ModelConfig
from repro_torch.core.atp import (ATPContext, all_reduce_max, all_reduce_min,
                                  make_context)
from repro_torch.core.mesh import MeshTopo, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models.paging import GARBAGE_PAGE
from repro_torch.optim import adamw


def _decode_knobs(plan):
    """``plan`` as a serving step runs it: the decode sub-plan's
    mesh-layout-neutral knobs (chunks, boundary_mode, wire_dtype) replace
    the train knobs, globally and in every segment entry, and
    ``seq_parallel`` is masked everywhere."""
    if plan.decode is not None:
        dec = plan.decode
        plan = plan.with_(
            chunks=dec.chunks, boundary_mode=dec.boundary_mode,
            wire_dtype=dec.wire_dtype,
            segments=tuple(dataclasses.replace(
                s, chunks=dec.chunks, boundary_mode=dec.boundary_mode,
                wire_dtype=dec.wire_dtype) for s in plan.segments))
    return plan.with_(seq_parallel=False, segments=tuple(
        dataclasses.replace(s, seq_parallel=False) for s in plan.segments))


def resolve_ctx(topo: MeshTopo | None, plan, chunks: int = 1,
                decode: bool = False, *,
                device_type: str = "cuda") -> ATPContext:
    """One context path for every builder (``repro.launch.steps.
    resolve_ctx``): the plan wins when given.

    ``decode`` masks ``seq_parallel``, globally and in every segment entry
    (the sequence-parallel spec is defined over a whole sequence), and
    applies the plan's decode sub-plan for the knobs that do not change the
    mesh layout (its boundary_mode, chunks 1).  The decode factorization
    (d1, d2) is not applied here: a server that wants the decode mesh is
    built from ``plan.decode_view()`` up front (``launch/serve.py``).
    The knobs are resolved before the context is built, so a serving step
    of a plan whose training knobs ask for ``seq_parallel`` builds."""
    if plan is not None:
        if decode:
            plan = _decode_knobs(plan)
        return make_context(topo, plan=plan, device_type=device_type)
    if topo is None:
        raise TypeError("builder needs a MeshTopo or a ParallelPlan")
    return make_context(topo, chunks=chunks, device_type=device_type)


@dataclasses.dataclass
class StepInfo:
    ctx: ATPContext
    device: torch.device
    #: the step uncaptured, on device tensors: the paged step's
    #: ``plain(params, tokens, start, table[, slot], caches) -> (greedy
    #: tokens [b, s], caches)``, the decode step's ``plain(params, tokens,
    #: pos, caches) -> (greedy tokens [b], caches)``
    plain: Callable | None = None
    #: the decode step's caches: ``init_caches() -> lm.init_decode_caches``
    #: of its batch and ``s_max`` on its device
    init_caches: Callable | None = None


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
    with region("shell:pick"):
        gmax = all_reduce_max(ctx, local_max.clone(), ctx.ax1)
        cand = torch.where(local_max >= gmax, local_arg,
                           torch.full_like(local_arg, 2 ** 30))
        return all_reduce_min(ctx, cand, ctx.ax1)


def check_slot_ids(slot, slots: int) -> None:
    """Refuse a step whose live slot ids (those below the sentinel
    ``slots``) repeat: two batch rows would write one pool row.  Runs on
    the host, on the ids as the scheduler made them."""
    ids = np.asarray(slot).reshape(-1)
    live = ids[ids < slots]
    if len(np.unique(live)) != len(live):
        raise ValueError(f"a live slot id appears twice: {ids.tolist()}")


@dataclasses.dataclass
class _Shape:
    """One input shape of a :class:`CapturedStep`: its fixed input buffers
    (``static``, on the step's device), the pinned host buffers they are
    filled from (``host``; None on the CPU), the greedy tokens' buffer the
    body writes (``out``) and its host copy, the graph (None on the CPU),
    the kernel launches of one step (``ops.LAUNCHES``' delta over the
    capture, or over the warm-up on the CPU), the seconds of the warm-up
    and of the capture, and the bytes the capture added to the pool."""
    static: list
    host: list | None
    out: torch.Tensor | None = None
    host_out: torch.Tensor | None = None
    graph: torch.cuda.CUDAGraph | None = None
    launches: dict = dataclasses.field(default_factory=dict)
    warmup_s: float = 0.0
    capture_s: float = 0.0
    pool_bytes: int = 0


class CapturedStep:
    """:func:`build_paged_step`'s step: ``step(params, tokens [b, s], start
    [b], table [b, mp][, slot [b]], caches) -> (greedy tokens [b, s] as
    numpy, caches)``, the inputs host arrays (numpy or CPU tensors); and
    :func:`build_decode_step`'s, ``step(params, tokens [b, s], pos,
    caches)``, the same machinery with its own warm-up inputs (``blank``)
    and the cache state a warm-up must give back (``guard``).

    On CUDA the first call at an input shape captures the body as a CUDA
    graph, as ``jax.jit`` compiles at its first call; later calls copy the
    inputs into that shape's fixed buffers (through pinned host memory),
    replay the graph and copy the tokens back: one host sync a step.  Both
    shapes' graphs take their memory from one pool (they never run at
    once).  Before a capture the body runs once on the capture stream (the
    warm-up), on inputs that write nothing live (every page-table entry
    the garbage page, start 0, every slot id the sentinel), which builds
    the kernels, sets their attributes and makes the split kernels'
    arrival counters outside the capture; warm-up and capture leave the
    caches as they were except the garbage page.  A graph is bound to the
    param and cache tensors it captured: handed others (new caches, a
    reshaped server), the step captures again.  A replay adds its graph's
    launch counts to ``ops.LAUNCHES``.  A capture that fails raises: there
    is no fallback to the uncaptured body.

    On the CPU there is no graph: the same buffers are filled and the body
    is called on them (after the same warm-up), so the CPU tests run this
    plumbing.  At d1 * d2 > 1 on CUDA the captured body holds NCCL
    collectives (not yet run on more than one card)."""

    def __init__(self, body: Callable, device: torch.device,
                 slots: int | None, *, blank: Callable | None = None,
                 guard: Callable | None = None):
        self.body = body
        self.device = device
        self.slots = slots
        #: fills the zeroed input buffers of a warm-up (default: the paged
        #: step's, every page the garbage page and every slot the sentinel)
        self.blank = blank if blank is not None else self._paged_blank
        #: ``guard(caches)`` saves what a warm-up writes into the caches
        #: and returns the function that puts it back (default: nothing to
        #: save, the paged warm-up writes only the garbage page)
        self.guard = guard
        self.shapes: dict[tuple, _Shape] = {}
        self.binding = None
        #: shapes captured and warm-up runs of the body, rebinds included
        self.captures = 0
        self.warmups = 0
        self._pool = self._stream = None
        if device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device)

    def __call__(self, params, *args):
        *inputs, caches = args
        inputs = [np.asarray(a) for a in inputs]
        if self.slots is not None:
            check_slot_ids(inputs[3], self.slots)
        binding = [(t.data_ptr(), tuple(t.shape)) for t in
                   adamw.tree_leaves({"params": params, "caches": caches})]
        if binding != self.binding:
            self.shapes.clear()   # graphs of other tensors: capture again
            self.binding = binding
        key = tuple(a.shape for a in inputs)
        shape = self.shapes.get(key)
        if shape is None:
            shape = self.shapes[key] = self._capture(key, params, caches)
        return self._run(shape, inputs, params, caches), caches

    def _paged_blank(self, static) -> None:
        static[2].fill_(GARBAGE_PAGE)
        if self.slots is not None:
            static[3].fill_(self.slots)

    def _capture(self, key, params, caches) -> _Shape:
        dev = self.device
        static = [torch.zeros(k, dtype=torch.int32, device=dev) for k in key]
        self.blank(static)
        restore = self.guard(caches) if self.guard is not None else None
        if dev.type == "cpu":
            before = dict(ops.LAUNCHES)
            self.body(params, *static, caches)
            if restore is not None:
                restore()
            self.warmups += 1
            self.captures += 1
            return _Shape(static, None, launches={
                k: ops.LAUNCHES[k] - v for k, v in before.items()})
        shape = _Shape(static, [torch.empty(k, dtype=torch.int32,
                                            pin_memory=True) for k in key])
        t0 = time.perf_counter()
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self._stream):
            self.body(params, *static, caches)
        self._stream.synchronize()
        if restore is not None:
            restore()
        shape.warmup_s = time.perf_counter() - t0
        self.warmups += 1
        before = dict(ops.LAUNCHES)
        # the capture empties the allocator's cache first: so does the
        # baseline of the pool's new memory
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        stream = torch.cuda.current_stream(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                shape.out = self.body(params, *static, caches)[0]
        finally:
            # the capture launched nothing: its counts go to each replay
            shape.launches = {k: ops.LAUNCHES[k] - v
                              for k, v in before.items()}
            ops.LAUNCHES.update(before)
            # a failed capture leaves the capture stream current
            torch.cuda.set_stream(stream)
        shape.capture_s = time.perf_counter() - t0
        shape.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        shape.graph = graph
        shape.host_out = torch.empty(tuple(shape.out.shape),
                                     dtype=shape.out.dtype, pin_memory=True)
        self.captures += 1
        return shape

    def _run(self, shape: _Shape, inputs, params, caches) -> np.ndarray:
        if shape.graph is None:
            for buf, a in zip(shape.static, inputs):
                buf.copy_(torch.from_numpy(a))
            return self.body(params, *shape.static, caches)[0].numpy()
        for buf, host, a in zip(shape.static, shape.host, inputs):
            np.copyto(host.numpy(), a, casting="same_kind")
            buf.copy_(host, non_blocking=True)
        shape.graph.replay()
        for k, v in shape.launches.items():
            ops.LAUNCHES[k] += v
        shape.host_out.copy_(shape.out, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return shape.host_out.numpy().copy()


def build_paged_step(cfg: ModelConfig, topo: MeshTopo | None = None,
                     device=None, slots: int | None = None, *, plan=None):
    """The paged cache-write step (decode tick AND prefill chunk).

    Returns ``(step, info)``: ``step`` the :class:`CapturedStep` (``step(
    params, tokens [b, s], start [b], table [b, mp], caches) -> (greedy
    tokens [b, s], caches)`` on host arrays), ``info.plain`` the same body
    uncaptured on device tensors; ``params`` is this rank's shard
    (``lm.shard_params``) and ``caches`` come from ``lm.init_paged_caches``
    and are written in place.  One body serves both shapes (prefill chunk
    b=1, decode tick b=slots), a graph each; lengths and positions are
    runtime data.  The context comes from ``plan`` (its decode knobs,
    :func:`resolve_ctx` with ``decode=True``) or ``topo``.  A topology of
    more than one rank needs ``torch.distributed`` initialized with one
    process per rank.

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
    ctx = resolve_ctx(topo, plan, decode=True, device_type=device.type)

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

    return (CapturedStep(step, device, slots if needs_slot else None),
            StepInfo(ctx=ctx, device=device, plain=step))


def build_prefill(cfg: ModelConfig, topo: MeshTopo | None = None,
                  chunks: int = 1, device=None, *, plan=None):
    """The forward-only serving step over a whole sequence, no caches
    (``repro.launch.steps.build_prefill``): ``step(params, batch) ->
    greedy next token [b]`` with ``batch["tokens"] [b, s]`` on the device
    (``lm.prefill_logits``, then the vocab-parallel pick).  The context is
    the training one (``resolve_ctx`` without ``decode``): a plan's
    ``seq_parallel`` applies.  Returns ``(step, info)``; the step is not
    captured."""
    device = resolve_device(device)
    ctx = resolve_ctx(topo, plan, chunks, device_type=device.type)

    @torch.no_grad()
    def step(params, batch):
        return _greedy_pick(ctx, cfg, lm.prefill_logits(ctx, cfg, params,
                                                        batch))

    return step, StepInfo(ctx=ctx, device=device, plain=step)


def _state_guard(caches):
    """What a decode step's warm-up changes in the contiguous caches: every
    leaf but the k/v rows (``len`` and the recurrent state), saved; returns
    the function that puts it back.  The k/v rows it writes lie at ``len``
    and beyond, which the next real step writes before reading."""
    saved = [(t, t.clone()) for t in _leaves(caches)]

    def restore():
        for t, copy in saved:
            t.copy_(copy)

    return restore


def _leaves(tree, name=None):
    if isinstance(tree, dict):
        return [t for k, v in tree.items() for t in _leaves(v, k)]
    return [] if name in ("k", "v") else [tree]


def build_decode_step(cfg: ModelConfig, topo: MeshTopo | None = None,
                      B: int = 1, s_max: int = 64, device=None, *,
                      plan=None):
    """The wave's step over contiguous decode caches (``repro.launch.steps.
    build_decode_step``): ``step(params, tokens [b, s], pos, caches) ->
    (greedy next tokens [b] as numpy, caches)``, tokens this rank's rows
    of the wave (``lm.decode_rows``) and ``pos`` the position of
    ``tokens[:, 0]``, host values; s > 1 is prefill into the caches.

    Returns ``(step, info)``: ``step`` a :class:`CapturedStep`, one CUDA
    graph per (b, s) (a prefill and a decode tick), replayed at every
    position: ``pos`` is copied into the graph's input and each layer's
    ``len`` grows in place, so one graph serves every tick and, after
    ``lm.reset_decode_caches``, every wave.  ``info.plain`` is the body
    uncaptured on device tensors; ``info.init_caches()`` makes the caches
    (``lm.init_decode_caches(cfg, ctx, B, s_max)``) the step is bound to.
    The context comes from ``plan`` (its decode knobs) or ``topo``."""
    device = resolve_device(device)
    ctx = resolve_ctx(topo, plan, decode=True, device_type=device.type)

    @torch.no_grad()
    def step(params, tokens, pos, caches):
        logits, caches = lm.decode_step(ctx, cfg, params, tokens, pos, caches)
        return _greedy_pick(ctx, cfg, logits), caches

    def init_caches():
        return lm.init_decode_caches(cfg, ctx, B, s_max, device=device)

    return (CapturedStep(step, device, None, blank=lambda static: None,
                         guard=_state_guard),
            StepInfo(ctx=ctx, device=device, plain=step,
                     init_caches=init_caches))


def build_train_step(cfg: ModelConfig, topo: MeshTopo | None = None,
                     opt_cfg: adamw.AdamWConfig | None = None,
                     chunks: int = 1, remat: bool = True, device=None, *,
                     plan=None):
    """One training step: the loss and its gradients through autograd (the
    kernels' backward on CUDA), then AdamW.

    Returns ``(step, info)`` with ``step(params, opt_state, batch) ->
    (params, opt_state, metrics)``: ``params`` is this rank's shard
    (``lm.shard_params``), updated in place; ``opt_state`` from
    ``adamw.init_opt_state(params, info.ctx, opt_cfg.mode)``; ``batch``
    this dp rank's ``tokens`` and ``labels [b, s]`` on the device;
    ``metrics`` the loss and the global grad norm (0-d tensors) and the
    learning rate.  ``remat`` recomputes each block's activations in the
    backward.  The context comes from ``plan`` (its mesh and its
    per-segment knobs; ``chunks`` is then the plan's) or from ``topo`` and
    ``chunks``, through :func:`resolve_ctx`; its data-parallel axes may be
    one (data) or two (pod and data: a plan with ``pods``).  A topology of
    more than one rank needs ``torch.distributed`` initialized with one
    process per rank."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    device = resolve_device(device)
    lm.check_trainable(cfg)
    ctx = resolve_ctx(topo, plan, chunks, device_type=device.type)

    def step(params, opt_state, batch):
        leaves = adamw.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = lm.train_loss(ctx, cfg, params, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        grads = adamw.tree_unflatten(params, iter(grads))
        params, opt_state, metrics = adamw.apply_adamw(
            opt_cfg, ctx, params, grads, opt_state,
            lm.replication_factors(cfg, ctx, params),
            lm.fused_pieces(cfg, ctx, params))
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return step, StepInfo(ctx=ctx, device=device)
