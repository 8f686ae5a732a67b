"""Serving launcher (counterpart of ``repro.launch.serve``): paged
continuous batching (the fast path, ``--mode paged``, the default) or the
wave loop over contiguous decode caches (``--mode wave``, the baseline:
equal-length waves of ``--slots`` prompts, the last one padded with dummy
prompts, each prefilled in one step and decoded in lockstep).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --mode wave

runs on CUDA unless ``--device cpu`` is given; on CUDA the step runs as
a CUDA graph captured at each of its two shapes (``steps.CapturedStep``:
the paged step's prefill chunk and decode tick, the wave's prefill and
decode tick).
A model with recurrent segments (zamba2-7b) is served in recurrent mode:
per-slot state pools beside the page pools, prompt tails fed one token at
a time.  A mesh of more than one rank runs one process per rank under
``torch.distributed.run`` (which sets the rendezvous environment), e.g.
``python -m torch.distributed.run --nproc-per-node 4 -m
repro_torch.launch.serve --d1 2 --d2 2``.

The mesh and the knobs come from a ``ParallelPlan``: ``--plan FILE`` loads
one (``launch.train --save-plan`` writes it), ``--auto-atp`` searches one
for this model with the latency-aware decode objective (``--topology``, a
``core.comm_matrix`` preset, default ``h100-sxm-8``), and ``--d1/--d2``
alone serve on that mesh with the default knobs.  The server runs on the
plan's ``decode_view()``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --plan plan.json
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import comm_matrix
from repro_torch.core.mesh import atp_topo, resolve_device
from repro_torch.core.plan import ParallelPlan, plan_search
from repro_torch.launch.steps import (CapturedStep, StepInfo,
                                     build_decode_step, build_paged_step,
                                     check_slot_ids)
from repro_torch.models import lm
from repro_torch.models.paging import PagedConfig
from repro_torch.runtime.server import Request, Server, ServerConfig

log = logging.getLogger("repro_torch.serve")


@dataclasses.dataclass
class WaveServer:
    """The wave baseline's server: this rank's shard of the weights, the
    contiguous decode caches of a wave of ``batch`` prompts up to
    ``max_seq`` positions, and the decode step bound to them
    (``build_decode_step``: one CUDA graph for the wave's prefill and one
    for its decode tick; with ``captured`` off the uncaptured body).  Every
    wave reuses the caches (``lm.reset_decode_caches``), so the graphs are
    captured once."""
    step: CapturedStep
    info: StepInfo
    params: dict
    caches: dict
    batch: int
    max_seq: int
    captured: bool = True

    def uncaptured(self) -> "WaveServer":
        return dataclasses.replace(self, captured=False)

    def rows(self) -> slice:
        """This rank's rows of the wave: its dp share, or all of them
        where dp does not divide the batch."""
        ctx = self.info.ctx
        b = lm.decode_rows(ctx, self.batch)
        first = ctx.dp_index() * b if b < self.batch else 0
        return slice(first, first + b)

    def tick(self, tokens: np.ndarray, pos: int) -> np.ndarray:
        """One step on this rank's rows ``tokens [b, s]`` at position
        ``pos``: their greedy next tokens [b]."""
        if self.captured:
            return self.step(self.params, tokens, np.int32(pos),
                             self.caches)[0]
        dev = self.info.device
        toks, _ = self.info.plain(
            self.params, torch.as_tensor(tokens, device=dev),
            torch.tensor(pos, dtype=torch.int32, device=dev), self.caches)
        return toks.cpu().numpy()

    def serve(self, prompts, max_new: int) -> np.ndarray:
        """One wave of ``batch`` equal-length prompts: prefill, then
        ``max_new - 1`` decode ticks in lockstep.  Returns every prompt's
        greedy tokens [batch, max_new] on every rank."""
        toks = np.stack([np.asarray(p, np.int32) for p in prompts])
        plen = toks.shape[1]
        if toks.shape[0] != self.batch:
            raise ValueError(f"a wave of {toks.shape[0]} prompts on a "
                             f"server of {self.batch}")
        if plen + max_new - 1 > self.max_seq:
            raise ValueError(f"{plen} prompt and {max_new} new tokens do "
                             f"not fit max_seq={self.max_seq}")
        lm.reset_decode_caches(self.caches)
        outs = [self.tick(toks[self.rows()], 0)]
        for pos in range(plen, plen + max_new - 1):
            outs.append(self.tick(outs[-1][:, None], pos))
        return self._gather(np.stack(outs, axis=1))

    def _gather(self, mine: np.ndarray) -> np.ndarray:
        """The dp ranks' rows in dp order (nothing to gather where the
        wave is replicated)."""
        ctx = self.info.ctx
        if mine.shape[0] == self.batch:
            return mine
        import torch.distributed as dist

        dev = self.info.device
        part = torch.as_tensor(mine, device=dev)
        out = part.new_empty((self.batch,) + part.shape[1:])
        dist.all_gather_into_tensor(out, part, group=ctx.group(ctx.dp_axes))
        return out.cpu().numpy()


def make_wave_server(cfg, batch: int, max_seq: int, params, topo=None,
                     device=None, *, plan: ParallelPlan | None = None,
                     sharded: bool = False) -> WaveServer:
    """The wave baseline on ``topo`` (the trivial mesh by default) or on a
    ``plan``'s mesh with its decode knobs, as the reference's ``serve``
    builds it.  ``params`` is the GLOBAL tree, consumed as it is sharded,
    or with ``sharded`` this rank's shard already (a paged server's
    ``step_fn.params``: one set of weights serves both).  Runs on CUDA
    unless ``device`` names another device."""
    if topo is None and plan is None:
        topo = atp_topo(1, 1, 1)
    step, info = build_decode_step(cfg, topo, batch, max_seq, device=device,
                                   plan=plan)
    dev = info.device
    if not sharded:
        params = lm.shard_params(cfg, params, info.ctx)
    params = lm.tree_map(lambda t: t.to(dev), params)
    return WaveServer(step, info, params, info.init_caches(), batch,
                      max_seq)


def serve(cfg, topo, params, prompts, max_new: int, max_seq: int,
          plan: ParallelPlan | None = None, *, device=None) -> np.ndarray:
    """The wave baseline (``repro.launch.serve.serve``): one wave of
    equal-length ``prompts`` through a new :class:`WaveServer`; returns
    their greedy tokens [len(prompts), max_new]."""
    server = make_wave_server(cfg, len(prompts), max_seq, params, topo,
                              device, plan=plan)
    return server.serve(prompts, max_new)


def make_paged_server(cfg, scfg: ServerConfig, params, topo=None,
                      device=None, *, plan: ParallelPlan | None = None,
                      sharded: bool = False):
    """Build the paged continuous-batching server on ``topo`` (the trivial
    mesh by default) or on a ``plan``'s serving mesh.

    With a plan the server is built on ``plan.decode_view()``: serving is
    decode-dominated, and prefill and decode share one set of sharded
    params and caches, so a decode sub-plan's (d1, d2) wins; the decode
    sub-plan's ``speculate`` and ``prefix_cache`` join the ServerConfig's
    (and are refused as below).  ``params`` is the GLOBAL tree
    (``lm.init_params`` or ``convert.params_from_jax`` with the trivial
    topology); this rank's shard is cut from it here, consuming the tree
    (``sharded``: ``params`` is the shard already, as a
    :class:`WaveServer` holds it).  Runs on CUDA unless ``device`` names
    another device; raises without a GPU and without a named device.
    Returns ``(server, info)``."""
    if plan is not None:
        view = plan.decode_view()
        if (view.d1, view.d2) != (plan.d1, plan.d2):
            log.info("decode sub-plan re-meshes serving: %s -> "
                     "DeviceMesh(%d,%d)", plan.describe(), view.d1, view.d2)
        topo, plan = view.topo(), view
        if view.decode is not None:
            scfg = dataclasses.replace(
                scfg, speculate=scfg.speculate or view.decode.speculate,
                prefix_cache=scfg.prefix_cache or view.decode.prefix_cache)
    recurrent = lm.is_recurrent(cfg)
    if recurrent:
        # the JAX server's resolution: neither mode applies to a recurrent
        # state (no KV length to roll a draft back, no pages to share)
        if scfg.speculate:
            log.info("speculative decode off: recurrent state")
        if scfg.prefix_cache:
            log.info("prefix cache off: recurrent state is not "
                     "page-addressable")
        scfg = dataclasses.replace(scfg, speculate=False, prefix_cache=False)
    elif scfg.speculate or scfg.prefix_cache:
        raise NotImplementedError(
            "the port serves the plain and recurrent paged modes: prefix "
            "caching and MTP speculation are ROADMAP A9")
    scfg = dataclasses.replace(scfg, recurrent=recurrent)
    topo = topo if topo is not None else atp_topo(1, 1, 1)
    step_fn, init_caches, info = _build_paged_step_fn(cfg, scfg, params,
                                                      topo, device, plan,
                                                      sharded)
    return Server(scfg, step_fn, init_caches), info


@dataclasses.dataclass
class ServeStep:
    """The paged step in the Server's host-side calling convention:
    ``(tokens, start, table[, slot], caches)`` with numpy inputs (the slot
    ids in the recurrent mode only) -> (numpy greedy tokens, caches).  It
    runs the captured step (``build_paged_step``), or with ``captured``
    off the uncaptured body (``info.plain``), the same computation issued
    op by op.  Either way a live slot id that appears twice is refused on
    the host before anything is copied to the device."""
    step: CapturedStep
    info: StepInfo
    params: dict
    captured: bool = True

    def __call__(self, *args):
        if self.captured:
            return self.step(self.params, *args)
        *inputs, caches = args
        if self.step.slots is not None:
            check_slot_ids(inputs[3], self.step.slots)
        dev = self.info.device
        toks, caches = self.info.plain(
            self.params, *(torch.as_tensor(np.asarray(a), device=dev)
                           for a in inputs), caches)
        return toks.cpu().numpy(), caches

    def uncaptured(self) -> "ServeStep":
        return dataclasses.replace(self, captured=False)


def _build_paged_step_fn(cfg, scfg: ServerConfig, params, topo, device,
                         plan=None, sharded: bool = False):
    """The step in the Server's calling convention (a :class:`ServeStep`)
    and the caches' maker."""
    slots = scfg.batch_slots if scfg.recurrent else None
    step, info = build_paged_step(cfg, topo, device=device, slots=slots,
                                  plan=plan)
    dev = info.device
    if not sharded:
        params = lm.shard_params(cfg, params, info.ctx)
    params = lm.tree_map(lambda t: t.to(dev), params)

    def init_caches():
        return lm.init_paged_caches(cfg, info.ctx, scfg.paged, device=dev,
                                    slots=slots)

    return ServeStep(step, info, params), init_caches, info


def sample_prompts(cfg, requests: int, prompt_len: int, seed: int):
    """Mixed prompt lengths in ``[prompt_len // 4, prompt_len]`` with tokens
    uniform over the vocabulary, from ``seed``: the workload the paged path
    is built for."""
    rng = np.random.default_rng(seed)
    lens = [max(1, int(rng.integers(prompt_len // 4, prompt_len + 1)))
            for _ in range(requests)]
    return [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
            for n in lens]


def wave_prompts(cfg, requests: int, prompt_len: int, seed: int):
    """``requests`` prompts of ``prompt_len`` tokens uniform over the
    vocabulary, from ``seed``: the wave loop decodes in lockstep from one
    shared position, so its workload is equal-length."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=prompt_len, dtype=np.int32)
            for _ in range(requests)]


def paged_server_config(prompt_lens, *, slots: int, prefill_chunk: int,
                        page_size: int, max_seq: int, max_new: int,
                        num_pages: int = 0) -> ServerConfig:
    """The server geometry for a workload.  The pool holds every request's
    prompt plus its new tokens, plus the garbage page, unless
    ``num_pages`` is given."""
    num_pages = num_pages or 1 + sum(-(-(n + max_new) // page_size)
                                     for n in prompt_lens)
    return ServerConfig(
        batch_slots=slots, prefill_chunk=prefill_chunk,
        paged=PagedConfig(page_size=page_size, num_pages=num_pages,
                          pages_per_slot=-(-max_seq // page_size)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mode", choices=("paged", "wave"), default="paged")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--d1", type=int, default=1)
    ap.add_argument("--d2", type=int, default=1)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=272)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page-pool size (0 = sized to the workload)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan", default=None,
                    help="load a saved ParallelPlan JSON (train --save-plan)")
    ap.add_argument("--auto-atp", action="store_true",
                    help="search a plan for this model and shape (paper "
                         "§3.5), with the latency-aware decode objective")
    ap.add_argument("--topology", default="h100-sxm-8",
                    choices=list(comm_matrix.PRESETS),
                    help="comm-matrix preset for --auto-atp")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    plan = None
    if args.plan:
        plan = ParallelPlan.load(args.plan)
        log.info("loaded plan %s: %s", args.plan, plan.describe())
    elif args.auto_atp:
        plan = plan_search(
            args.topology, args.d1 * args.d2, model=cfg,
            batch=args.slots, seq=args.prompt_len + args.max_new,
            dp=args.dp, decode_batch=args.slots).best
        log.info("ATP plan search picked %s", plan.describe())
    if plan is not None:
        # the wave runs on the plan's own mesh, as the reference's serve
        topo = (plan.topo() if args.mode == "wave"
                else plan.decode_view().topo())
    else:
        topo = atp_topo(args.dp, args.d1, args.d2)
    device = resolve_device(args.device)
    if topo.size > 1:
        import torch.distributed as dist

        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    params = lm.init_params(cfg, seed=args.seed, device=device)
    if args.mode == "wave":
        return _serve_waves(cfg, args, params, topo, device, plan)
    prompts = sample_prompts(cfg, args.requests, args.prompt_len, args.seed)
    scfg = paged_server_config(
        [len(p) for p in prompts], slots=args.slots,
        prefill_chunk=args.prefill_chunk, page_size=args.page_size,
        max_seq=args.max_seq, max_new=args.max_new, num_pages=args.num_pages)
    server, _ = make_paged_server(cfg, scfg, params, topo=topo, device=device,
                                  plan=plan)
    for rid, p in enumerate(prompts):
        server.submit(Request(rid=rid, prompt=p, max_new=args.max_new))
    t0 = time.perf_counter()
    ticks = server.run_until_drained()
    secs = time.perf_counter() - t0
    for req in sorted(server.completed, key=lambda r: r.rid):
        log.info("request %d (%d prompt tokens) -> %s", req.rid,
                 len(req.prompt), req.out)
    log.info("served %d requests in %d ticks, %.2fs on %s", len(server.completed),
             ticks, secs, device)


def _serve_waves(cfg, args, params, topo, device, plan) -> None:
    """``--mode wave``: equal-length waves of ``--slots`` prompts, the last
    one padded with dummy prompts (zeros) whose tokens are dropped."""
    server = make_wave_server(cfg, args.slots, args.max_seq, params, topo,
                              device, plan=plan)
    prompts = wave_prompts(cfg, args.requests, args.prompt_len, args.seed)
    t0 = time.perf_counter()
    waves = 0
    for first in range(0, len(prompts), args.slots):
        batch = prompts[first:first + args.slots]
        real = len(batch)
        batch += [np.zeros(args.prompt_len, np.int32)] * (args.slots - real)
        outs = server.serve(batch, args.max_new)
        for i in range(real):
            log.info("wave %d request %d -> %s", waves, first + i,
                     outs[i].tolist())
        waves += 1
    log.info("served %d requests in %d waves, %.2fs on %s", len(prompts),
             waves, time.perf_counter() - t0, device)


if __name__ == "__main__":
    main()
