"""Serving scheduler: paged continuous batching with chunked prefill
(copied from ``repro.runtime.server``: host numpy code over the port's
``models.paging``).

:class:`Server` is the serving fast path — a real scheduler over the
block-paged KV caches (``models.paging`` / ``lm.init_paged_caches``):

  - **admission** pops queued requests into free slots and allocates
    pages for the *chunk-rounded natural* prompt length (never the
    padded slot budget — a 9-token prompt with chunk=8 pays 16 tokens of
    prefill compute, not ``max_seq``);
  - **chunked prefill** feeds each admitted prompt through a fixed-size
    compiled ``prefill chunk`` step (b=1), interleaved with decode ticks
    so long prompts cannot stall live streams (at most
    ``prefill_chunks_per_tick`` chunks between decode ticks);
  - **continuous decode** advances every decode-ready slot one token per
    tick with per-slot positions — slots carry independent lengths and
    recycle the moment a request finishes, returning their pages to the
    pool (no wave barriers);
  - **backpressure**: when the page pool cannot cover an admission or a
    decode append, the request waits (admission) while live slots keep
    decoding into their already-mapped pages.

The scheduler keeps the JAX package's three opt-in modes unchanged as
host logic, and the port's server (``launch.serve.make_paged_server``)
runs each of them:

  - ``prefix_cache`` -- copy-on-write prefix sharing: admission matches a
    new prompt's longest page-aligned prefix against the allocator's
    radix index, adopts those pages read-only and skips their prefill
    chunks; completed prompts register their full pages for future hits.
  - ``recurrent`` -- mamba/zamba/xlstm residency: the step takes a per-row
    slot-id array addressing per-slot state pools, and prompt tails feed
    one token at a time through the decode-shaped step.
  - ``speculate`` -- MTP self-speculative decode: each tick feeds
    [previous, draft] (s=2); the trunk's pick at position 0 verifies the
    draft.  Accept keeps both tokens; reject keeps only the verified one,
    and the stale draft KV at ``length+1`` is overwritten by the next
    tick's append before any gather reads it.  Exact greedy parity.

The page pools may be int8 or fp8 (``PagedConfig.page_dtype``), which the
scheduler sees only through ``cache_bytes``.

One step function serves both shapes (prefill chunk b=1, decode tick
b=slots), so mixed prompt lengths share it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from repro_torch.models.paging import GARBAGE_PAGE, PageAllocator, PagedConfig


def _leaves(tree) -> list:
    """The tensors of a nested dict/list/tuple cache tree."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [s] int32
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    #: scheduler-tick budget from submit; None = no deadline.  A request
    #: still incomplete when the budget elapses is expired at the next
    #: tick: its pages/state return to the pool immediately and it lands
    #: in ``Server.expired`` (graceful degradation — under pressure the
    #: pool drains instead of wedging on doomed work)
    deadline_ticks: int | None = None
    #: set when the deadline fired (partial ``out`` is kept as-is)
    expired: bool = False


@dataclasses.dataclass
class ServerConfig:
    batch_slots: int = 4
    prefill_chunk: int = 8
    paged: PagedConfig = dataclasses.field(default_factory=PagedConfig)
    #: prefill chunks fed between consecutive decode ticks (keeps prompt
    #: ingestion from starving live decode streams)
    prefill_chunks_per_tick: int = 1
    #: copy-on-write prefix sharing across requests (radix index over
    #: page contents; see models.paging)
    prefix_cache: bool = False
    #: MTP self-speculative decode — the compiled step must return
    #: (tokens, drafts, caches) (build_paged_step(speculate=True))
    speculate: bool = False
    #: recurrent state pools (mamba/zamba/xlstm) — the compiled step
    #: takes a per-row slot-id array (build_paged_step(slots=...))
    recurrent: bool = False
    #: admission retry-with-backoff: after a back-pressured admission the
    #: scheduler waits ``base * 2**(consecutive_failures - 1)`` ticks
    #: (capped at ``max``) before retrying, so a saturated pool is not
    #: hammered with doomed ensure() calls every tick while live slots
    #: drain.  base=1, max=1 recovers the pre-backoff retry-every-tick
    #: behavior.
    admission_backoff_base: int = 1
    admission_backoff_max: int = 8
    #: pressure-triggered prefix-cache eviction: when the pool's free
    #: pages dip below this mark, index-only pages are evicted
    #: (leaf-first, refcount-safe) back up to it BEFORE allocation
    #: failures force reactive eviction.  0 disables (default).
    eviction_low_water: int = 0


@dataclasses.dataclass
class _Slot:
    req: Request
    fed: int = 0          # prompt tokens already prefilled (chunk-rounded)
    length: int = 0       # valid cache length (excludes padded chunk tail)
    decoding: bool = False
    draft: int | None = None   # speculative: MTP draft awaiting verify


class Server:
    """Drives one compiled paged step over a request stream.

    paged_step_fn(tokens [b, s], start [b], table [b, mp], caches)
        -> (greedy tokens [b, s], caches)

    (recurrent mode inserts a ``slot [b]`` arg before caches; speculate
    mode returns (tokens, drafts, caches))

    called at two shapes: (1, prefill_chunk) while prefilling and
    (batch_slots, 1 or 2) for decode ticks.  The scheduler owns the page
    allocator; the compiled step sees positions/tables as runtime data.
    """

    def __init__(self, cfg: ServerConfig, paged_step_fn: Callable,
                 init_caches: Callable[[], Any]):
        if cfg.speculate and cfg.recurrent:
            raise ValueError(
                "speculate + recurrent: draft rollback needs a KV length "
                "pointer; recurrent state has no position axis")
        if cfg.prefix_cache and cfg.recurrent:
            raise ValueError(
                "prefix_cache + recurrent: prefix sharing reuses cached "
                "KV pages; recurrent state is not page-addressable")
        self.cfg = cfg
        self.step_fn = paged_step_fn
        self.caches = init_caches()
        self.alloc = PageAllocator(cfg.paged, cfg.batch_slots,
                                   prefix_cache=cfg.prefix_cache)
        self.slots: list[_Slot | None] = [None] * cfg.batch_slots
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        self.expired: list[Request] = []
        self.ticks = 0
        self._prompt_tokens = 0
        self._prefix_hit_tokens = 0
        self._spec_drafts = 0
        self._spec_accepted = 0
        #: rid -> absolute expiry tick (set at submit from deadline_ticks)
        self._deadline: dict[int, int] = {}
        self._admit_fails = 0
        self._next_admit_tick = 0
        self._admission_retries = 0
        self._evicted_pages = 0
        self._reshapes = 0

    # -- bookkeeping -------------------------------------------------------

    def submit(self, req: Request):
        # the slot's page table must cover BOTH the chunk-rounded prefill
        # (admission reserves/writes whole chunks incl. the padded tail)
        # and decode growth: each decode tick writes its input token's KV
        # at `length`, touching natural + (max_new - 1) positions — one
        # more under speculation (the last tick's draft KV at length+1)
        grow = req.max_new if self.cfg.speculate else max(0, req.max_new - 1)
        need = max(self._chunk_rounded(len(req.prompt)),
                   len(req.prompt) + grow)
        if need > self.cfg.paged.max_seq:
            raise ValueError(
                f"request {req.rid}: {len(req.prompt)} prompt + "
                f"{req.max_new} new tokens need {need} positions, over "
                f"the page-table ceiling {self.cfg.paged.max_seq}")
        if req.deadline_ticks is not None:
            self._deadline[req.rid] = self.ticks + req.deadline_ticks
        self.queue.append(req)

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def cache_bytes(self) -> int:
        """Device bytes held by the page pools — value leaves plus, for
        quantized pools, the fp16 scale leaves (the honest total the
        quantization ratio is measured against)."""
        return sum(int(np.prod(x.shape)) * x.dtype.itemsize
                   for x in _leaves(self.caches))

    def used_cache_bytes(self) -> int:
        """Device bytes actually *referenced*: every distinct held page
        (slot-mapped or prefix-index-pinned) billed exactly once — a page
        shared by three slots under copy-on-write costs one page, not
        three — plus all non-pool leaves (recurrent state pools) in full.
        Pool leaves are recognized by their (count, num_pages, page_size,
        ...) geometry; scale pools ride along automatically."""
        pcfg = self.cfg.paged
        pool_bytes = 0
        total = 0
        for x in _leaves(self.caches):
            nbytes = int(np.prod(x.shape)) * x.dtype.itemsize
            total += nbytes
            if (getattr(x, "ndim", 0) >= 3 and x.shape[1] == pcfg.num_pages
                    and x.shape[2] == pcfg.page_size):
                pool_bytes += nbytes
        per_page = pool_bytes // max(1, pcfg.num_pages)
        return self.alloc.held_pages * per_page + (total - pool_bytes)

    def stats(self) -> dict:
        """Scheduler/pool counters for benches and operators."""
        hit = (self._prefix_hit_tokens / self._prompt_tokens
               if self._prompt_tokens else 0.0)
        acc = (self._spec_accepted / self._spec_drafts
               if self._spec_drafts else 0.0)
        return {"ticks": self.ticks,
                "live_tokens": sum(s.length for s in self.slots
                                   if s is not None),
                "free_pages": self.alloc.free_pages,
                "page_dtype": self.cfg.paged.page_dtype,
                "cache_bytes": self.cache_bytes(),
                "used_cache_bytes": self.used_cache_bytes(),
                "pages_shared": self.alloc.pages_shared,
                "prefix_hit_rate": hit,
                "spec_drafts": self._spec_drafts,
                "spec_accepted": self._spec_accepted,
                "spec_accept_rate": acc,
                "expired": len(self.expired),
                "admission_retries": self._admission_retries,
                "evicted_pages": self._evicted_pages,
                "reshapes": self._reshapes}

    def _chunk_rounded(self, n: int) -> int:
        c = self.cfg.prefill_chunk
        return -(-n // c) * c

    # -- compiled-step dispatch -------------------------------------------

    def _run(self, tokens, start, table, slot=None):
        """Call the compiled step with the mode-appropriate signature.
        Returns (tokens, drafts-or-None); caches update in place."""
        if self.cfg.recurrent:
            if slot is None:
                slot = np.full((tokens.shape[0],), self.cfg.batch_slots,
                               np.int32)
            out = self.step_fn(tokens, start, table, slot, self.caches)
        else:
            out = self.step_fn(tokens, start, table, self.caches)
        if self.cfg.speculate:
            toks, drafts, self.caches = out
            return toks, drafts
        toks, self.caches = out
        return toks, None

    # -- graceful degradation ---------------------------------------------

    def _expire_one(self, req: Request):
        req.expired = True
        self._deadline.pop(req.rid, None)
        self.expired.append(req)

    def _expire(self):
        """Deadline enforcement (ladder rung 3): every request whose tick
        budget has elapsed is dropped NOW — queued requests simply leave
        the queue; live slots release their pages/state back to the pool
        in the same tick, so expiry is also how a saturated pool drains.
        The partial ``out`` stays on the request (a client may still use
        a truncated stream)."""
        if not self._deadline:
            return

        def over(r):
            return self._deadline.get(r.rid, self.ticks + 1) <= self.ticks

        doomed = [r for r in self.queue if over(r)]
        self.queue = [r for r in self.queue if not over(r)]
        for r in doomed:
            self._expire_one(r)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            if self._deadline.get(s.req.rid, self.ticks + 1) <= self.ticks:
                self.alloc.release(i)
                self.slots[i] = None
                self._expire_one(s.req)

    def _evict_pressure(self):
        """Low-water prefix-cache eviction (ladder rung 2): shed
        index-only pages before the pool runs dry, instead of waiting for
        an allocation failure to force it."""
        lw = self.cfg.eviction_low_water
        if lw and self.cfg.prefix_cache and self.alloc.free_pages < lw:
            self._evicted_pages += self.alloc.evict_pinned(
                lw - self.alloc.free_pages)

    # -- scheduling --------------------------------------------------------

    def _admit(self):
        """Fill free slots from the queue — reserving pages for the
        chunk-rounded natural length only (the satellite fix: short
        prompts stop paying the padded slot budget).  With the prefix
        cache on, the longest page-aligned cached prefix is adopted
        read-only and its prefill is skipped entirely; the match is
        capped below the last prompt position because the first output
        token needs that position's logits from a real prefill step.

        Back-pressured admissions retry with exponential backoff (ladder
        rung 1): each consecutive failure doubles the wait before the
        next attempt (``admission_backoff_base``..``_max`` ticks), and
        any successful admission resets the clock."""
        if self.ticks < self._next_admit_tick:
            return
        for i, s in enumerate(self.slots):
            if s is not None or not self.queue:
                continue
            req = self.queue[0]
            prompt = req.prompt
            rounded = self._chunk_rounded(len(prompt))
            matched = ()
            if self.cfg.prefix_cache:
                ps = self.cfg.paged.page_size
                matched = self.alloc.match_prefix(prompt)
                matched = matched[:(len(prompt) - 1) // ps]
                if matched:
                    self.alloc.adopt(i, matched)
            # reserve the prompt's pages up front so a half-prefilled
            # prompt can never deadlock the pool mid-flight
            if not self.alloc.ensure(i, rounded):
                if matched:
                    self.alloc.release(i)   # roll the adoption back
                self._admit_fails += 1
                self._admission_retries += 1
                self._next_admit_tick = self.ticks + min(
                    self.cfg.admission_backoff_max,
                    self.cfg.admission_backoff_base
                    * 2 ** (self._admit_fails - 1))
                break  # backpressure: keep decoding, retry after backoff
            self.queue.pop(0)
            self._admit_fails = 0
            skip = len(matched) * self.cfg.paged.page_size
            self.slots[i] = _Slot(req=req, fed=skip, length=skip)
            self._prompt_tokens += len(prompt)
            self._prefix_hit_tokens += skip

    def _finish_prefill(self, i: int, s: _Slot, first: int):
        """Prompt fully fed: record the first output token, index the
        prompt's full pages for prefix reuse, flip to decode (or complete
        outright for max_new=1)."""
        s.req.out.append(first)
        if self.cfg.prefix_cache:
            self.alloc.register_prefix(i, s.req.prompt)
        if len(s.req.out) >= s.req.max_new:
            # max_new=1: done at prefill — no decode tick
            s.req.done = True
            self.completed.append(s.req)
            self.alloc.release(i)
            self.slots[i] = None
        else:
            s.decoding = True

    def _prefill_some(self):
        """Feed up to ``prefill_chunks_per_tick`` chunks (FCFS over
        slots), each one a b=1 compiled step at the fixed chunk size.
        Recurrent mode feeds whole chunks only while a full chunk of
        prompt remains, then the tail one token at a time through the
        decode-shaped step (each tail token charges one chunk of budget):
        exact state, no padded positions."""
        fed = 0
        C = self.cfg.prefill_chunk
        budget = self.cfg.prefill_chunks_per_tick
        for i, s in enumerate(self.slots):
            if fed >= budget:
                break
            if s is None or s.decoding:
                continue
            prompt = s.req.prompt
            while s.fed < len(prompt) and fed < budget:
                rem = len(prompt) - s.fed
                if self.cfg.recurrent and rem < C:
                    B = self.cfg.batch_slots
                    tokens = np.zeros((B, 1), np.int32)
                    tokens[i, 0] = prompt[s.fed]
                    start = np.zeros((B,), np.int32)
                    start[i] = s.fed
                    table = self.alloc.table()
                    mask = np.ones((B,), bool)
                    mask[i] = False
                    table[mask] = GARBAGE_PAGE
                    slot = np.full((B,), B, np.int32)  # sentinel: drop
                    slot[i] = i
                    toks, _ = self._run(tokens, start, table, slot)
                    s.fed += 1
                    s.length = s.fed
                    fed += 1
                    if s.length == len(prompt):
                        self._finish_prefill(i, s,
                                             int(np.asarray(toks)[i, 0]))
                        break
                    continue
                chunk = np.zeros((1, C), np.int32)
                n_valid = min(C, rem)
                chunk[0, :n_valid] = prompt[s.fed: s.fed + n_valid]
                table = self.alloc.table()[i: i + 1]
                start = np.array([s.fed], np.int32)
                slot = np.array([i], np.int32)
                toks, drafts = self._run(chunk, start, table, slot)
                s.fed += C  # padded tail included; masked by `length`
                s.length = min(s.fed, len(prompt))
                fed += 1
                if s.length == len(prompt):
                    # first generated token = greedy pick at the last
                    # VALID position of this (possibly padded) chunk
                    if drafts is not None:
                        # the chunk's free MTP draft: the token predicted
                        # to FOLLOW the first output token
                        s.draft = int(np.asarray(drafts)[0, n_valid - 1])
                    self._finish_prefill(
                        i, s, int(np.asarray(toks)[0, n_valid - 1]))
                    break

    def _decode_tick(self) -> bool:
        if self.cfg.speculate:
            return self._decode_tick_spec()
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and s.decoding]
        if not active:
            return False
        B = self.cfg.batch_slots
        tokens = np.zeros((B, 1), np.int32)
        start = np.zeros((B,), np.int32)
        writing = []
        for i in active:
            s = self.slots[i]
            # the appended token needs its page mapped; reserved prompt
            # pages usually cover it, growth is page-at-a-time
            if not self.alloc.ensure(i, s.length + 1):
                continue  # pool exhausted: this slot skips a beat
            tokens[i, 0] = s.req.out[-1]
            start[i] = s.length
            writing.append(i)
        if not writing:
            return True  # every live stream is back-pressured this tick
        # slots NOT advancing this tick (free, mid-prefill, back-pressured)
        # must not see their mapped pages: the batched scatter would land
        # their dummy token at position `start` of a live sequence.  Route
        # their rows to the garbage page instead.
        table = self.alloc.table()
        mask = np.ones((B,), bool)
        mask[writing] = False
        table[mask] = GARBAGE_PAGE
        slot = np.full((B,), B, np.int32)   # sentinel: state writes drop
        slot[writing] = writing
        nxt, _ = self._run(tokens, start, table, slot)
        nxt = np.asarray(nxt)[:, 0]
        for i in writing:
            s = self.slots[i]
            s.length += 1
            s.req.out.append(int(nxt[i]))
            if len(s.req.out) >= s.req.max_new:
                s.req.done = True
                self.completed.append(s.req)
                self.alloc.release(i)   # pages return to the pool
                self.slots[i] = None
        return True

    def _decode_tick_spec(self) -> bool:
        """Speculative decode tick at (B, 2): feed [prev, draft] per
        writing slot.  The trunk pick at position 0 is the TRUE next
        token (always kept); it also verifies the draft — on a match the
        pick at position 1 is the token after it (two tokens this tick,
        and the draft's KV written at length+1 is already correct).  On a
        mismatch the length pointer simply doesn't cover the stale draft
        KV, and the next tick's append overwrites it before any gather.
        The first tick after prefill without an MTP draft feeds prev as
        a dummy draft (an accidental match is still a correct accept);
        only real MTP drafts count toward the acceptance-rate stats."""
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and s.decoding]
        if not active:
            return False
        B = self.cfg.batch_slots
        tokens = np.zeros((B, 2), np.int32)
        start = np.zeros((B,), np.int32)
        writing = []
        had_draft = {}
        for i in active:
            s = self.slots[i]
            # this tick writes KV at length (prev) AND length+1 (draft)
            if not self.alloc.ensure(i, s.length + 2):
                continue
            had_draft[i] = s.draft is not None
            tokens[i, 0] = s.req.out[-1]
            tokens[i, 1] = s.draft if s.draft is not None else s.req.out[-1]
            start[i] = s.length
            writing.append(i)
        if not writing:
            return True
        table = self.alloc.table()
        mask = np.ones((B,), bool)
        mask[writing] = False
        table[mask] = GARBAGE_PAGE
        toks, drafts = self._run(tokens, start, table)
        toks = np.asarray(toks)
        drafts = np.asarray(drafts)
        for i in writing:
            s = self.slots[i]
            fed_draft = int(tokens[i, 1])
            t1 = int(toks[i, 0])
            s.length += 1
            s.req.out.append(t1)
            accept = fed_draft == t1 and len(s.req.out) < s.req.max_new
            if had_draft[i]:
                self._spec_drafts += 1
                self._spec_accepted += int(accept)
            if accept:
                s.length += 1
                s.req.out.append(int(toks[i, 1]))
                s.draft = int(drafts[i, 1])
            else:
                s.draft = int(drafts[i, 0])
            if len(s.req.out) >= s.req.max_new:
                s.req.done = True
                self.completed.append(s.req)
                self.alloc.release(i)
                self.slots[i] = None
        return True

    def step(self):
        """One scheduler tick: expire, evict, admit, feed prefill chunks,
        decode tick.  The first two are the degradation ladder's passive
        rungs — under pressure they run every tick so the pool can only
        drain, never wedge."""
        self._expire()
        self._evict_pressure()
        self._admit()
        self._prefill_some()
        decoded = self._decode_tick()
        self.ticks += 1
        return decoded or any(s is not None for s in self.slots)

    # -- elastic remesh ----------------------------------------------------

    def reshape(self, paged_step_fn: Callable,
                init_caches: Callable[[], Any]):
        """Drain-and-remesh (ladder rung 4): swap in a step compiled for
        a different decode mesh and replay in-flight work on it.

        The old mesh's caches are unreadable after a shrink (their pages
        lived on devices that may be gone), so every live slot's progress
        is converted back into *prompt* form: the request's feed sequence
        becomes ``original prompt + tokens emitted so far`` (``prompt``
        is extended in place; ``out`` keeps the already-delivered
        tokens), and the request re-queues for ordinary admission +
        chunked prefill on the survivors.  Greedy decode makes this
        exact: re-prefilling prompt+out reproduces bit-identical KV for
        those positions, and the argmax at the last valid position IS the
        next token of the uninterrupted stream — token parity for every
        replayed request, with no checkpoint of cache state.

        Speculative drafts are dropped (never delivered, cheap to
        re-derive); the prefix-cache radix index resets with the
        allocator (its pages died with the old pool).  A continuation
        whose chunk-rounded feed no longer fits the page table
        (``prompt+out`` rounds past ``max_seq``) cannot be replayed and
        is expired instead — the same contract as a deadline.
        """
        live = [s for s in self.slots if s is not None]
        self.step_fn = paged_step_fn
        self.caches = init_caches()
        self.alloc = PageAllocator(self.cfg.paged, self.cfg.batch_slots,
                                   prefix_cache=self.cfg.prefix_cache)
        self.slots = [None] * self.cfg.batch_slots
        self._admit_fails = 0
        self._next_admit_tick = 0
        self._reshapes += 1
        requeue = []
        for s in live:
            req = s.req
            if req.out:
                req.prompt = np.concatenate(
                    [np.asarray(req.prompt, np.int32),
                     np.asarray(req.out, np.int32)])
            remaining = req.max_new - len(req.out)
            grow = remaining if self.cfg.speculate else max(0, remaining - 1)
            need = max(self._chunk_rounded(len(req.prompt)),
                       len(req.prompt) + grow)
            if need > self.cfg.paged.max_seq:
                self._expire_one(req)
                continue
            requeue.append(req)
        self.queue = requeue + self.queue

    def run_until_drained(self, max_ticks: int = 10000) -> int:
        t0 = self.ticks
        while self.busy and self.ticks - t0 < max_ticks:
            self.step()
        return self.ticks - t0
