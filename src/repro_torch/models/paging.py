"""Block-paged KV-cache storage: fixed-size pages + per-slot page tables
(counterpart of ``repro.models.paging``).

Every attention-cache tensor stores ``num_pages * page_size`` token
positions shared by all serving slots; each slot maps its logical
positions onto physical pages through a small int32 page table, so memory
scales with live tokens, not ``slots x s_max``.

  - :class:`PagedConfig` fixes the geometry shared by host and device;
  - :class:`PageAllocator` is the HOST-side bookkeeper (numpy), copied from
    the JAX package with its copy-on-write radix prefix index;
  - :func:`gather_pages` / :func:`append_tokens` are the device-side
    accessors in torch: attention reads a slot's mapped pages, and cache
    writes scatter tokens through the table.

Physical page 0 is reserved as the *garbage page*: unmapped table entries
point at it, so inactive slots and padded chunk tails scatter there
harmlessly (every read is masked by the slot's length before softmax).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: physical page reserved for unmapped table entries / padded writes
GARBAGE_PAGE = 0

#: storage dtypes a page pool supports; "bf16" means "the model dtype"
#: (no quantization), the narrow ones store 1 byte/elem plus an fp16
#: per-position scale
PAGE_DTYPES = ("bf16", "int8", "fp8")


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    """Page-pool geometry shared by the scheduler and the compiled steps.

    ``num_pages`` INCLUDES the reserved garbage page 0, so the pool holds
    ``(num_pages - 1) * page_size`` usable token positions.
    ``pages_per_slot`` is the page-table width — the per-slot sequence
    ceiling is ``pages_per_slot * page_size`` (the paged analogue of
    ``s_max``, but it bounds only the *table*, not the memory: unmapped
    entries cost nothing).

    ``page_dtype`` picks the pool storage format: "bf16" stores the model
    dtype verbatim.  The port's pools take only "bf16": the int8/fp8 pools
    with per-position scales are ROADMAP A9 (``init_paged_caches`` raises).
    """

    page_size: int = 8
    num_pages: int = 64
    pages_per_slot: int = 8
    page_dtype: str = "bf16"

    def __post_init__(self):
        if self.page_size < 1 or self.num_pages < 2 or self.pages_per_slot < 1:
            raise ValueError(f"degenerate page geometry: {self}")
        if self.page_dtype not in PAGE_DTYPES:
            raise ValueError(f"page_dtype must be one of {PAGE_DTYPES}, "
                             f"got {self.page_dtype!r}")

    @property
    def max_seq(self) -> int:
        """Per-slot sequence ceiling (page-table width x page size)."""
        return self.pages_per_slot * self.page_size

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` positions."""
        return -(-n_tokens // self.page_size)


class PageAllocator:
    """Host-side page bookkeeping for one pool (numpy only).

    Not thread-safe; the scheduler owns it.  ``False`` returns mean the
    pool is exhausted — the caller defers (backpressure) rather than
    raising, because a continuous-batching scheduler can simply keep
    decoding its live slots until pages free up.

    With ``prefix_cache=True`` the allocator additionally maintains
    per-page refcounts and a radix index over page contents (copy-on-
    write prefix sharing — see the module docstring): ``match_prefix``
    walks the index, ``adopt`` maps shared pages into a slot, and
    ``register_prefix`` pins a completed prompt's full pages for future
    admissions.  ``release`` decrements refcounts and frees only at
    zero.  Without the flag every page has exactly one owner and the
    behavior is the seed allocator's, bit for bit.
    """

    def __init__(self, cfg: PagedConfig, slots: int,
                 prefix_cache: bool = False):
        self.cfg = cfg
        self.slots = slots
        self.prefix_cache = prefix_cache
        self._free = list(range(cfg.num_pages - 1, GARBAGE_PAGE, -1))
        self._owned: list[list[int]] = [[] for _ in range(slots)]
        #: page -> mapping count (slot mappings + 1 if pinned by the index)
        self._refs: dict[int, int] = {}
        #: radix node: (parent page id or -1, page-content tokens) -> page
        self._radix: dict[tuple[int, tuple[int, ...]], int] = {}
        self._radix_rev: dict[int, tuple[int, tuple[int, ...]]] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def slot_pages(self, slot: int) -> tuple[int, ...]:
        return tuple(self._owned[slot])

    @property
    def live_pages(self) -> int:
        """Distinct pages mapped by at least one slot (shared counted once)."""
        return len({p for owned in self._owned for p in owned})

    @property
    def pages_shared(self) -> int:
        """Slot-mapped page references beyond each page's first mapping —
        the device pages copy-on-write sharing is currently saving."""
        counts: dict[int, int] = {}
        for owned in self._owned:
            for p in owned:
                counts[p] = counts.get(p, 0) + 1
        return sum(c - 1 for c in counts.values() if c > 1)

    @property
    def pinned_pages(self) -> int:
        """Pages held (only) by the prefix index, reusable or evictable."""
        return len(self._radix_rev)

    @property
    def held_pages(self) -> int:
        """Distinct non-free pages — slot-mapped or index-pinned, each
        counted once regardless of refcount (what honest cache-bytes
        accounting bills)."""
        return len({p for owned in self._owned for p in owned}
                   | set(self._radix_rev))

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s mapping to cover ``n_tokens`` positions.

        Returns False (allocating nothing) when the pool cannot satisfy
        the request — transient backpressure the caller retries.  A
        request exceeding the page-table WIDTH raises instead: no amount
        of waiting can map more than ``pages_per_slot`` pages, so the
        scheduler must reject it at submit time (``Server.submit``).
        Under pool pressure, index-pinned pages no slot maps are evicted
        (leaf-first, so the radix never strands unreachable children).
        """
        need = self.cfg.pages_for(n_tokens)
        if need > self.cfg.pages_per_slot:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens need {need} pages > "
                f"pages_per_slot={self.cfg.pages_per_slot}")
        grow = need - len(self._owned[slot])
        if grow <= 0:
            return True
        if grow > len(self._free):
            self._evict(grow - len(self._free))
        if grow > len(self._free):
            return False
        for _ in range(grow):
            p = self._free.pop()
            self._refs[p] = 1
            self._owned[slot].append(p)
        return True

    def release(self, slot: int) -> None:
        """Unmap all of ``slot``'s pages (slot recycle): refcounts drop by
        one and only pages nobody else maps (and the prefix index does
        not pin) return to the free list."""
        pages = self._owned[slot]
        for p in reversed(pages):
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)
        self._owned[slot] = []

    # -- copy-on-write prefix sharing (radix index over page contents) ----

    def match_prefix(self, tokens) -> tuple[int, ...]:
        """Longest chain of cached full pages covering a prefix of
        ``tokens``.  Each hop matches one page's exact contents under its
        parent, so a k-page hit proves tokens[:k*page_size] equality."""
        if not self.prefix_cache:
            return ()
        ps = self.cfg.page_size
        toks = [int(t) for t in tokens]
        out: list[int] = []
        parent = -1
        for j in range(len(toks) // ps):
            page = self._radix.get((parent, tuple(toks[j * ps:(j + 1) * ps])))
            if page is None:
                break
            out.append(page)
            parent = page
        return tuple(out)

    def adopt(self, slot: int, pages) -> None:
        """Map shared (prefix-cache) pages read-only into an empty slot.

        The pages come first in the slot's table — the caller must adopt
        before any private ``ensure`` growth, and must only write
        positions past the adopted prefix (COW: shared pages are never
        mutated; a diverging suffix lands in later, private pages)."""
        if self._owned[slot]:
            raise ValueError(
                f"slot {slot}: adopt() must precede private page growth "
                f"(owns {len(self._owned[slot])} pages)")
        for p in pages:
            self._refs[p] = self._refs.get(p, 0) + 1
            self._owned[slot].append(p)

    def register_prefix(self, slot: int, tokens) -> int:
        """Index ``slot``'s fully-written prompt pages for future reuse.

        Called when a prompt's prefill completes: every page whose
        page_size positions are all covered by prompt tokens becomes a
        radix node (+1 pin ref).  Pages already indexed under the same
        content chain are walked, not re-registered, so concurrent
        identical prompts converge on one physical copy.  Returns the
        number of newly indexed pages."""
        if not self.prefix_cache:
            return 0
        ps = self.cfg.page_size
        toks = [int(t) for t in tokens]
        owned = self._owned[slot]
        parent = -1
        added = 0
        for j in range(len(toks) // ps):
            if j >= len(owned):
                break
            key = (parent, tuple(toks[j * ps:(j + 1) * ps]))
            hit = self._radix.get(key)
            if hit is not None:
                parent = hit
                continue
            page = owned[j]
            if page in self._radix_rev:
                # already indexed under a different chain — re-keying
                # would corrupt both chains; stop here
                break
            self._radix[key] = page
            self._radix_rev[page] = key
            self._refs[page] = self._refs.get(page, 0) + 1
            parent = page
            added += 1
        return added

    def drop_prefix_index(self) -> int:
        """Unpin the whole prefix index (operator reset); pages nobody
        maps return to the free list.  Returns pages freed."""
        freed = 0
        for page in list(self._radix_rev):
            self._unpin(page)
            if self._refs.get(page) is None:
                freed += 1
        return freed

    def _unpin(self, page: int) -> None:
        key = self._radix_rev.pop(page)
        del self._radix[key]
        self._refs[page] -= 1
        if self._refs[page] == 0:
            del self._refs[page]
            self._free.append(page)

    def evict_pinned(self, n: int) -> int:
        """Pressure-eviction hook: free up to ``n`` index-only pages.

        The degradation ladder (``runtime.server``) calls this *before*
        pool exhaustion forces reactive eviction inside ``ensure`` — the
        same leaf-first, refcount-safe walk, surfaced so a scheduler can
        shed cache weight on a low-water-mark signal instead of on the
        first failed allocation.  Returns the number of pages freed
        (less than ``n`` when only slot-mapped or interior pages remain).
        """
        return self._evict(n)

    def _evict(self, n: int) -> int:
        """Free up to ``n`` pages held only by the prefix index —
        leaf-first (never a node with indexed children, so surviving
        chains stay reachable), newest-registered first.  Returns pages
        freed."""
        freed = 0
        while freed < n and self._radix:
            mapped = {p for owned in self._owned for p in owned}
            parents = {k[0] for k in self._radix}
            victim = None
            for page in reversed(list(self._radix_rev)):
                if page not in parents and page not in mapped:
                    victim = page
                    break
            if victim is None:
                return freed
            self._unpin(victim)
            freed += 1
        return freed

    def table(self) -> np.ndarray:
        """The ``[slots, pages_per_slot]`` int32 device table; unmapped
        entries point at the garbage page."""
        t = np.full((self.slots, self.cfg.pages_per_slot), GARBAGE_PAGE,
                    np.int32)
        for s, pages in enumerate(self._owned):
            t[s, : len(pages)] = pages
        return t


# ---------------------------------------------------------------------------
# Device-side accessors (torch, on this rank's local pool shard).
# ---------------------------------------------------------------------------


def gather_pages(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Materialize each slot's mapped positions from the pool.

    pages [num_pages, page, ...feat]; table [B, mp] ->
    [B, mp * page, ...feat].  Unmapped entries read the garbage page;
    callers mask those positions by the slot's length, so the values never
    reach a softmax unmasked.
    """
    g = pages[table.long()]                       # [B, mp, page, ...]
    return g.reshape((table.shape[0], table.shape[1] * pages.shape[1])
                     + tuple(pages.shape[2:]))


def append_tokens(pages: torch.Tensor, table: torch.Tensor,
                  start: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Scatter per-slot token runs into the pool through the page table.

    pages [num_pages, page, ...feat]; table [B, mp]; start [B] (each
    slot's first logical position for this run); values [B, s, ...feat].
    Position p of slot b lands in physical page ``table[b, p // page]`` at
    offset ``p % page``.  Writes beyond a slot's valid length land on pages
    that are overwritten by the same slot's next tokens or on the garbage
    page — never read unmasked.

    Unlike the JAX version, which returns a new pool, this writes IN PLACE
    into ``pages`` (``index_put_``): a serving step owns its pools, and a
    copy of a multi-gigabyte pool per layer per step would dominate the
    step.  Returns ``pages``.
    """
    B, s = values.shape[:2]
    page = pages.shape[1]
    pos = start.long()[:, None] + torch.arange(s, device=start.device)[None, :]
    logical = pos // page
    mp = table.shape[1]
    # positions past the table width scatter to the garbage page
    phys = torch.where(
        logical < mp,
        torch.gather(table.long(), 1, logical.clamp(max=mp - 1)),
        torch.full_like(logical, GARBAGE_PAGE))
    pages.index_put_((phys, pos % page), values.to(pages.dtype))
    return pages
