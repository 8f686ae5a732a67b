"""Kernel dispatch, launch plans and launch counters.

Each wrapper takes the plain version (``kernels.ref``) for a tensor on the
CPU, launches its hand-written kernel for a tensor on a CUDA device, and
raises for anything the kernel does not take.  There is no fallback from
the kernel to the plain version.

``LAUNCHES`` counts kernel launches per wrapper: it grows by one where a
kernel is launched and nowhere else, so a run can show that its path went
through the kernels (``reset_launches`` before, read after).  A stream-K
matmul and a split-KV attention merge their splits inside the same launch,
so each call is still one launch; ``ATTENTION_VARIANT_LAUNCHES`` splits
the attention's count by the kernel it launched (``attention_plan``'s
variant: the serving kernel or the training one).  ``BACKWARD_LAUNCHES``
counts the backward kernels the same way: each matmul backward launches the
matmul kernel twice (dgrad and wgrad), the flash-attention, rmsnorm (block
norm or grouped, gated norm) and SSD-scan backward wrappers one C entry
each, and ``activation_backward`` (a fused activation's derivative) one.
``SPLIT_LAUNCHES`` counts the split rmsnorm's four kernels (d2 > 1:
``split_rmsnorm``'s partial and apply pieces around the tp2 all-reduce,
forward and backward), one a wrapper call, and ``QUANT_LAUNCHES`` the
matmul's int8 ``scale`` mode (``matmul_int8``, ``csrc/matmul_int8.cu``).

Training: ``matmul``, ``flash_attention``, ``rmsnorm``, ``group_rmsnorm``
and ``ssd_scan`` are autograd Functions wherever an input requires grad
and grad mode is on; their backward runs ``matmul_backward`` (after
``activation_backward`` where the matmul fused an activation: its forward
then also writes the pre-activation), ``flash_attention_backward``,
``rmsnorm_backward``,
``group_rmsnorm_backward`` and ``ssd_scan_backward``, which launch the
backward kernels on CUDA tensors and take the plain backward versions
(``kernels.ref``) on the CPU.  With no grad (serving) each wrapper
launches exactly what it launched before, and the attention writes no
log-sum-exp.

``matmul_plan``, ``attention_plan``, ``attention_bwd_plan``,
``rmsnorm_plan``, ``group_rmsnorm_bwd_plan``, ``ssd_plan`` and
``ssd_bwd_plan`` choose the CUDA kernels' tiles and splits from the shapes
alone; they are plain Python, so the CPU tests check them.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq

import torch

from repro_torch.kernels import ref

LAUNCHES = {"matmul": 0, "flash_attention": 0, "rmsnorm": 0, "ssd_scan": 0}
BACKWARD_LAUNCHES = {"matmul_bwd": 0, "flash_attention_bwd": 0,
                     "rmsnorm_bwd": 0, "group_rmsnorm_bwd": 0,
                     "ssd_scan_bwd": 0, "matmul_act_bwd": 0}

#: launches of the split rmsnorm's four kernels (d2 > 1), by wrapper
SPLIT_LAUNCHES = {"rmsnorm_ss": 0, "rmsnorm_apply": 0,
                  "rmsnorm_bwd_partial": 0, "rmsnorm_bwd_apply": 0}

#: launches of the matmul's int8 ``scale`` mode
QUANT_LAUNCHES = {"matmul_int8": 0}

#: the flash-attention launches of ``LAUNCHES`` by ``attention_plan``
#: variant (0: ``flash_attention.cu``, 1: ``flash_attention_train.cu``)
ATTENTION_VARIANT_LAUNCHES = [0, 0]

_ACTIVATIONS = {None: 0, "gelu": 1, "silu": 2}

#: streaming multiprocessors of the H100 the plans fill
SMS = 132


def reset_launches() -> None:
    for counts in (LAUNCHES, BACKWARD_LAUNCHES, SPLIT_LAUNCHES,
                   QUANT_LAUNCHES):
        for k in counts:
            counts[k] = 0
    ATTENTION_VARIANT_LAUNCHES[:] = [0, 0]


def _grad(*ts) -> bool:
    """Whether the call is on an autograd path: grad mode on and some input
    requiring grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts if t is not None}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"}:
        raise ValueError(f"tensors must all lie on the CPU or all on one CUDA "
                         f"device, got {sorted(devs)}")
    return False


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s device (as Triton's
    launcher reads it), without building a Stream object every launch."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _ptr(t):
    """A tensor's address for a ``c_void_p`` argument (None: NULL)."""
    return None if t is None else t.data_ptr()


_COUNTERS: dict[tuple, torch.Tensor] = {}
#: buffers a larger one replaced: a captured CUDA graph may still read them
_RETIRED: list[torch.Tensor] = []


def _counters(t: torch.Tensor, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 arrival counters for the split kernels on
    ``t``'s device and current stream.  The kernel's last-arriving block
    resets each counter it used, so the buffer stays zero between launches
    (and between replays of a captured graph); a launch that is refused ran
    no block and leaves it as it was.  A buffer is never freed, since a
    graph captured on its stream holds its address.  A graph capture must
    find its stream's buffer made (``launch.steps.CapturedStep`` runs the
    body on the capture stream first)."""
    key = (t.device, _stream(t))
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _RETIRED.append(buf)
        size = max(n, 2 * (0 if buf is None else buf.numel()), 1024)
        buf = _COUNTERS[key] = torch.zeros(size, dtype=torch.int32,
                                           device=t.device)
    return buf


def _launch(fn, args, what: str, counters) -> None:
    err = fn(*args)
    if err != 0 and counters is not None:
        counters.zero_()
    _check(err, what)


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """A launch of the CUDA matmul: output tiles of ``bm x bn`` (``variant``,
    the index into ``MATMUL_VARIANTS`` the C entry takes), K steps of
    ``bk``, and ``blocks`` blocks.  The first ``whole`` tiles (variant 2
    only) are finished whole, block p taking tiles p, p + blocks, ...; the
    ``(tiles - whole) * kt`` (tile, K step) units of the others are cut into
    equal runs, tile-major (stream-K): block p takes units
    ``[p * W // blocks, (p + 1) * W // blocks)``, as the kernel cuts them."""
    variant: int
    bm: int
    bn: int
    bk: int
    tiles: int
    kt: int
    blocks: int
    whole: int = 0

    @property
    def name(self) -> str:
        return f"{self.bm}x{self.bn} {MATMUL_VARIANTS[self.variant][3]}"

    @property
    def _units(self) -> int:
        return (self.tiles - self.whole) * self.kt

    def _start(self, p: int) -> int:
        return p * self._units // self.blocks

    def _owner(self, u: int) -> int:
        return ((u + 1) * self.blocks - 1) // self._units

    def tile_runs(self, tile: int) -> list[tuple[int, int, int]]:
        """(block, first K step, end K step) of each block that works on
        ``tile``, in block order: the order the partials are summed in."""
        kt = self.kt
        if tile < self.whole:
            return [(tile % self.blocks, 0, kt)]
        t = tile - self.whole
        out = []
        for p in range(self._owner(t * kt), self._owner((t + 1) * kt - 1) + 1):
            u0 = max(self._start(p), t * kt)
            u1 = min(self._start(p + 1), (t + 1) * kt)
            out.append((p, u0 - t * kt, u1 - t * kt))
        return out

    @functools.cached_property
    def max_share(self) -> int:
        """The most blocks that work on one tile: the partials the merging
        block of that tile sums."""
        return max(len(self.tile_runs(t)) for t in range(self.whole,
                                                         self.tiles)) \
            if self.whole < self.tiles else 1


#: (bm, bn, bk, products) of each tile variant of ``csrc/matmul.cu``, in
#: its order
MATMUL_VARIANTS = ((16, 64, 64, "mma.sync"), (64, 128, 64, "wgmma"),
                   (128, 256, 64, "wgmma ws"))
#: the most blocks a plan puts on one SM (variants 0 and 1 fit two)
BLOCKS_PER_SM = 2
#: K steps each block must stream before a second block per SM pays for
#: the extra partial tiles it makes (measured: only the lm_head reaches it)
MIN_RUN = 128
#: a B this small stays in L2, so 16-row tiles of a prefill chunk may read
#: it once per row tile
SMALL_B_BYTES = 8 << 20
#: rows from which an ``[M, K] @ [K, N]`` takes variant 2 (a training
#: step's M = batch x sequence, its wgrad's M = K).  Measured at K = N =
#: 4096 on the H100: variant 2 ties variant 1 at M = 256 and is 1.5x
#: faster at 512; at M = 2048 it is 1.9-4.6x faster than variant 0 at
#: zamba2-7b's B|C|dt (N = 240), whose B stays in L2
TRAIN_M = 512
#: variant 2 cuts the tiles of a last, partial wave into stream-K runs only
#: where the wave leaves more than this share of the blocks idle
SPLIT_IDLE = 0.5


def _persistent_plan(M: int, N: int, K: int, sms: int) -> MatmulPlan:
    """Variant 2: one block per SM, each finishing whole tiles in waves
    (tile p + i * sms), the waves in lock step so that the tiles of a wave
    share their A and B stripes in L2.  A last wave that would leave more
    than ``SPLIT_IDLE`` of the blocks idle (fewer tiles than SMs included)
    is cut into stream-K runs over all blocks instead.  Splitting a fuller
    last wave would gain at most a few per cent, and its runs start at
    staggered K steps, so the blocks would stop sharing stripes in L2."""
    bm, bn, bk, _ = MATMUL_VARIANTS[2]
    tiles, kt = -(-M // bm) * -(-N // bn), -(-K // bk)
    rest = tiles % sms
    split = rest > 0 and sms - rest > SPLIT_IDLE * sms and (
        rest == tiles or rest * kt >= sms)   # every run holds a unit
    if not split:
        return MatmulPlan(2, bm, bn, bk, tiles, kt, min(sms, tiles), tiles)
    return MatmulPlan(2, bm, bn, bk, tiles, kt, min(sms, rest * kt),
                      tiles - rest)


@functools.lru_cache(maxsize=None)
def matmul_plan(M: int, N: int, K: int, sms: int = SMS, *,
                a_trans: bool = False) -> MatmulPlan:
    """The tile variant and the grid of an ``[M, K] @ [K, N]``.

    M <= 16 (decode rows) takes the 16x64 mma.sync tiles, and so does a
    larger M where B is small (it stays in L2 for the other row tiles);
    a prefill chunk otherwise takes the 64x128 wgmma tiles.  Their blocks
    take equal runs of (tile, K step) units, so every SM streams the same
    share of B whatever the tile count, with no second wave: one block per
    SM, or two where each still streams ``MIN_RUN`` K steps.  From
    ``TRAIN_M`` rows (the training step), and wherever A is read
    transposed (wgrad), variant 2 takes it (``_persistent_plan``)."""
    if a_trans or M >= TRAIN_M:
        return _persistent_plan(M, N, K, sms)
    small_b = 2 * K * N <= SMALL_B_BYTES
    return _stream_k_plan(M, N, K, sms, 0 if M <= 16 or small_b else 1)


@functools.lru_cache(maxsize=None)
def _stream_k_plan(M: int, N: int, K: int, sms: int,
                   variant: int) -> MatmulPlan:
    """Variant 0 or 1 over equal runs of every (tile, K step) unit."""
    bm, bn, bk, _ = MATMUL_VARIANTS[variant]
    tiles, kt = -(-M // bm) * -(-N // bn), -(-K // bk)
    per_sm = BLOCKS_PER_SM
    while per_sm > 1 and tiles * kt < per_sm * sms * MIN_RUN:
        per_sm -= 1
    return MatmulPlan(variant, bm, bn, bk, tiles, kt,
                      min(per_sm * sms, tiles * kt))


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """A CUDA flash-attention launch.  Variant 0 (``flash_attention.cu``,
    the serving kernel): ``row_tiles`` tiles of ``rows`` (q row x q head of
    a GQA group) per (batch row, kv head), and the keys cut into ``splits``
    ranges of ``tiles_per_split`` tiles of ``bkv``.  Variant 1
    (``flash_attention_train.cu``, the training regime): ``row_tiles``
    tiles of 128 positions of one q head, keys in one range of tiles of
    128; its blocks take the work items of ``attention_train_schedule``."""
    row_tiles: int
    splits: int
    tiles_per_split: int
    rows: int = 64
    bkv: int = 64
    variant: int = 0

    def key_ranges(self, skv: int) -> list[tuple[int, int]]:
        span = self.tiles_per_split * self.bkv
        return [(s * span, min(skv, (s + 1) * span))
                for s in range(self.splits)]


#: the most splits the attention kernel merges
MAX_KV_SPLITS = 32
#: the head dims variant 1 takes (112 padded to 128 by its loads); 64
#: (qwen1.5) stays on variant 0
TRAIN_HEAD_DIMS = (112, 128)


def attention_plan(b: int, sq: int, hq: int, hkv: int, skv: int,
                   sms: int = SMS, *, d: int = 128) -> AttentionPlan:
    """Variant 1 where no key split is wanted, there are at least
    ``ref.TRAIN_TILE`` q rows and the head dim is one of ``TRAIN_HEAD_DIMS``
    (the training regime: s = 2048 and the like); else variant 0
    (``split_plan``: every serving shape, a 64-row prefill chunk or a
    decode tick)."""
    plan = split_plan(b, sq, hq, hkv, skv, sms)
    tile = ref.TRAIN_TILE
    if plan.splits == 1 and sq >= tile and d in TRAIN_HEAD_DIMS:
        return AttentionPlan(-(-sq // tile), 1, -(-skv // tile), tile, tile,
                             1)
    return plan


def split_plan(b: int, sq: int, hq: int, hkv: int, skv: int,
               sms: int = SMS) -> AttentionPlan:
    """Variant 0: row tiles of 64 (q row x q head of the group, heads
    innermost) per (batch row, kv head); then, where those blocks fill less
    than half the card, split the keys (flash-decoding) into ranges of
    whole 64-key tiles, as many as it takes to cover ``sms`` SMs.  A split
    costs a partial write and a merge of a few microseconds, so it must
    carry at least one key tile for a row tile of at most 16 rows (a decode
    tick: one warp's product per key tile) and four for a fuller one."""
    rows = sq * (hq // hkv)
    row_tiles = -(-rows // 64)
    kv_tiles = -(-skv // 64)
    base = b * hkv * row_tiles
    splits = 1
    if 2 * base <= sms:
        per_split = 1 if rows <= 16 else 4
        splits = max(1, min(kv_tiles // per_split, -(-sms // base),
                            MAX_KV_SPLITS))
    per = -(-kv_tiles // splits)
    return AttentionPlan(row_tiles, -(-kv_tiles // per), per)


@dataclasses.dataclass(frozen=True)
class AttentionTrainSchedule:
    """Variant 1's work items dealt to its persistent blocks.  An item is
    row tile t of q head h of batch row bi, numbered ``(bi * hq + h) *
    row_tiles + t``; ``blocks[c]`` lists block c's items in the order it
    takes them."""
    hq: int
    row_tiles: int
    blocks: tuple

    def item(self, i: int) -> tuple[int, int, int]:
        """(batch row, q head, row tile) of item number ``i``."""
        bh, t = divmod(i, self.row_tiles)
        return bh // self.hq, bh % self.hq, t

    def flat(self) -> list[int]:
        """The kernel's ``sched``: ``len(blocks) + 1`` offsets into the
        items that follow, then every block's items."""
        offsets = [0]
        for items in self.blocks:
            offsets.append(offsets[-1] + len(items))
        return offsets + [i for items in self.blocks for i in items]


#: the K/V bytes of the kv heads whose items variant 1's schedule runs
#: together, so that their K/V stay in the L2 (50 MB, in two halves, which
#: Q and O stream through) while every row tile reads them
TRAIN_L2_BYTES = 8 << 20


@functools.lru_cache(maxsize=None)
def attention_train_schedule(b: int, sq: int, hq: int, hkv: int, skv: int,
                             causal: bool = True, window: int = 0,
                             sms: int = SMS) -> AttentionTrainSchedule:
    """Every (batch row, q head, row tile) once, dealt to the block with
    the least work so far (the lowest-numbered of equals).  The items run
    in groups of (batch row, kv head) whose K/V (the head dim padded to
    128) fit ``TRAIN_L2_BYTES``; inside a group longest first -- the cost of
    an item is its key tiles at q_offset 0 and kv_len ``skv``, plus one for
    its Q load and store -- then by row tile, the q heads of a kv group next
    to each other.  At llama3-8b's s = 2048 (one group) that is 512 items of
    2 to 17 units on 132 blocks of 35 to 38 units."""
    row_tiles, grp = -(-sq // ref.TRAIN_TILE), hq // hkv
    cost = [len(ref.train_key_tiles(t, 0, skv, sq, skv, causal, window)) + 1
            for t in range(row_tiles)]
    per_group = max(1, TRAIN_L2_BYTES // (2 * skv * ref.TRAIN_TILE * 2))

    def order(i):
        bh, t = divmod(i, row_tiles)
        bi, h = divmod(bh, hq)
        return ((bi * hkv + h // grp) // per_group, -cost[t], bi, t, h)

    items = sorted(range(b * hq * row_tiles), key=order)
    n = min(sms, len(items))
    loads = [(0, c) for c in range(n)]
    blocks = [[] for _ in range(n)]
    for i in items:
        load, c = heapq.heappop(loads)
        blocks[c].append(i)
        heapq.heappush(loads, (load + cost[i % row_tiles], c))
    return AttentionTrainSchedule(hq, row_tiles,
                                  tuple(tuple(x) for x in blocks))


@functools.lru_cache(maxsize=64)
def _train_sched(b, sq, hq, hkv, skv, causal, window, device):
    """``attention_train_schedule`` as the kernel reads it (int32 on
    ``device``, made once per shape) and its block count."""
    sched = attention_train_schedule(b, sq, hq, hkv, skv, causal, window)
    return (torch.tensor(sched.flat(), dtype=torch.int32).to(device),
            len(sched.blocks))


#: keys of a dK/dV block's key tile (its warpgroup's K and V)
BWD_KEYS = 64


def bwd_visible_tiles(key_tile: int, q_offset: int, kv_len: int, sq: int,
                      grp: int, causal: bool, window: int) -> tuple[int, int]:
    """The row tiles ``[t0, t1)`` of one (batch row, kv head) that see a key
    of ``key_tile`` (``BWD_KEYS`` keys), as the backward kernel computes
    them: row tile t is q positions ``[64 (t // grp), +64)`` of the group's
    q head ``t % grp``, so a key tile sees whole position tiles of every
    head."""
    k0 = BWD_KEYS * key_tile
    k1 = min(k0 + BWD_KEYS - 1, kv_len - 1)
    p_lo, p_hi = 0, sq - 1
    if causal:
        p_lo = max(p_lo, k0 - q_offset)
    if window > 0:
        p_hi = min(p_hi, k1 + window - 1 - q_offset)
    if k0 > k1 or p_lo > p_hi:
        return 0, 0
    return p_lo // 64 * grp, (p_hi // 64 + 1) * grp


@dataclasses.dataclass(frozen=True)
class AttentionBwdPlan:
    """The dK/dV schedule of the CUDA attention backward.

    Per (batch row, kv head) ``bh``, the q rows are ``row_tiles`` tiles of
    64 positions of one q head (``bwd_visible_tiles``) and the keys
    ``key_tiles`` tiles of ``BWD_KEYS``.  The row tiles a key tile sees at
    q_offset 0 and kv_len skv are cut into ``parts`` items of nearly equal
    length, at most ``max_len``; ``items`` lists every item, longest first, as (bh,
    key tile, first row tile, end row tile, part, parts, first slot), and
    ``blocks`` persistent blocks take them in that order from a shared
    ticket.  A key tile of several parts has its fp32 dK/dV partials in
    workspace slots ``first slot + part``; the last part to arrive sums
    them in part order.  The kernel clips each item to the tiles the key
    tile sees for the real offsets and lengths, with its first part
    reaching down to row tile 0 and its last up to ``row_tiles``
    (``walk``), so any offsets are covered."""
    grp: int
    hkv: int
    row_tiles: int
    key_tiles: int
    max_len: int
    items: tuple
    slots: int
    blocks: int

    def lengths(self) -> list[int]:
        return [r1 - r0 for _, _, r0, r1, *_ in self.items]

    def walk(self, sq: int, q_offset, kv_len, causal: bool = True,
             window: int = 0):
        """Per item, in ``items`` order: the (bh, key tile, part, row
        tiles) the kernel walks for per-batch-row ``q_offset`` and
        ``kv_len`` (sequences of ints)."""
        for bh, kt, r0, r1, part, parts, _ in self.items:
            b = bh // self.hkv
            v0, v1 = bwd_visible_tiles(kt, int(q_offset[b]), int(kv_len[b]),
                                       sq, self.grp, causal, window)
            lo = max(v0, 0 if part == 0 else r0)
            hi = min(v1, self.row_tiles if part == parts - 1 else r1)
            yield bh, kt, part, list(range(lo, max(lo, hi)))


#: the backward kernels' blocks per SM (shared memory holds two)
BWD_BLOCKS_PER_SM = 2
#: items a block takes, on the mean: two, so that the shortest items,
#: taken last, even out the blocks' ends
BWD_ITEMS_PER_BLOCK = 2
#: the shortest item a key tile is cut into (a partial costs a 64 KB write
#: and read)
BWD_MIN_ITEM = 8


@functools.lru_cache(maxsize=None)
def attention_bwd_plan(b: int, sq: int, hq: int, hkv: int, skv: int,
                       causal: bool = True, window: int = 0,
                       sms: int = SMS) -> AttentionBwdPlan:
    """Items of at most ``max_len`` row tiles, ``max_len`` chosen so that
    the blocks (two per SM) take about ``BWD_ITEMS_PER_BLOCK`` items each;
    a key tile that sees ``n`` row tiles is cut into ``ceil(n / max_len)``
    parts of nearly equal length.  At llama3-8b's s = 2048 (32 key tiles,
    128 row tiles, key tile j sees 128 - 4 j) that is items of 32 or fewer
    row tiles instead of one block walking 128 while another walks 4."""
    grp = hq // hkv
    row_tiles, key_tiles = -(-sq // 64) * grp, -(-skv // BWD_KEYS)
    spans = [bwd_visible_tiles(kt, 0, skv, sq, grp, causal, window)
             for kt in range(key_tiles)]
    total = b * hkv * sum(t1 - t0 for t0, t1 in spans)
    workers = BWD_BLOCKS_PER_SM * sms
    max_len = max(BWD_MIN_ITEM, -(-total // (BWD_ITEMS_PER_BLOCK * workers)))
    items, slots = [], 0
    for bh in range(b * hkv):
        for kt, (t0, t1) in enumerate(spans):
            n = t1 - t0
            parts = max(1, -(-n // max_len))
            for p in range(parts):
                items.append((bh, kt, t0 + n * p // parts,
                              t0 + n * (p + 1) // parts, p, parts,
                              slots if parts > 1 else -1))
            slots += parts if parts > 1 else 0
    items.sort(key=lambda it: (it[2] - it[3], it[0], it[1], it[4]))
    return AttentionBwdPlan(grp, hkv, row_tiles, key_tiles, max_len,
                            tuple(items), slots, min(workers, len(items)))


@functools.lru_cache(maxsize=64)
def _bwd_items(b, sq, hq, hkv, skv, causal, window, device) -> torch.Tensor:
    """``attention_bwd_plan``'s items as the kernel reads them: int32
    ``[items, 8]`` on ``device``, made once per shape."""
    plan = attention_bwd_plan(b, sq, hq, hkv, skv, causal, window)
    rows = [list(it) + [0] for it in plan.items]
    return torch.tensor(rows, dtype=torch.int32).to(device)


def matmul(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
           *, activation: str | None = None) -> torch.Tensor:
    """``a [..., K] @ b [K, N]`` (+ bias [N], then gelu-tanh or silu).

    On CUDA: bf16 operands; ``b`` row-major ``[K, N]`` or the transpose of
    a row-major ``[N, K]`` (a tied embedding used as the head), read
    without a copy."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if _grad(a, b, bias):
        return _Matmul.apply(a, b, bias, activation)
    return _matmul(a, b, bias, activation)


def _matmul(a, b, bias, activation, counts=LAUNCHES, key="matmul", *,
            z_out: bool = False):
    """``matmul`` off the autograd path; a launch counts under
    ``counts[key]``.  ``a`` may also be the transpose of a row-major
    ``[K, M]`` (wgrad's ``a^T``), read without a copy.  ``z_out``: returns
    ``(y, z)``, the same launch also writing the pre-activation ``z``
    (bias added, no activation; bit for bit the output of a launch with
    no activation) for the activation's derivative."""
    if _on_cpu(a, b, bias):
        if z_out:
            return ref.matmul_aux_ref(a, b, bias, activation)
        return ref.matmul_ref(a, b, bias, activation)
    from repro_torch.kernels import _build

    if z_out and activation is None:
        raise ValueError("z_out needs an activation: without one z is y")
    lead, K = a.shape[:-1], a.shape[-1]
    if b.dim() != 2 or b.shape[0] != K:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    N = b.shape[1]
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or (
            bias is not None and bias.dtype != torch.bfloat16):
        raise TypeError("the CUDA matmul takes bf16 operands (int8 ones "
                        "take matmul_int8)")
    if bias is not None and (bias.shape != (N,) or not bias.is_contiguous()):
        raise ValueError(f"bias must be contiguous [{N}]")
    if b.is_contiguous():
        b_trans = 0
    elif b.stride() == (1, K):
        b_trans = 1
    else:
        raise ValueError("b must be row-major [K, N] or the transpose of a "
                         "row-major [N, K]")
    a_trans = int(a.dim() == 2 and not a.is_contiguous()
                  and a.stride() == (1, a.shape[0]))
    if a_trans and b_trans:
        raise ValueError("a and b may not both be transposed views")
    a2 = a if a_trans else a.reshape(-1, K).contiguous()
    M = a2.shape[0]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    z = torch.empty_like(out) if z_out else None
    if M == 0:
        return (out.reshape(*lead, N), z.reshape(*lead, N)) if z_out else \
            out.reshape(*lead, N)
    vec = int((M % 8 == 0 if a_trans else K % 8 == 0)
              and (K % 8 == 0 if b_trans else N % 8 == 0)
              and a2.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    plan = matmul_plan(M, N, K, a_trans=bool(a_trans))
    if z_out and (a_trans or b_trans):
        raise ValueError("the pre-activation output takes a row-major a and "
                         "b (no tied head or wgrad has an activation)")
    if plan.variant == 2 and not vec:
        # variant 2 reads by TMA only: rows TMA cannot read take variant 1's
        # element loads, A transposed by a copy (no model width needs this)
        if a_trans:
            a2, a_trans = a2.contiguous(), 0
        plan = _stream_k_plan(M, N, K, SMS, 1)
    ws = counters = None
    if plan.max_share > 1:   # some tile is shared
        ws = torch.empty(2 * plan.blocks * plan.bm * plan.bn,
                         dtype=torch.float32, device=a.device)
        counters = _counters(a, plan.tiles)
    # the instances that write z are a library of their own
    _launch(_build.entry("matmul_z" if z_out else "matmul"),
            (_ptr(a2), _ptr(b), _ptr(bias), _ptr(out), _ptr(z), _ptr(ws),
             _ptr(counters), M, N, K, a_trans, b_trans,
             _ACTIVATIONS[activation], vec, plan.variant, plan.blocks,
             plan.whole, _stream(a)), "matmul", counters)
    counts[key] += 1
    if z_out:
        return out.reshape(*lead, N), z.reshape(*lead, N)
    return out.reshape(*lead, N)


def quantize_for_matmul(x: torch.Tensor, qmax: float = 127.0):
    """Tensor-wise symmetric int8 quantization for :func:`matmul_int8`
    (``repro.kernels.matmul.quantize_for_matmul``): ``(q int8, scale)``,
    an f32 scalar with ``q * scale ~= x``, rounded half to even.  The
    scale is ``amax`` times the f32 reciprocal of ``qmax``, the bits of
    the reference's compiled function (XLA folds its division by the
    constant into that multiplication)."""
    xf = x.float()
    inv = torch.tensor(1.0 / qmax, dtype=torch.float32, device=x.device)
    scale = torch.clamp_min(xf.abs().amax() * inv, 1e-12)
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def matmul_int8(a: torch.Tensor, b: torch.Tensor,
                bias: torch.Tensor | None = None, *, scale,
                activation: str | None = None,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """The matmul's int8 ``scale`` mode: int8 ``a [..., K] @ b [K, N]``,
    the products summed in int32, then ``scale`` (the f32 ``a_scale *
    b_scale``; a tensor is read on the host), then bias [N], then
    gelu-tanh or silu, as ``out_dtype`` (bf16 or f32).  No autograd.  On
    CUDA: row-major ``b``, a bf16 bias, K a multiple of 16 and N of 4;
    one launch of
    ``csrc/matmul_int8.cu``, counted in ``QUANT_LAUNCHES``."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("matmul_int8 takes int8 operands")
    if _on_cpu(a, b, bias):
        return ref.matmul_int8_ref(a, b, bias, scale=scale,
                                   activation=activation, out_dtype=out_dtype)
    from repro_torch.kernels import _build

    lead, K = a.shape[:-1], a.shape[-1]
    if b.dim() != 2 or b.shape[0] != K:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    N = b.shape[1]
    if K % 16 or N % 4:
        raise ValueError(f"matmul_int8 takes K % 16 == 0 and N % 4 == 0, got "
                         f"K={K}, N={N}")
    if bias is not None and (bias.shape != (N,) or not bias.is_contiguous()
                             or bias.dtype != torch.bfloat16):
        raise ValueError(f"bias must be contiguous bf16 [{N}]")
    a2, b = a.reshape(-1, K).contiguous(), b.contiguous()
    M = a2.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0:
        return out.reshape(*lead, N)
    if a2.data_ptr() % 16 or b.data_ptr() % 4:
        raise ValueError("matmul_int8 needs a 16-byte aligned a")
    _launch(_build.entry("matmul_int8"),
            (_ptr(a2), _ptr(b), _ptr(bias), _ptr(out), M, N, K,
             float(scale), _ACTIVATIONS[activation],
             int(out_dtype == torch.float32), 64 if M <= 64 else 128,
             _stream(a)), "matmul_int8", None)
    QUANT_LAUNCHES["matmul_int8"] += 1
    return out.reshape(*lead, N)


def matmul_backward(a: torch.Tensor, b: torch.Tensor, dz: torch.Tensor, *,
                    need_a: bool = True, need_b: bool = True):
    """The backward of ``a [M, K] @ b [K, N]`` for the gradient ``dz [M, N]``
    of its pre-activation output: ``(dz @ b^T, a^T @ dz)`` (None where not
    needed).  On CUDA, two launches of the matmul kernel: dgrad reads ``b``
    transposed, as a tied head does; wgrad reads ``a`` transposed, straight
    from the row-major activation (no copy of ``a^T``)."""
    if _on_cpu(a, b, dz):
        da, db = ref.matmul_bwd_ref(a, b, dz)
        return (da if need_a else None), (db if need_b else None)
    dz = dz.contiguous()
    key = "matmul_bwd"
    da = _matmul(dz, b.t(), None, None, BACKWARD_LAUNCHES, key) if need_a \
        else None
    db = _matmul(a.contiguous().t(), dz, None, None, BACKWARD_LAUNCHES,
                 key) if need_b else None
    return da, db


def activation_backward(dy: torch.Tensor, z: torch.Tensor,
                        activation: str | None) -> torch.Tensor:
    """``dy * act'(z)`` in fp32, cast to ``dy.dtype``: the gradient through
    the matmul epilogue's activation at its pre-activation ``z`` (what
    ``_matmul(..., z_out=True)`` wrote).  With no activation it is ``dy``
    and nothing launches.  On CUDA one launch of ``csrc/act_bwd.cu`` (bf16
    ``dy`` and ``z`` of one shape), counted under
    ``BACKWARD_LAUNCHES["matmul_act_bwd"]``."""
    if activation is None:
        return dy
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if _on_cpu(dy, z):
        return ref.epilogue_bwd(z, dy, activation)
    from repro_torch.kernels import _build

    if dy.shape != z.shape:
        raise ValueError(f"dy {tuple(dy.shape)} and z {tuple(z.shape)} differ")
    if dy.dtype != torch.bfloat16 or z.dtype != torch.bfloat16:
        raise TypeError("the activation's derivative takes bf16 dy and z")
    dy, z = dy.contiguous(), z.contiguous()
    dz = torch.empty_like(dy)
    if dz.numel() == 0:
        return dz
    vec = int(all(t.data_ptr() % 16 == 0 for t in (dy, z, dz)))
    _launch(_build.entry("act_bwd"),
            (_ptr(dy), _ptr(z), _ptr(dz), dz.numel(),
             _ACTIVATIONS[activation], vec, SMS, _stream(dy)), "act_bwd", None)
    BACKWARD_LAUNCHES["matmul_act_bwd"] += 1
    return dz


class _Matmul(torch.autograd.Function):
    """``matmul`` with its backward.  With a fused activation the forward's
    one launch also writes the pre-activation ``z`` (bias added), kept for
    the backward, whose ``activation_backward`` takes the activation's
    derivative at it before the matmul's backward."""

    @staticmethod
    def forward(ctx, a, b, bias, activation):
        if activation is None:
            y, z = _matmul(a, b, bias, None), None
        else:
            y, z = _matmul(a, b, bias, activation, z_out=True)
        ctx.save_for_backward(a, b, z)
        ctx.activation = activation
        return y

    @staticmethod
    def backward(ctx, dy):
        a, b, z = ctx.saved_tensors
        dz = activation_backward(dy, z, ctx.activation)
        N = b.shape[1]
        dz2 = dz.reshape(-1, N)
        need_a, need_b, need_bias = ctx.needs_input_grad[:3]
        da, db = matmul_backward(a.reshape(-1, a.shape[-1]), b, dz2,
                                 need_a=need_a, need_b=need_b)
        dbias = dz2.float().sum(0).to(dz.dtype) if need_bias else None
        return (None if da is None else da.reshape(a.shape)), db, dbias, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: torch.Tensor, kv_len: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q [b, sq, hq, d]; k/v [b, skv, hkv, d]; q_offset/kv_len [b] int.

    Query row i of batch row b sits at position ``q_offset[b] + i`` and sees
    keys ``j < kv_len[b]`` with ``j <= qpos`` (causal) and
    ``j > qpos - window`` (window > 0).  Scale 1/sqrt(d), optional tanh
    softcap.  GQA maps q head h to kv head ``h // (hq // hkv)``."""
    if _grad(q, k, v):
        return _FlashAttention.apply(q, k, v, q_offset, kv_len, causal,
                                     window, softcap)
    if _on_cpu(q, k, v, q_offset, kv_len):
        return ref.attention_ref(q, k, v, q_offset, kv_len, causal=causal,
                                 window=window, softcap=softcap)
    return _flash(*_flash_inputs(q, k, v, q_offset, kv_len), causal, window,
                  softcap)[0]


def _flash_inputs(q, k, v, q_offset, kv_len):
    """The CUDA attention's inputs, checked: contiguous 16-byte-aligned
    bf16 q/k/v (a copy where they are not) and int32 q_offset/kv_len."""
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
    # the kernel copies 16-byte chunks: contiguous, 16-byte-aligned bases
    q, k, v = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    qo = q_offset.to(torch.int32).contiguous()
    kl = kv_len.to(torch.int32).contiguous()
    if qo.shape != (b,) or kl.shape != (b,):
        raise ValueError("q_offset and kv_len must be [b]")
    return q, k, v, qo, kl


def _flash(q, k, v, qo, kl, causal, window, softcap, lse: bool = False):
    """One launch of the CUDA attention on ``_flash_inputs``, the kernel of
    ``attention_plan``'s variant; returns (out, the fp32 [b, hq, sq]
    log-sum-exp or None)."""
    from repro_torch.kernels import _build

    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse_out = torch.empty((b, hq, sq), dtype=torch.float32,
                          device=q.device) if lse else None
    plan = attention_plan(b, sq, hq, hkv, skv, d=d)
    if plan.variant == 1:
        sched, blocks = _train_sched(b, sq, hq, hkv, skv, bool(causal),
                                     int(window), q.device)
        _launch(_build.entry("flash_attention_train"),
                (_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse_out),
                 _ptr(qo), _ptr(kl), _ptr(sched), b, sq, skv, hq, hkv, d,
                 int(causal), int(window), float(softcap), blocks,
                 _stream(q)), "flash_attention", None)
    else:
        ws_o = ws_lse = counters = None
        if plan.splits > 1:
            parts = b * hkv * plan.row_tiles * plan.splits * plan.rows
            ws_o = torch.empty(parts * d, dtype=torch.float32,
                               device=q.device)
            ws_lse = torch.empty(parts, dtype=torch.float32, device=q.device)
            counters = _counters(q, b * hkv * plan.row_tiles)
        _launch(_build.entry("flash_attention"),
                (_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse_out),
                 _ptr(qo), _ptr(kl), _ptr(ws_o), _ptr(ws_lse),
                 _ptr(counters), b, sq, skv, hq, hkv, d, int(causal),
                 int(window), float(softcap), plan.row_tiles, plan.splits,
                 plan.tiles_per_split, _stream(q)),
                "flash_attention", counters)
    LAUNCHES["flash_attention"] += 1
    ATTENTION_VARIANT_LAUNCHES[plan.variant] += 1
    return out, lse_out


def flash_attention_lse(q, k, v, q_offset, kv_len, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """``flash_attention``'s output and each row's fp32 log-sum-exp ``[b,
    hq, sq]`` of its scaled (softcapped) visible scores, -inf for a row
    with no visible key: what the backward reads.  One launch on CUDA."""
    if _on_cpu(q, k, v, q_offset, kv_len):
        return ref.attention_lse_ref(q, k, v, q_offset, kv_len, causal=causal,
                                     window=window, softcap=softcap)
    return _flash(*_flash_inputs(q, k, v, q_offset, kv_len), causal, window,
                  softcap, lse=True)


def flash_attention_backward(q, k, v, o, do, lse, q_offset, kv_len, *,
                             causal: bool = True, window: int = 0,
                             softcap: float = 0.0):
    """(dq, dk, dv) of ``flash_attention`` from its output ``o``, the output
    gradient ``do`` and the forward's fp32 ``lse [b, hq, sq]``.

    On CUDA: the inputs as ``flash_attention`` takes them, ``o``/``do``
    bf16 like q; one C entry (three kernels: each row's log-sum-exp and
    rowsum(dO o O) in tile order, dK/dV over ``attention_bwd_plan``'s
    items, dQ), summed in a fixed order: bitwise deterministic."""
    if _on_cpu(q, k, v, o, do, lse, q_offset, kv_len):
        return ref.attention_bwd_ref(q, k, v, o, do, lse, q_offset, kv_len,
                                     causal=causal, window=window,
                                     softcap=softcap)
    from repro_torch.kernels import _build

    grads = attention_backward_with(
        _build.entry("flash_attention_bwd"), q, k, v, o, do, lse, q_offset,
        kv_len, causal=causal, window=window, softcap=softcap)
    BACKWARD_LAUNCHES["flash_attention_bwd"] += 1
    return grads


def attention_backward_with(entry, q, k, v, o, do, lse, q_offset, kv_len, *,
                            causal: bool, window: int, softcap: float):
    """``flash_attention_backward``'s checks, workspaces and launch on CUDA
    tensors, through ``entry``: a C function with the arguments of
    ``csrc/flash_attention_bwd.cu``'s entry (this tree's, or an older
    build's for a before/after timing).  Counts no launch."""
    q, k, v, qo, kl = _flash_inputs(q, k, v, q_offset, kv_len)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or {o.dtype, do.dtype} != {
            torch.bfloat16}:
        raise ValueError(f"o and do must be bf16 {tuple(q.shape)}")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 [{b}, {hq}, {sq}]")
    o, do, lse = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (o, do, lse))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    plan = attention_bwd_plan(b, sq, hq, hkv, skv, bool(causal), int(window))
    items = _bwd_items(b, sq, hq, hkv, skv, bool(causal), int(window),
                       q.device)
    # per (q head, position) in tile order, positions padded to whole
    # tiles: log2(e) * lse and rowsum(dO o O)
    rows = -(-sq // 64) * 64
    ld = torch.empty((2, b, hq, rows), dtype=torch.float32, device=q.device)
    # fp32 dK/dV partials of a key tile: dK and dV, 64 keys x the head dim
    # padded to 64 or 128
    parts = torch.empty(max(plan.slots, 1) * 2 * BWD_KEYS *
                        (64 if d <= 64 else 128), dtype=torch.float32,
                        device=q.device)
    counters = _counters(q, 2 + b * hkv * plan.key_tiles)
    _launch(entry,
            (_ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do), _ptr(lse),
             _ptr(qo), _ptr(kl), _ptr(dq), _ptr(dk), _ptr(dv), _ptr(ld),
             _ptr(items), _ptr(parts), _ptr(counters), b, sq, skv, hq, hkv,
             d, int(causal), int(window), float(softcap), len(plan.items),
             plan.blocks, _stream(q)), "flash_attention_bwd", counters)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its backward: the forward also writes each
    row's log-sum-exp, which the backward reads."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_len, causal, window, softcap):
        opts = dict(causal=causal, window=window, softcap=softcap)
        out, lse = flash_attention_lse(q, k, v, q_offset, kv_len, **opts)
        ctx.save_for_backward(q, k, v, out, lse, q_offset, kv_len)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_offset, kv_len = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, do, lse,
                                              q_offset, kv_len, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def _aligned(t: torch.Tensor | None) -> torch.Tensor | None:
    """``t`` as the CUDA kernels copy it, 16 bytes at a time: unit stride
    along the last dim, the other strides multiples of 8 elements and a
    16-byte-aligned base (a contiguous copy where it is not)."""
    if t is None or (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
                     and all(st % 8 == 0 for st in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


#: the widest row the CUDA rmsnorm takes (its threads hold a row in
#: registers)
RMSNORM_MAX_WIDTH = 4096
#: (threads per row, 16-byte vectors per thread) of each variant of
#: ``csrc/rmsnorm.cu``, narrowest row first: rows of up to 64, 1024 and
#: 4096.  At most 4 vectors a thread: a 3584-wide row measured faster on
#: 128 threads of 4 vectors than on one warp of 16.
RMSNORM_VARIANTS = ((8, 1), (32, 4), (128, 4))
#: the most threads of a block
RMSNORM_MAX_THREADS = 256
#: rows the rmsnorm backward's block takes at a time (4 warps each)
RMSNORM_BWD_ROWS = 3


def rmsnorm_bwd_blocks(rows: int) -> int:
    """The grid of ``csrc/rmsnorm.cu``'s backward kernel (the whole row's
    and the split norm's two backward pieces): 4 warps a row, 3 rows a
    block at a time, one block of 12 warps per SM."""
    return min(-(-rows // RMSNORM_BWD_ROWS), SMS)


@dataclasses.dataclass(frozen=True)
class RmsnormPlan:
    """A CUDA rmsnorm launch: ``threads`` per row, each holding ``vectors``
    16-byte pieces (8 values) of it, and ``rows`` rows a block."""
    threads: int
    vectors: int
    rows: int

    @property
    def name(self) -> str:
        return (f"{self.threads} threads x {self.vectors} vectors a row, "
                f"{self.rows} rows a block")


@functools.lru_cache(maxsize=None)
def rmsnorm_plan(rows: int, width: int, sms: int = SMS) -> RmsnormPlan:
    """Threads per row: the first variant that holds a row of ``width`` (8
    lanes for a 64-wide row of the grouped norm, 32 threads up to 1024, 128
    for a block norm's 3584 or 4096); rows per block: a power of two, no
    more than keeps ``sms`` blocks busy, in whole warps (the shuffles name
    all 32 lanes)."""
    nvec = -(-width // 8)
    threads, vectors = next((t, v) for t, v in RMSNORM_VARIANTS
                            if t * v >= nvec)
    per_block = 1
    while (2 * per_block * threads <= RMSNORM_MAX_THREADS
           and (2 * per_block * sms <= rows or per_block * threads < 32)):
        per_block *= 2
    return RmsnormPlan(threads, vectors, per_block)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6):
    """Per row of ``x [..., h]`` in fp32: ``x * rsqrt(mean(x^2)+eps) * gamma``
    (gamma already resolved), cast back to ``x.dtype``.

    On CUDA: bf16 x, fp32 gamma, h a multiple of 8 up to
    ``RMSNORM_MAX_WIDTH``."""
    if _grad(x, gamma):
        return _RmsNorm.apply(x, gamma, eps)
    return _rmsnorm(x, gamma, eps)


def _rmsnorm(x, gamma, eps):
    if _on_cpu(x, gamma):
        return ref.rmsnorm_ref(x, gamma, eps)
    h = x.shape[-1]
    if gamma.shape != (h,):
        raise ValueError(f"gamma must be [{h}], got {tuple(gamma.shape)}")
    return _norm(x.reshape(-1, h), gamma.view(1, h), None, eps).reshape(
        x.shape)


def rmsnorm_backward(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                     *, eps: float = 1e-6):
    """(dx, dgamma) of ``rmsnorm`` for the output gradient ``dy``.

    On CUDA: bf16 x and dy, fp32 gamma [h], h a multiple of 8 up to
    ``RMSNORM_MAX_WIDTH``; one C entry (the rows, 4 warps each, each block
    also writing its partial dgamma row; then the sum of those rows in a
    fixed order: deterministic)."""
    if _on_cpu(x, gamma, dy):
        return ref.rmsnorm_bwd_ref(x, gamma, dy, eps)
    from repro_torch.kernels import _build

    grads = rmsnorm_backward_with(_build.entry("rmsnorm_bwd"), x, gamma, dy,
                                  eps)
    BACKWARD_LAUNCHES["rmsnorm_bwd"] += 1
    return grads


def rmsnorm_backward_with(entry, x, gamma, dy, eps: float):
    """``rmsnorm_backward``'s checks, workspaces and launch on CUDA
    tensors, through ``entry``: a C function with the arguments of
    ``csrc/rmsnorm.cu``'s ``repro_rmsnorm_bwd_bf16`` (this tree's, or an
    older build's for a before/after timing).  Counts no launch."""
    h = x.shape[-1]
    if gamma.shape != (h,) or gamma.dtype != torch.float32:
        raise ValueError(f"gamma must be fp32 [{h}]")
    if {x.dtype, dy.dtype} != {torch.bfloat16} or dy.shape != x.shape:
        raise TypeError(f"x and dy must be bf16 {tuple(x.shape)}")
    if h % 8 or not 8 <= h <= RMSNORM_MAX_WIDTH:
        raise ValueError(f"the CUDA rmsnorm backward takes rows of a multiple "
                         f"of 8 up to {RMSNORM_MAX_WIDTH} wide, got {h}")
    x2 = _aligned(x.reshape(-1, h).contiguous())
    dy2 = _aligned(dy.reshape(-1, h).contiguous())
    rows = x2.shape[0]
    dx = torch.empty_like(x2)
    if rows == 0:
        return dx.reshape(x.shape), torch.zeros_like(gamma)
    blocks = rmsnorm_bwd_blocks(rows)
    partial = torch.empty((blocks, h), dtype=torch.float32, device=x.device)
    dgamma = torch.empty_like(gamma)
    _check(entry(
        _ptr(x2), _ptr(_aligned(gamma.contiguous())), _ptr(dy2), _ptr(dx),
        _ptr(partial), _ptr(dgamma), rows, h, float(eps), blocks,
        _stream(x2)), "rmsnorm_bwd")
    return dx.reshape(x.shape), dgamma


class _RmsNorm(torch.autograd.Function):
    """``rmsnorm`` with its backward (rstd recomputed from x there)."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return _rmsnorm(x, gamma, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma = rmsnorm_backward(x, gamma, dy, eps=ctx.eps)
        return dx, dgamma, None


# ---------------------------------------------------------------------------
# The split rmsnorm (d2 > 1): a row's features lie on the tp2 ranks, so the
# two row sums (forward: sum x^2; backward: sum dy gamma x) are partial on
# each rank and go through an all-reduce over tp2 between a partial kernel
# and an apply kernel (``csrc/rmsnorm.cu``).  The forward keeps rstd for
# the backward: recomputing it there would take a second all-reduce.
# ---------------------------------------------------------------------------


def _split_rows(x: torch.Tensor, what: str) -> torch.Tensor:
    """``x [..., w]`` as the split kernels read it: bf16 rows ``[rows, w]``,
    contiguous and 16-byte aligned, w a multiple of 8 up to
    ``RMSNORM_MAX_WIDTH``."""
    w = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA {what} takes bf16 rows, got {x.dtype}")
    if w % 8 or not 8 <= w <= RMSNORM_MAX_WIDTH:
        raise ValueError(f"the CUDA {what} takes rows of a multiple of 8 up "
                         f"to {RMSNORM_MAX_WIDTH} wide, got {w}")
    return _aligned(x.reshape(-1, w).contiguous())


def _split_gamma(gamma: torch.Tensor, w: int, what: str) -> torch.Tensor:
    if gamma.shape != (w,) or gamma.dtype != torch.float32:
        raise ValueError(f"the CUDA {what} takes an fp32 gamma [{w}], got "
                         f"{gamma.dtype} {tuple(gamma.shape)}")
    return _aligned(gamma.contiguous())


def _row_sums(t: torch.Tensor, rows: int, what: str) -> torch.Tensor:
    """A per-row fp32 input of the split kernels as ``[rows]``."""
    if t.dtype != torch.float32 or t.numel() != rows:
        raise ValueError(f"the CUDA {what} takes fp32 row sums of {rows} "
                         f"rows, got {t.dtype} {tuple(t.shape)}")
    return t.reshape(rows).contiguous()


def rmsnorm_ss(x: torch.Tensor) -> torch.Tensor:
    """The split norm's forward partial: per row of this rank's slice
    ``x [..., w]``, the fp32 sum of squares ``[...]``.  One launch of
    ``csrc/rmsnorm.cu``'s ``rmsnorm_kernel`` in its ``kSumSquares`` mode
    (``rmsnorm_plan``'s threads a row, the whole-row norm's order of
    sums)."""
    if _on_cpu(x):
        return ref.rmsnorm_ss_ref(x)
    from repro_torch.kernels import _build

    x2 = _split_rows(x, "rmsnorm partial")
    rows, w = x2.shape
    ss = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows:
        plan = rmsnorm_plan(rows, w)
        _check(_build.entry("rmsnorm_ss")(
            _ptr(x2), _ptr(ss), rows, w, plan.threads, plan.vectors,
            plan.rows, _stream(x2)), "rmsnorm_ss")
        SPLIT_LAUNCHES["rmsnorm_ss"] += 1
    return ss.reshape(x.shape[:-1])


def rmsnorm_apply(x: torch.Tensor, gamma: torch.Tensor, ss: torch.Tensor,
                  width: int, eps: float = 1e-6):
    """The split norm's forward apply, after the all-reduce: from the sums
    of squares ``ss [...]`` of the whole rows (``width`` wide, the sum of
    the slices' widths), ``rstd = rsqrt(ss / width + eps)`` and ``y = x
    rstd gamma`` on this rank's slice.  Returns ``(y in x.dtype, rstd fp32
    [...])``.  On CUDA: bf16 x, fp32 gamma [w] and ss; one launch of
    ``rmsnorm_kernel`` in its ``kApply`` mode."""
    if _on_cpu(x, gamma, ss):
        return ref.rmsnorm_apply_ref(x, gamma, ss, width, eps)
    from repro_torch.kernels import _build

    x2 = _split_rows(x, "rmsnorm apply")
    rows, w = x2.shape
    g = _split_gamma(gamma, w, "rmsnorm apply")
    ss1 = _row_sums(ss, rows, "rmsnorm apply")
    out = torch.empty_like(x2)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows:
        plan = rmsnorm_plan(rows, w)
        _check(_build.entry("rmsnorm_apply")(
            _ptr(x2), _ptr(g), _ptr(ss1), _ptr(out), _ptr(rstd), rows, w,
            float(width), float(eps), plan.threads, plan.vectors, plan.rows,
            _stream(x2)), "rmsnorm_apply")
        SPLIT_LAUNCHES["rmsnorm_apply"] += 1
    return out.reshape(x.shape), rstd.reshape(x.shape[:-1])


def rmsnorm_bwd_partial(x: torch.Tensor, gamma: torch.Tensor,
                        dy: torch.Tensor, rstd: torch.Tensor):
    """The split norm's backward partial, from the forward's ``rstd``:
    per row of the slice the fp32 ``dot = sum_j dy_j gamma_j x_j``, and
    the slice's ``dgamma = sum over rows of dy x rstd`` (fp32, summed in a
    fixed order: deterministic).  Returns ``(dot [...], dgamma [w])``.  On
    CUDA: bf16 x and dy, fp32 gamma and rstd; one C entry
    (``rmsnorm_bwd_kernel`` in its ``kDot`` mode, each block also writing
    its partial dgamma row; then ``rmsnorm_dgamma_kernel`` over those
    rows)."""
    if _on_cpu(x, gamma, dy, rstd):
        return ref.rmsnorm_bwd_partial_ref(x, gamma, dy, rstd)
    from repro_torch.kernels import _build

    if dy.shape != x.shape:
        raise ValueError(f"dy must be {tuple(x.shape)}, got {tuple(dy.shape)}")
    x2 = _split_rows(x, "rmsnorm backward partial")
    dy2 = _split_rows(dy, "rmsnorm backward partial")
    rows, w = x2.shape
    g = _split_gamma(gamma, w, "rmsnorm backward partial")
    r1 = _row_sums(rstd, rows, "rmsnorm backward partial")
    dot = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return dot.reshape(x.shape[:-1]), torch.zeros_like(gamma)
    blocks = rmsnorm_bwd_blocks(rows)
    partial = torch.empty((blocks, w), dtype=torch.float32, device=x.device)
    dgamma = torch.empty_like(g)
    _check(_build.entry("rmsnorm_bwd_partial")(
        _ptr(x2), _ptr(g), _ptr(dy2), _ptr(r1), _ptr(dot), _ptr(partial),
        _ptr(dgamma), rows, w, blocks, _stream(x2)), "rmsnorm_bwd_partial")
    SPLIT_LAUNCHES["rmsnorm_bwd_partial"] += 1
    return dot.reshape(x.shape[:-1]), dgamma


def rmsnorm_bwd_apply(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                      rstd: torch.Tensor, dot: torch.Tensor, width: int):
    """The split norm's backward apply, after the all-reduce: from the
    whole rows' ``dot [...]``, ``dx = rstd (gamma dy - x rstd^2 dot /
    width)`` on this rank's slice, in ``x.dtype``.  On CUDA: bf16 x and dy,
    fp32 gamma, rstd and dot; one launch of ``rmsnorm_bwd_kernel`` in its
    ``kDx`` mode (the whole-row backward's grid)."""
    if _on_cpu(x, gamma, dy, rstd, dot):
        return ref.rmsnorm_bwd_apply_ref(x, gamma, dy, rstd, dot, width)
    from repro_torch.kernels import _build

    if dy.shape != x.shape:
        raise ValueError(f"dy must be {tuple(x.shape)}, got {tuple(dy.shape)}")
    x2 = _split_rows(x, "rmsnorm backward apply")
    dy2 = _split_rows(dy, "rmsnorm backward apply")
    rows, w = x2.shape
    g = _split_gamma(gamma, w, "rmsnorm backward apply")
    r1 = _row_sums(rstd, rows, "rmsnorm backward apply")
    d1 = _row_sums(dot, rows, "rmsnorm backward apply")
    dx = torch.empty_like(x2)
    if rows:
        _check(_build.entry("rmsnorm_bwd_apply")(
            _ptr(x2), _ptr(g), _ptr(dy2), _ptr(r1), _ptr(d1), _ptr(dx), rows,
            w, float(width), rmsnorm_bwd_blocks(rows), _stream(x2)),
            "rmsnorm_bwd_apply")
        SPLIT_LAUNCHES["rmsnorm_bwd_apply"] += 1
    return dx.reshape(x.shape)


def _split_forward(x, gamma, eps, width, reduce):
    ss = rmsnorm_ss(x)
    reduce(ss)
    return rmsnorm_apply(x, gamma, ss, width, eps)


class _SplitRmsNorm(torch.autograd.Function):
    """``split_rmsnorm`` with its backward: the backward partial, the
    all-reduce of ``dot``, the backward apply; rstd saved by the
    forward."""

    @staticmethod
    def forward(ctx, x, gamma, eps, width, reduce):
        y, rstd = _split_forward(x, gamma, eps, width, reduce)
        ctx.save_for_backward(x, gamma, rstd)
        ctx.width, ctx.reduce = width, reduce
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, rstd = ctx.saved_tensors
        dot, dgamma = rmsnorm_bwd_partial(x, gamma, dy, rstd)
        ctx.reduce(dot)
        dx = rmsnorm_bwd_apply(x, gamma, dy, rstd, dot, ctx.width)
        return dx, dgamma, None, None, None


def split_rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, width: int,
                  reduce, eps: float = 1e-6):
    """RMSNorm of rows whose features are split over ranks: this rank's
    slice ``x [..., w]`` of rows ``width`` wide and its slice of the
    (resolved) ``gamma [w]``; ``reduce(t)`` sums an fp32 per-row tensor
    over the slices in place (the tp2 all-reduce).  Forward: the partial
    kernel, ``reduce``, the apply kernel; under autograd the backward
    runs the backward partial, ``reduce`` and the backward apply.  Each
    kernel launch counts in ``SPLIT_LAUNCHES``; on the CPU the plain
    versions run."""
    if _grad(x, gamma):
        return _SplitRmsNorm.apply(x, gamma, eps, width, reduce)
    return _split_forward(x, gamma, eps, width, reduce)[0]


def group_rmsnorm(y: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6, *,
                  gate: torch.Tensor | None = None):
    """The Mamba2 grouped RMSNorm: per row of ``y [..., G, w]`` in fp32,
    ``y * rsqrt(mean(y^2)+eps) * gamma[g]`` with ``gamma [G, w]``, cast to
    ``y.dtype``; with ``gate`` (y's shape), times ``silu(gate)`` in
    ``y.dtype``.  One launch of the rmsnorm kernel, counted under
    ``LAUNCHES["rmsnorm"]``.

    On CUDA as ``rmsnorm``, and the gate bf16, read through its strides
    (a slice of the z|x GEMM output: each token's ``G * w`` values must be
    unit-stride)."""
    if _grad(y, gamma, gate):
        return _GroupRmsNorm.apply(y, gamma, gate, eps)
    return _group_rmsnorm(y, gamma, eps, gate)


def _group_rmsnorm(y, gamma, eps, gate):
    if _on_cpu(y, gamma, gate):
        return ref.group_rmsnorm_ref(y, gamma, eps, gate)
    if gamma.dim() != 2 or y.shape[-2:] != gamma.shape:
        raise ValueError(f"gamma must be [G, w] = {tuple(y.shape[-2:])}, got "
                         f"{tuple(gamma.shape)}")
    if gate is not None and gate.shape != y.shape:
        raise ValueError(f"gate must be {tuple(y.shape)}, got "
                         f"{tuple(gate.shape)}")
    width = gamma.shape[0] * gamma.shape[1]
    gate2 = None if gate is None else gate.reshape(-1, width)
    return _norm(y.reshape(-1, width), gamma, gate2, eps).reshape(y.shape)


#: the widest row of the grouped norm's backward (one 8-lane group a row)
GROUP_BWD_MAX_WIDTH = 64
#: slots of 8 values a thread of the grouped backward takes, fewest first
#: (the kernel's variants)
GROUP_BWD_VECTORS = (1, 2, 4, 8)
#: the most threads of a grouped backward block; with 8 slots a thread
#: that holds rows of up to 256 groups
GROUP_BWD_MAX_THREADS = 256
#: grouped backward blocks an SM runs at once (2 of 224 threads at the
#: training shape's 112 groups)
GROUP_BWD_BLOCKS_PER_SM = 2


@dataclasses.dataclass(frozen=True)
class GroupBwdPlan:
    """A CUDA launch of the grouped, gated norm's backward
    (``csrc/rmsnorm.cu``, token-major): ``shares`` blocks of ``threads``
    threads; block i takes tokens ``[i * tokens // shares, (i + 1) *
    tokens // shares)`` whole.  A token's row is ``groups * 8`` slots of 8
    values (group g's slots ``8g .. 8g + 7``, the first ``width // 8`` of
    them live); thread j owns slots ``j, j + threads, ...`` (``vectors``
    of them), the same in every row."""
    tokens: int
    groups: int
    width: int
    threads: int
    vectors: int
    shares: int

    @property
    def name(self) -> str:
        return (f"{self.shares} shares of the tokens, {self.threads} threads "
                f"x {self.vectors} slots")

    def token_range(self, share: int) -> range:
        return range(share * self.tokens // self.shares,
                     (share + 1) * self.tokens // self.shares)

    def thread_columns(self, j: int) -> list[tuple[int, int]]:
        """(group, first column within it) of each live slot thread ``j``
        owns."""
        out = []
        for k in range(self.vectors):
            q = j + k * self.threads
            if q < 8 * self.groups and 8 * (q % 8) < self.width:
                out.append((q // 8, 8 * (q % 8)))
        return out


@functools.lru_cache(maxsize=None)
def group_rmsnorm_bwd_plan(tokens: int, groups: int, width: int,
                           sms: int = SMS) -> GroupBwdPlan:
    """The fewest slots a thread that keep a block within
    ``GROUP_BWD_MAX_THREADS`` threads (in whole warps: a group's 8 slots
    are 8 neighbouring lanes); ``GROUP_BWD_BLOCKS_PER_SM`` blocks an SM,
    no more shares than tokens.  At the training shape (112 groups of 64):
    224 threads of 4 slots, 264 shares of 7-8 tokens."""
    slots = 8 * groups
    vectors = next((v for v in GROUP_BWD_VECTORS
                    if -(-slots // v) <= GROUP_BWD_MAX_THREADS), None)
    if vectors is None:
        raise ValueError(f"the CUDA grouped rmsnorm backward takes at most "
                         f"{GROUP_BWD_MAX_THREADS * GROUP_BWD_VECTORS[-1] // 8}"
                         f" groups, got {groups}")
    threads = 32 * -(-slots // (32 * vectors))
    shares = max(1, min(tokens, GROUP_BWD_BLOCKS_PER_SM * sms))
    return GroupBwdPlan(tokens, groups, width, threads, vectors, shares)


def group_rmsnorm_backward(y: torch.Tensor, gamma: torch.Tensor,
                           dout: torch.Tensor, eps: float = 1e-6, *,
                           gate: torch.Tensor | None = None):
    """(dy, dgamma [G, w] fp32, dgate or None) of ``group_rmsnorm`` for the
    output gradient ``dout``.

    On CUDA: bf16 y, dout and gate (the gate read through its strides, as
    the forward reads it), fp32 gamma, w a multiple of 8 up to
    ``GROUP_BWD_MAX_WIDTH``, at most 256 groups; one C entry (each block
    taking a share of the tokens, whole rows, and writing its partial
    dgamma row; then the sum of those rows in a fixed order:
    deterministic), its grid from ``group_rmsnorm_bwd_plan``."""
    if _on_cpu(y, gamma, dout, gate):
        return ref.group_rmsnorm_bwd_ref(y, gamma, dout, eps, gate)
    from repro_torch.kernels import _build

    if gamma.dim() != 2 or y.shape[-2:] != gamma.shape:
        raise ValueError(f"gamma must be [G, w] = {tuple(y.shape[-2:])}, got "
                         f"{tuple(gamma.shape)}")
    if dout.shape != y.shape or (gate is not None and gate.shape != y.shape):
        raise ValueError(f"dout and gate must be {tuple(y.shape)}")
    if {y.dtype, dout.dtype} != {torch.bfloat16} or (
            gate is not None and gate.dtype != torch.bfloat16):
        raise TypeError("the CUDA grouped rmsnorm backward takes bf16 y, dout "
                        "and gate")
    if gamma.dtype != torch.float32:
        raise TypeError("the CUDA grouped rmsnorm backward takes an fp32 "
                        "gamma")
    groups, w = gamma.shape
    if w % 8 or not 8 <= w <= GROUP_BWD_MAX_WIDTH:
        raise ValueError(f"the CUDA grouped rmsnorm backward takes groups of "
                         f"a multiple of 8 up to {GROUP_BWD_MAX_WIDTH} wide, "
                         f"got {w}")
    width = groups * w
    # y and dout contiguous (one row stride for both); the gate through its
    # own stride
    y2 = _aligned(y.reshape(-1, width).contiguous())
    d2 = _aligned(dout.reshape(-1, width).contiguous())
    g2 = None if gate is None else _aligned(gate.reshape(-1, width))
    tokens = y2.shape[0]
    dy = torch.empty((tokens, width), dtype=y.dtype, device=y.device)
    dgate = None if gate is None else torch.empty_like(dy)
    if tokens == 0:
        return (dy.reshape(y.shape), torch.zeros_like(gamma),
                None if gate is None else dgate.reshape(y.shape))
    plan = group_rmsnorm_bwd_plan(tokens, groups, w)
    partial = torch.empty((plan.shares, groups, w), dtype=torch.float32,
                          device=y.device)
    dgamma = torch.empty_like(gamma)
    _check(_build.entry("group_rmsnorm_bwd")(
        _ptr(y2), _ptr(_aligned(gamma.contiguous())), _ptr(d2), _ptr(g2),
        _ptr(dy), _ptr(dgate), _ptr(partial), _ptr(dgamma), y2.stride(0),
        0 if g2 is None else g2.stride(0), tokens, groups, w, float(eps),
        plan.threads, plan.vectors, plan.shares, _stream(y2)),
        "group_rmsnorm_bwd")
    BACKWARD_LAUNCHES["group_rmsnorm_bwd"] += 1
    return (dy.reshape(y.shape), dgamma,
            None if gate is None else dgate.reshape(y.shape))


class _GroupRmsNorm(torch.autograd.Function):
    """``group_rmsnorm`` with its backward (rstd and silu(gate) recomputed
    there from y and the gate)."""

    @staticmethod
    def forward(ctx, y, gamma, gate, eps):
        ctx.save_for_backward(y, gamma, gate)
        ctx.eps = eps
        return _group_rmsnorm(y, gamma, eps, gate)

    @staticmethod
    def backward(ctx, dout):
        y, gamma, gate = ctx.saved_tensors
        dy, dgamma, dgate = group_rmsnorm_backward(y, gamma, dout, ctx.eps,
                                                   gate=gate)
        return dy, dgamma, dgate, None


def _norm(x2, gamma, gate2, eps: float):
    """The CUDA rmsnorm on ``x2 [tokens, G * w]`` (``gate2`` the same or
    None) with ``gamma [G, w]``: returns ``[tokens * G, w]``."""
    from repro_torch.kernels import _build

    groups, w = gamma.shape
    if x2.dtype != torch.bfloat16 or (gate2 is not None
                                      and gate2.dtype != torch.bfloat16):
        raise TypeError("the CUDA rmsnorm takes bf16 rows and gate")
    if gamma.dtype != torch.float32:
        raise TypeError("the CUDA rmsnorm takes an fp32 gamma")
    if w % 8 or not 8 <= w <= RMSNORM_MAX_WIDTH:
        raise ValueError(f"the CUDA rmsnorm takes rows of a multiple of 8 up "
                         f"to {RMSNORM_MAX_WIDTH} wide, got {w}")
    x2, gate2, gamma = _aligned(x2), _aligned(gate2), _aligned(gamma)
    tokens = x2.shape[0]
    out = torch.empty((tokens * groups, w), dtype=x2.dtype, device=x2.device)
    if tokens == 0:
        return out
    plan = rmsnorm_plan(tokens * groups, w)
    _check(_build.entry("rmsnorm")(
        _ptr(x2), _ptr(gamma), _ptr(gate2), _ptr(out), x2.stride(0),
        0 if gate2 is None else gate2.stride(0), tokens, groups, w,
        float(eps), plan.threads, plan.vectors, plan.rows, _stream(x2)),
        "rmsnorm")
    LAUNCHES["rmsnorm"] += 1
    return out


@dataclasses.dataclass(frozen=True)
class SsdPlan:
    """A CUDA ssd_scan launch: one block per (split, head, batch row), each
    taking ``rows = hd // splits`` state rows p (the columns of x and y) of
    its (batch row, head): split i takes rows ``[i * rows, (i + 1) *
    rows)``.  ``one_token``: the s = 1 kernel (a half-warp per row, no
    chunk machinery); otherwise the chunked kernel."""
    b: int
    nh: int
    splits: int
    one_token: bool
    hd: int = 64

    @property
    def rows(self) -> int:
        return self.hd // self.splits

    @property
    def blocks(self) -> int:
        return self.b * self.nh * self.splits

    @property
    def name(self) -> str:
        kind = "one-token" if self.one_token else "chunked"
        return f"{kind}, {self.splits} x {self.rows} rows, {self.blocks} blocks"

    def block_rows(self):
        """(batch row, head, first row, end row) of each block, in the
        kernel's grid order (split fastest, then head, then batch row)."""
        for b in range(self.b):
            for h in range(self.nh):
                for i in range(self.splits):
                    yield b, h, i * self.rows, (i + 1) * self.rows


#: state rows per block of the one-token kernel (``ssd_scan.cu``)
SSD_STEP_ROWS = 16
#: the chunked kernel's splits of the head dim, fewest first
SSD_SPLITS = (1, 2, 4)


@functools.lru_cache(maxsize=None)
def ssd_plan(b: int, s: int, nh: int, hd: int = 64,
             sms: int = SMS) -> SsdPlan:
    """The grid of an SSD scan over ``b`` batch rows, ``s`` positions and
    ``nh`` heads.  s = 1 takes the one-token kernel, 16 state rows a block.
    Longer runs split each (batch row, head) over the head dim into the
    fewest splits that give blocks to half the SMs, each block recomputing
    the chunk's decayed C.B^T for its rows.  Measured on a one-row prefill
    chunk (``chip_smoke.py`` times every split): 1 split is fastest at 112
    heads (zamba2-7b on one card) and 2 at 56 (one of 2 tensor-parallel
    ranks); at 28 (one of 4) 2 and 4 splits are about even."""
    if s == 1:
        return SsdPlan(b, nh, hd // SSD_STEP_ROWS, True, hd)
    for splits in SSD_SPLITS:
        if 2 * b * nh * splits >= sms:
            break
    return SsdPlan(b, nh, splits, False, hd)


@dataclasses.dataclass(frozen=True)
class SsdBwdPlan:
    """A CUDA ssd_scan backward launch (``csrc/ssd_scan_bwd.cu``): its
    chunk and gradient kernels take one block per (chunk, head group, batch
    row), a group being ``heads`` consecutive heads (the last may have
    fewer); the blocks of a group sum their heads' dB and dC into one
    partial row per position."""
    b: int
    nc: int
    nh: int
    heads: int

    @property
    def groups(self) -> int:
        return -(-self.nh // self.heads)

    @property
    def blocks(self) -> int:
        return self.b * self.nc * self.groups

    @property
    def name(self) -> str:
        return (f"{self.heads} heads a block, {self.groups} groups, "
                f"{self.blocks} blocks")

    def block_heads(self):
        """(batch row, chunk, first head, end head) of each block, in the
        kernels' grid order (chunk fastest, then group, then batch row)."""
        for b in range(self.b):
            for g in range(self.groups):
                for c in range(self.nc):
                    yield (b, c, g * self.heads,
                           min(self.nh, (g + 1) * self.heads))


#: heads a block of the SSD backward may take, most first (the kernel takes
#: up to 8)
SSD_BWD_HEADS = (8, 4, 2, 1)
#: the SSD backward's blocks an SM should get (its gradient kernel runs 2
#: at once).  Measured at the training shape (``chip_smoke.py`` times every
#: size): 8 heads a block (448 blocks) 3-5% faster than 2 or 4, 10% faster
#: than 1
SSD_BWD_BLOCKS_PER_SM = 3


@functools.lru_cache(maxsize=None)
def ssd_bwd_plan(b: int, s: int, nh: int, chunk: int,
                 sms: int = SMS) -> SsdBwdPlan:
    """The grid of an SSD scan backward: the most heads a block (the fewest
    partial rows of dB and dC to write and sum) that still give
    ``SSD_BWD_BLOCKS_PER_SM`` blocks to every SM.  At the training shape
    (b = 1, 32 chunks, 112 heads): 8 heads a block, 448 blocks."""
    nc = -(-s // chunk)
    for heads in SSD_BWD_HEADS:
        if b * nc * -(-nh // heads) >= SSD_BWD_BLOCKS_PER_SM * sms:
            break
    return SsdBwdPlan(b, nc, nh, heads)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *, chunk: int,
             state_in: torch.Tensor | None = None,
             pool: torch.Tensor | None = None,
             slot: torch.Tensor | None = None,
             fresh: torch.Tensor | None = None):
    """Mamba2 SSD scan.  x [b, s, nh, hd]; dt [b, s, nh] (softplus'd);
    A_log, D [nh]; B, C [b, s, ds] (one group).  The state comes in one of
    two forms:
      - ``state_in [b, nh, hd, ds]`` fp32, or None for zeros: returns
        (y [b, s, nh, hd] in ``x.dtype``, state_out [b, nh, hd, ds] fp32);
      - ``pool [slots, nh, hd, ds]`` fp32 with ``slot [b]`` and ``fresh
        [b]`` bool: batch row i reads pool row ``slot[i]`` (zeros where
        ``fresh[i]``) and writes its final state back in place; a slot id
        outside ``[0, slots)`` is the sentinel of a masked row, which reads
        zeros and writes nothing.  Live ids must be distinct
        (``lm.slot_map`` checks once a step; the plain version raises).
        Returns (y, pool).

    On CUDA: bf16 x, B, C (read through their strides, unit stride along
    the last dim); fp32 dt, A_log, D and state; int32 slot; hd = ds = 64
    and ``chunk`` <= 64; any s >= 1; the grid from ``ssd_plan``.

    Under autograd (an input requiring grad, grad mode on) only the
    training form is taken: no pool and no ``state_in`` (the state starts
    from zeros); its backward is ``ssd_scan_backward``, and the final
    state it returns carries no gradient."""
    if _grad(x, dt, A_log, B, C, D, state_in):
        if pool is not None or state_in is not None:
            raise NotImplementedError(
                "ssd_scan under autograd starts from a zero state: the pool "
                "form and state_in have no backward (the training path "
                "needs neither)")
        return _SsdScan.apply(x, dt, A_log, B, C, D, chunk)
    return _ssd_scan(x, dt, A_log, B, C, D, chunk, state_in, pool, slot,
                     fresh)


def _ssd_scan(x, dt, A_log, B, C, D, chunk, state_in=None, pool=None,
              slot=None, fresh=None):
    """``ssd_scan`` off the autograd path."""
    if pool is None and (slot is not None or fresh is not None):
        raise ValueError("slot and fresh address a pool: pass pool=")
    if pool is not None and (state_in is not None or slot is None
                             or fresh is None):
        raise ValueError("the pool form takes pool, slot and fresh, and no "
                         "state_in")
    if _on_cpu(x, dt, A_log, B, C, D, state_in, pool, slot, fresh):
        if pool is not None:
            return ref.ssd_pool_ref(x, dt, A_log, B, C, D, chunk, pool, slot,
                                    fresh)
        return ref.ssd_ref(x, dt, A_log, B, C, D, chunk, state_in)
    from repro_torch.kernels import _build

    b, s, nh, hd, ds = _ssd_check(x, dt, A_log, B, C, D, chunk)
    row = (nh, hd, ds)
    if pool is not None:
        if (pool.dtype != torch.float32 or pool.dim() != 4
                or pool.shape[1:] != row
                or pool.stride()[1:] != (hd * ds, ds, 1)):
            raise ValueError(f"pool must be fp32 [slots, {nh}, {hd}, {ds}] "
                             f"with contiguous rows, got {pool.dtype} "
                             f"{tuple(pool.shape)}")
        if slot.shape != (b,) or slot.dtype != torch.int32:
            raise TypeError(f"slot must be int32 [{b}], got {slot.dtype} "
                            f"{tuple(slot.shape)}")
        if fresh.shape != (b,) or fresh.dtype != torch.bool:
            raise TypeError(f"fresh must be bool [{b}], got {fresh.dtype} "
                            f"{tuple(fresh.shape)}")
        st_in = st_out = pool
        slots, st_stride = pool.shape[0], pool.stride(0)
        slot, fresh = slot.contiguous(), fresh.contiguous()
    else:
        if state_in is not None:
            if state_in.shape != (b, *row) or state_in.dtype != torch.float32:
                raise ValueError(f"state_in must be fp32 [{b}, {nh}, {hd}, "
                                 f"{ds}], got {state_in.dtype} "
                                 f"{tuple(state_in.shape)}")
            state_in = state_in.contiguous()
        st_in = state_in
        st_out = torch.empty((b, *row), dtype=torch.float32, device=x.device)
        slots, st_stride = b, nh * hd * ds
    if x.stride(-1) != 1 or B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError("x, B and C need unit stride along their last dim")
    x, B, C = _aligned(x), _aligned(B), _aligned(C)
    A_log, D = A_log.contiguous(), D.contiguous()
    y = torch.empty((b, s, nh, hd), dtype=x.dtype, device=x.device)
    plan = ssd_plan(b, s, nh, hd)
    _check(_build.entry("ssd_scan")(
        _ptr(x), _ptr(dt), _ptr(A_log), _ptr(B), _ptr(C), _ptr(D),
        _ptr(st_in), _ptr(st_out), _ptr(slot), _ptr(fresh), _ptr(y),
        st_stride, slots, b, s, nh, hd, ds, chunk, plan.splits,
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2],
        _stream(x)), "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return y, st_out


def _ssd_check(x, dt, A_log, B, C, D, chunk):
    """The shapes and dtypes both CUDA SSD entries take; returns
    (b, s, nh, hd, ds)."""
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
    return b, s, nh, hd, ds


def ssd_scan_backward(x, dt, A_log, B, C, D, dy, *, chunk: int):
    """(dx, ddt, dA_log, dB, dC, dD) of ``ssd_scan`` from a zero state with
    the final state dropped, for the output gradient ``dy`` (x's shape).

    On CUDA: as ``ssd_scan`` takes them, and ``dy`` bf16; one C entry
    (``csrc/ssd_scan_bwd.cu``, chunk-parallel: each chunk's state and
    gradient increments, the two linear recurrences between chunks, each
    chunk's gradients with its head group's dB and dC summed into fp32
    partial rows, then those summed over the groups and dA_log and dD over
    (batch row, chunk) in a fixed order: deterministic), its grid from
    ``ssd_bwd_plan``.  Outputs in the inputs' dtypes."""
    if _on_cpu(x, dt, A_log, B, C, D, dy):
        return ref.ssd_bwd_ref(x, dt, A_log, B, C, D, dy, chunk)
    from repro_torch.kernels import _build

    b, s, nh, hd, ds = _ssd_check(x, dt, A_log, B, C, D, chunk)
    if dy.shape != x.shape or dy.dtype != torch.bfloat16:
        raise ValueError(f"dy must be bf16 {tuple(x.shape)}")
    if B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError("B and C need unit stride along their last dim")
    x, dy = (_aligned(t.contiguous()) for t in (x, dy))
    B, C = _aligned(B), _aligned(C)
    dt, A_log, D = dt.contiguous(), A_log.contiguous(), D.contiguous()
    plan = ssd_bwd_plan(b, s, nh, chunk)
    nc = plan.nc
    # fp32 scratch: per (batch row, head, chunk) the state increment, then
    # the state entering the chunk (states[0]), the gradient increment,
    # then the gradient of the state leaving it (states[1]), and la_end;
    # per head group, dB and dC of every position; per (batch row, chunk,
    # head) dA and dD
    states = torch.empty(2, b * nh * nc * hd * ds, dtype=torch.float32,
                         device=x.device)
    la_end = torch.empty(b * nh * nc, dtype=torch.float32, device=x.device)
    part = torch.empty(b * plan.groups * s * 2 * ds, dtype=torch.float32,
                       device=x.device)
    part_ad = torch.empty(2 * b * nc * nh, dtype=torch.float32,
                          device=x.device)
    dx = torch.empty_like(x)
    ddt = torch.empty((b, s, nh), dtype=torch.float32, device=x.device)
    dB = torch.empty((b, s, ds), dtype=B.dtype, device=x.device)
    dC = torch.empty_like(dB)
    dA_log, dD = torch.empty_like(A_log), torch.empty_like(D)
    _check(_build.entry("ssd_scan_bwd")(
        _ptr(x), _ptr(dt), _ptr(A_log), _ptr(B), _ptr(C), _ptr(D), _ptr(dy),
        _ptr(dx), _ptr(ddt), _ptr(dA_log), _ptr(dB), _ptr(dC), _ptr(dD),
        _ptr(states[0]), _ptr(states[1]), _ptr(la_end), _ptr(part),
        _ptr(part_ad), b, s, nh, hd, ds, chunk, plan.heads,
        *B.stride()[:2], *C.stride()[:2], _stream(x)), "ssd_scan_bwd")
    BACKWARD_LAUNCHES["ssd_scan_bwd"] += 1
    return dx, ddt, dA_log, dB, dC, dD


class _SsdScan(torch.autograd.Function):
    """``ssd_scan`` from a zero state, with its backward; the final state
    is returned without a gradient (a gradient reaching it raises)."""

    @staticmethod
    def forward(ctx, x, dt, A_log, B, C, D, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A_log, B, C, D)
        ctx.chunk = chunk
        y, state = _ssd_scan(x, dt, A_log, B, C, D, chunk)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        if dstate is not None:
            raise NotImplementedError("a gradient through ssd_scan's final "
                                      "state has no backward")
        x, dt, A_log, B, C, D = ctx.saved_tensors
        grads = ssd_scan_backward(x, dt, A_log, B, C, D, dy, chunk=ctx.chunk)
        return (*grads, None)
