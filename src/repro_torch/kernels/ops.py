"""Kernel dispatch, launch plans and launch counters.

Each wrapper takes the plain version (``kernels.ref``) for a tensor on the
CPU, launches its hand-written kernel for a tensor on a CUDA device, and
raises for anything the kernel does not take.  There is no fallback from
the kernel to the plain version.

``LAUNCHES`` counts kernel launches per wrapper: it grows by one where a
kernel is launched and nowhere else, so a run can show that its path went
through the kernels (``reset_launches`` before, read after).  A stream-K
matmul and a split-KV attention merge their splits inside the same launch,
so each call is still one launch.

``matmul_plan`` and ``attention_plan`` choose the CUDA kernels' tiles and
splits from the shapes alone; they are plain Python, so the CPU tests check
them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import ref

LAUNCHES = {"matmul": 0, "flash_attention": 0, "rmsnorm": 0, "ssd_scan": 0}

_ACTIVATIONS = {None: 0, "gelu": 1, "silu": 2}

#: streaming multiprocessors of the H100 the plans fill
SMS = 132


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts if t is not None}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"}:
        raise ValueError(f"tensors must all lie on the CPU or all on one CUDA "
                         f"device, got {sorted(devs)}")
    return False


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


_COUNTERS: dict[tuple, torch.Tensor] = {}


def _counters(t: torch.Tensor, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 arrival counters for the split kernels on
    ``t``'s device and current stream.  The kernel's last-arriving block
    resets each counter it used, so the buffer stays zero between launches;
    a launch that is refused ran no block and leaves it as it was."""
    key = (t.device, torch.cuda.current_stream(t.device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
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
    """A stream-K launch of the CUDA matmul: output tiles of ``bm x bn``
    (``variant``, the index into ``MATMUL_VARIANTS`` the C entry takes),
    K steps of ``bk``, and ``blocks`` blocks that take equal runs of the
    ``tiles * kt`` (tile, K step) units, tile-major: block p takes units
    ``[p * W // blocks, (p + 1) * W // blocks)``, as the kernel cuts them."""
    variant: int
    bm: int
    bn: int
    bk: int
    tiles: int
    kt: int
    blocks: int

    @property
    def name(self) -> str:
        return f"{self.bm}x{self.bn} {MATMUL_VARIANTS[self.variant][3]}"

    def _start(self, p: int) -> int:
        return p * self.tiles * self.kt // self.blocks

    def _owner(self, u: int) -> int:
        return ((u + 1) * self.blocks - 1) // (self.tiles * self.kt)

    def tile_runs(self, tile: int) -> list[tuple[int, int, int]]:
        """(block, first K step, end K step) of each block that works on
        ``tile``, in block order: the order the partials are summed in."""
        kt = self.kt
        out = []
        for p in range(self._owner(tile * kt),
                       self._owner((tile + 1) * kt - 1) + 1):
            u0 = max(self._start(p), tile * kt)
            u1 = min(self._start(p + 1), (tile + 1) * kt)
            out.append((p, u0 - tile * kt, u1 - tile * kt))
        return out

    @functools.cached_property
    def max_share(self) -> int:
        """The most blocks that work on one tile: the partials the merging
        block of that tile sums."""
        kt = self.kt
        return max(self._owner((t + 1) * kt - 1) - self._owner(t * kt) + 1
                   for t in range(self.tiles))


#: (bm, bn, bk, products) of each tile variant of ``csrc/matmul.cu``, in
#: its order
MATMUL_VARIANTS = ((16, 64, 64, "mma.sync"), (64, 128, 64, "wgmma"))
#: the most blocks a plan puts on one SM (each variant fits two)
BLOCKS_PER_SM = 2
#: K steps each block must stream before a second block per SM pays for
#: the extra partial tiles it makes (measured: only the lm_head reaches it)
MIN_RUN = 128
#: a B this small stays in L2, so 16-row tiles of a prefill chunk may read
#: it once per row tile
SMALL_B_BYTES = 8 << 20


@functools.lru_cache(maxsize=None)
def matmul_plan(M: int, N: int, K: int, sms: int = SMS) -> MatmulPlan:
    """The tile variant and the stream-K grid of an ``[M, K] @ [K, N]``.

    M <= 16 (decode rows) takes the 16x64 mma.sync tiles, and so does a
    larger M where B is small (it stays in L2 for the other row tiles);
    a prefill chunk otherwise takes the 64x128 wgmma tiles.  The blocks
    take equal runs of (tile, K step) units, so every SM streams the same
    share of B whatever the tile count, with no second wave: one block per
    SM, or two where each still streams ``MIN_RUN`` K steps."""
    variant = 0 if M <= 16 or 2 * K * N <= SMALL_B_BYTES else 1
    bm, bn, bk, _ = MATMUL_VARIANTS[variant]
    tiles, kt = -(-M // bm) * -(-N // bn), -(-K // bk)
    per_sm = BLOCKS_PER_SM
    while per_sm > 1 and tiles * kt < per_sm * sms * MIN_RUN:
        per_sm -= 1
    return MatmulPlan(variant, bm, bn, bk, tiles, kt,
                      min(per_sm * sms, tiles * kt))


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """A CUDA flash-attention launch: ``row_tiles`` tiles of ``rows``
    (q row x q head of a GQA group) per (batch row, kv head), and the keys
    cut into ``splits`` ranges of ``tiles_per_split`` tiles of ``bkv``."""
    row_tiles: int
    splits: int
    tiles_per_split: int
    rows: int = 64
    bkv: int = 64

    def key_ranges(self, skv: int) -> list[tuple[int, int]]:
        span = self.tiles_per_split * self.bkv
        return [(s * span, min(skv, (s + 1) * span))
                for s in range(self.splits)]


#: the most splits the attention kernel merges
MAX_KV_SPLITS = 32


def attention_plan(b: int, sq: int, hq: int, hkv: int, skv: int,
                   sms: int = SMS) -> AttentionPlan:
    """Row tiles of 64 (q row x q head of the group, heads innermost) per
    (batch row, kv head); then, where those blocks fill less than half the
    card, split the keys (flash-decoding) into ranges of whole 64-key
    tiles, as many as it takes to cover ``sms`` SMs.  A split costs a
    partial write and a merge of a few microseconds, so it must carry at
    least one key tile for a row tile of at most 16 rows (a decode tick:
    one warp's product per key tile) and four for a fuller one."""
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


def matmul(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
           *, activation: str | None = None) -> torch.Tensor:
    """``a [..., K] @ b [K, N]`` (+ bias [N], then gelu-tanh or silu).

    On CUDA: bf16 operands; ``b`` row-major ``[K, N]`` or the transpose of
    a row-major ``[N, K]`` (a tied embedding used as the head), read
    without a copy."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if _on_cpu(a, b, bias):
        return ref.matmul_ref(a, b, bias, activation)
    from repro_torch.kernels import _build

    lead, K = a.shape[:-1], a.shape[-1]
    if b.dim() != 2 or b.shape[0] != K:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    N = b.shape[1]
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or (
            bias is not None and bias.dtype != torch.bfloat16):
        raise TypeError("the CUDA matmul takes bf16 operands (int8 with a "
                        "dequant scale is ROADMAP A8)")
    if bias is not None and (bias.shape != (N,) or not bias.is_contiguous()):
        raise ValueError(f"bias must be contiguous [{N}]")
    if b.is_contiguous():
        b_trans = 0
    elif b.stride() == (1, K):
        b_trans = 1
    else:
        raise ValueError("b must be row-major [K, N] or the transpose of a "
                         "row-major [N, K]")
    a2 = a.reshape(-1, K).contiguous()
    M = a2.shape[0]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0:
        return out.reshape(*lead, N)
    vec = int(K % 8 == 0 and (b_trans or N % 8 == 0)
              and a2.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    plan = matmul_plan(M, N, K)
    ws = counters = None
    if plan.max_share > 1:   # some tile is shared
        ws = torch.empty(2 * plan.blocks * plan.bm * plan.bn,
                         dtype=torch.float32, device=a.device)
        counters = _counters(a, plan.tiles)
    _launch(_build.entry("matmul"),
            (_ptr(a2), _ptr(b), _ptr(bias), _ptr(out), _ptr(ws),
             _ptr(counters), M, N, K, b_trans, _ACTIVATIONS[activation], vec,
             plan.variant, plan.blocks, _stream(a)), "matmul", counters)
    LAUNCHES["matmul"] += 1
    return out.reshape(*lead, N)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: torch.Tensor, kv_len: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q [b, sq, hq, d]; k/v [b, skv, hkv, d]; q_offset/kv_len [b] int.

    Query row i of batch row b sits at position ``q_offset[b] + i`` and sees
    keys ``j < kv_len[b]`` with ``j <= qpos`` (causal) and
    ``j > qpos - window`` (window > 0).  Scale 1/sqrt(d), optional tanh
    softcap.  GQA maps q head h to kv head ``h // (hq // hkv)``."""
    if _on_cpu(q, k, v, q_offset, kv_len):
        return ref.attention_ref(q, k, v, q_offset, kv_len, causal=causal,
                                 window=window, softcap=softcap)
    from repro_torch.kernels import _build

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
    out = torch.empty_like(q)
    plan = attention_plan(b, sq, hq, hkv, skv)
    ws_o = ws_lse = counters = None
    if plan.splits > 1:
        parts = b * hkv * plan.row_tiles * plan.splits * plan.rows
        ws_o = torch.empty(parts * d, dtype=torch.float32, device=q.device)
        ws_lse = torch.empty(parts, dtype=torch.float32, device=q.device)
        counters = _counters(q, b * hkv * plan.row_tiles)
    _launch(_build.entry("flash_attention"),
            (_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(qo), _ptr(kl),
             _ptr(ws_o), _ptr(ws_lse), _ptr(counters), b, sq, skv, hq, hkv, d,
             int(causal), int(window), float(softcap), plan.row_tiles,
             plan.splits, plan.tiles_per_split, _stream(q)),
            "flash_attention", counters)
    LAUNCHES["flash_attention"] += 1
    return out


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6):
    """Per row of ``x [..., h]`` in fp32: ``x * rsqrt(mean(x^2)+eps) * gamma``
    (gamma already resolved), cast back to ``x.dtype``."""
    if _on_cpu(x, gamma):
        return ref.rmsnorm_ref(x, gamma, eps)
    from repro_torch.kernels.rmsnorm import rmsnorm_triton

    h = x.shape[-1]
    if gamma.shape != (h,):
        raise ValueError(f"gamma must be [{h}], got {tuple(gamma.shape)}")
    x2 = x.reshape(-1, h)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    out = rmsnorm_triton(x2, gamma.contiguous(), eps)
    LAUNCHES["rmsnorm"] += 1
    return out.reshape(x.shape)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *, chunk: int,
             state_in: torch.Tensor | None = None):
    """Mamba2 SSD scan from ``state_in`` (zeros when None).

    x [b, s, nh, hd]; dt [b, s, nh] (softplus'd); A_log, D [nh]; B, C
    [b, s, ds] (one group); state_in [b, nh, hd, ds].  Returns
    (y [b, s, nh, hd] in ``x.dtype``, state_out [b, nh, hd, ds] fp32).

    On CUDA: bf16 x, B, C (read through their strides, unit stride along
    the last dim); fp32 dt, A_log, D and state_in; hd = ds = 64 and
    ``chunk`` <= 64; any s >= 1."""
    if _on_cpu(x, dt, A_log, B, C, D, state_in):
        return ref.ssd_ref(x, dt, A_log, B, C, D, chunk, state_in)
    from repro_torch.kernels import _build

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
    if state_in is not None:
        if state_in.shape != (b, nh, hd, ds) or state_in.dtype != torch.float32:
            raise ValueError(f"state_in must be fp32 [{b}, {nh}, {hd}, {ds}], "
                             f"got {state_in.dtype} {tuple(state_in.shape)}")
        state_in = state_in.contiguous()
    if x.stride(-1) != 1 or B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError("x, B and C need unit stride along their last dim")
    A_log, D = A_log.contiguous(), D.contiguous()
    y = torch.empty((b, s, nh, hd), dtype=x.dtype, device=x.device)
    state_out = torch.empty((b, nh, hd, ds), dtype=torch.float32,
                            device=x.device)
    err = _build.entry("ssd_scan")(
        _ptr(x), _ptr(dt), _ptr(A_log), _ptr(B), _ptr(C), _ptr(D),
        _ptr(state_in), _ptr(y), _ptr(state_out), b, s, nh, hd, ds, chunk,
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2],
        _stream(x))
    _check(err, "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return y, state_out
