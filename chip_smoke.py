#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as a release check runs it

Phases, in order, each failing the run on any error:

1. kernels -- build the CUDA kernels from ``src/repro_torch/kernels/csrc``
   with nvcc (the Triton kernel compiles on its first launch), then call each
   kernel at the shapes the llama3-8b serving path gives it and hold it
   against its plain PyTorch version on the same inputs, with the tolerance
   stated beside each check.  Times the kernel, its plain version, one
   library call for the same function (a yardstick the port never calls),
   and computes the least time the card could take (the bound).
2. serve-llama -- llama3-8b at full width and depth, random bf16 weights from
   a seed, through ``launch.serve.make_paged_server``: 8 requests of seeded
   prompt lengths in 64-256, 16 new tokens each, 4 slots, prefill chunk 64,
   page size 16.  Every count of kernel launches is set to 0 just before and
   read just after; every kernel must have launched, at the per-step counts
   of one paged step (65 rmsnorm, 129 matmul, 32 flash_attention).
3. path-check -- llama3-8b at full width with the depth cut to 2 layers: two
   prefill chunks and one decode tick of ``models.lm.paged_step`` on the card
   (kernels, bf16) and on the CPU (plain versions, fp32, from the same bf16
   weights); the logits must agree within the bf16 tolerance stated there
   (``PATH_TOL``), and the top-1 agreement is reported.
4. serve-qwen -- qwen1.5-0.5b at full size (qkv bias in the matmul
   epilogue, the head tied to the embedding), 4 requests.

Prints the card's name and power limit, the kernels' build time, one JSON
line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, where no CUDA device is present or the
port's sources are missing.  Long outputs go to ``chiprun_out/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
PHASES = ("kernels", "serve-llama", "path-check", "serve-qwen")

BF16_TFLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
FP32_TFLOPS = 67e12      # H100 SXM fp32 peak outside the tensor cores
HBM_BYTES_S = 3.35e12    # H100 SXM HBM3 rate


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Timing and bounds.
# ---------------------------------------------------------------------------


class Timer:
    """Median device time of ``fn`` by CUDA events, with the L2 cache
    flushed before every timed call (the serving path meets each layer's
    weights cold: 32 layers of weights are 300x the 50 MB L2).  Each call
    is queued behind a spin of the device (``torch.cuda._sleep``, about a
    millisecond), so the host has queued all of ``fn`` before the start
    event fires and the events time the device's work, not the host's
    launch latency."""

    SPIN_CYCLES = 2_000_000

    def __init__(self, torch, reps: int = 10):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(self.reps):
            torch.cuda._sleep(self.SPIN_CYCLES)
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within(got, want, atol: float, rtol: float) -> tuple[bool, float]:
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(((err <= atol + rtol * w.abs()) & g.isfinite()).all())
    return ok, float(err.max())


# ---------------------------------------------------------------------------
# Phase 1: kernels against their plain versions.
# ---------------------------------------------------------------------------

LLAMA_GEMMS = (  # (name, K, N) of llama3-8b's projections, per layer
    ("fused_qkv", 4096, 6144), ("wo", 4096, 4096),
    ("fused_up_gate", 4096, 28672), ("down", 14336, 4096),
)
LLAMA_HEAD = ("lm_head", 4096, 128256)
MM_TOL = dict(atol=1e-2, rtol=1.6e-2)     # bf16 output: 2 ulp at |x|~1
FA_TOL = dict(atol=2e-2, rtol=2e-2)       # + bf16 vs fp32 probabilities
RN_TOL = dict(atol=1e-2, rtol=1.6e-2)     # bf16 output rounding


class KernelReport:
    """Per-kernel totals over one prefill chunk plus one decode tick of the
    llama3-8b path (each shape weighted by its launches per step), the
    kernel's time in each of the two steps, and every check's details."""

    def __init__(self, name, route, source, replaces):
        self.row = {"name": name, "route": route, "source": source,
                    "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
                    "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                    "bound_by": "bytes", "library_ms": 0.0}
        self.checks = []
        self.step_ms = {"prefill": 0.0, "decode": 0.0}
        self._bytes_ms = self._ops_ms = 0.0
        self._library_missing = False

    def add(self, label, ok, err, tol, step=None, weight=0, ms=None,
            plain_ms=None, library_ms=None, nbytes=0.0, flops=0.0,
            peak=BF16_TFLOPS):
        """One check; with ``weight`` launches per ``step`` ("prefill" or
        "decode") it also counts towards the totals."""
        check = {"shape": label, "ok": ok, "max_abs_err": err, "tol": tol,
                 "per_step": weight}
        self.row["max_abs_err"] = max(self.row["max_abs_err"], err)
        if weight:
            b, kind = bound_ms(nbytes, flops, peak)
            check.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=b, bound_by=kind)
            self.row["ms"] += weight * ms
            self.step_ms[step] += weight * ms
            self.row["plain_ms"] += weight * plain_ms
            self.row["bound_ms"] += weight * b
            self._bytes_ms += weight * nbytes / HBM_BYTES_S * 1e3
            self._ops_ms += weight * flops / peak * 1e3
            if library_ms is None:
                self._library_missing = True
            else:
                self.row["library_ms"] += weight * library_ms
        self.checks.append(check)
        log(f"  {self.row['name']:16s} {label:44s} err={err:.3e} "
            f"tol={tol} {'ok' if ok else 'FAIL'}"
            + (f"  kernel={ms:.4f}ms plain={plain_ms:.4f}ms library="
               f"{'n/a' if library_ms is None else f'{library_ms:.4f}ms'} "
               f"bound={check['bound_ms']:.4f}ms ({check['bound_by']})"
               if weight else ""))
        return ok

    def finish(self):
        self.row["bound_by"] = ("bytes" if self._bytes_ms >= self._ops_ms
                                else "operations")
        if self._library_missing:
            self.row["library_ms"] = None
        return self.row


def kernel_phase(torch, F, ops, ref, chunk: int, slots: int, skv: int,
                 timer, dev="cuda"):
    """Returns the three KernelReports; raises if any check fails."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    failed = []
    mm = KernelReport("matmul", "cuda", "src/repro_torch/kernels/csrc/matmul.cu",
                      "src/repro/kernels/matmul.py:102")
    log("kernels: matmul (tolerance |err| <= atol + rtol*|plain|)")
    for M, step in ((chunk, "prefill"), (slots, "decode")):
        for label, K, N in LLAMA_GEMMS + (LLAMA_HEAD,):
            a, b = randn(M, K), randn(K, N, scale=K ** -0.5)
            got, want = ops.matmul(a, b), ref.matmul_ref(a, b)
            ok, err = within(got, want, **MM_TOL)
            weight = 1 if label == "lm_head" else 32
            ms = timer(lambda: ops.matmul(a, b))
            plain = timer(lambda: ref.matmul_ref(a, b))
            lib = timer(lambda: torch.matmul(a, b))
            if not mm.add(f"{label} M={M} K={K} N={N}", ok, err, MM_TOL,
                          step, weight, ms, plain, lib,
                          nbytes=2 * (M * K + K * N + M * N),
                          flops=2 * M * K * N):
                failed.append(f"matmul {label} M={M}")
            del a, b, got, want
    # epilogues and ragged edges (correctness only)
    cases = [("bias+silu", chunk, 4096, 4096, "silu", True, False),
             ("bias+gelu", chunk, 4096, 4096, "gelu", True, False),
             ("bias", slots, 1024, 3072, None, True, False),
             ("ragged scalar-path", 37, 100, 77, None, True, False),
             ("ragged 16B-path", 5, 136, 200, "silu", False, False),
             ("ragged b^T (tied head)", 70, 1024, 1000, None, False, True),
             ("b^T decode", slots, 1024, 4104, None, False, True)]
    for label, M, K, N, act, with_bias, trans in cases:
        a = randn(M, K)
        b = (randn(N, K, scale=K ** -0.5).t() if trans
             else randn(K, N, scale=K ** -0.5))
        bias = randn(N) if with_bias else None
        got = ops.matmul(a, b, bias, activation=act)
        want = ref.matmul_ref(a, b, bias, act)
        ok, err = within(got, want, **MM_TOL)
        if not mm.add(f"{label} M={M} K={K} N={N}", ok, err, MM_TOL):
            failed.append(f"matmul {label}")

    fa = KernelReport("flash_attention", "cuda",
                      "src/repro_torch/kernels/csrc/flash_attention.cu",
                      "src/repro/kernels/flash_attention.py:102")
    log("kernels: flash_attention (hq=32, hkv=8, d=128)")
    hq, hkv, d = 32, 8, 128

    def fa_case(label, b, sq, q_off, kv_len, step=None, weight=0, window=0,
                softcap=0.0, d=d, hq=hq, hkv=hkv):
        q = randn(b, sq, hq, d)
        k, v = randn(b, skv, hkv, d), randn(b, skv, hkv, d)
        qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
        kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        kw = dict(window=window, softcap=softcap)
        got = ops.flash_attention(q, k, v, qo, kl, **kw)
        want = ref.attention_ref(q, k, v, qo, kl, **kw)
        ok, err = within(got, want, **FA_TOL)
        timing = {}
        if weight:
            mask = ref.attention_mask(sq, skv, qo, kl, window=window)
            visible = int(mask.sum()) * hq
            kv_needed = sum(min(x, skv) for x in kv_len) * hkv * d * 2 * 2
            timing = dict(
                ms=timer(lambda: ops.flash_attention(q, k, v, qo, kl, **kw)),
                plain_ms=timer(lambda: ref.attention_ref(q, k, v, qo, kl, **kw)),
                library_ms=timer(_sdpa(torch, F, q, k, v, mask)),
                nbytes=2 * 2 * q.numel() + kv_needed,
                flops=4 * d * visible)
        if not fa.add(label, ok, err, FA_TOL, step, weight, **timing):
            failed.append(f"flash_attention {label}")

    fa_case(f"prefill b=1 sq={chunk} skv={skv} q_offset=128", 1, chunk,
            [128], [128 + chunk], "prefill", 32)
    lens = [137, 64, 250, 9][:slots] + [1] * max(0, slots - 4)
    fa_case(f"decode b={slots} sq=1 skv={skv}", slots, 1, lens,
            [x + 1 for x in lens], "decode", 32)
    fa_case("window=48 softcap=30", 2, 40, [10, 100], [50, 140],
            window=48, softcap=30.0)
    fa_case("d=64 hq=hkv=16 (qwen1.5)", 2, 33, [0, 7], [33, 40], d=64,
            hq=16, hkv=16)
    fa_case("fully masked rows give 0", 2, 3, [0, 5], [0, 0])

    rn = KernelReport("rmsnorm", "triton", "src/repro_torch/kernels/rmsnorm.py",
                      "src/repro/kernels/rmsnorm.py:30")
    log("kernels: rmsnorm (h=4096)")
    for rows, step, weight in ((chunk, "prefill", 65), (slots, "decode", 65),
                               (37, None, 0)):
        x = randn(rows, 4096)
        g = torch.randn(4096, generator=gen, device=dev)
        got, want = ops.rmsnorm(x, g, eps=1e-5), ref.rmsnorm_ref(x, g, 1e-5)
        ok, err = within(got, want, **RN_TOL)
        timing = {}
        if weight:
            gb = g.to(torch.bfloat16)
            timing = dict(
                ms=timer(lambda: ops.rmsnorm(x, g, eps=1e-5)),
                plain_ms=timer(lambda: ref.rmsnorm_ref(x, g, 1e-5)),
                library_ms=timer(lambda: F.rms_norm(x, (4096,), gb, 1e-5)),
                nbytes=2 * 2 * x.numel() + 4 * g.numel(),
                flops=4 * x.numel(), peak=FP32_TFLOPS)
        if not rn.add(f"rows={rows} h=4096", ok, err, RN_TOL, step, weight,
                      **timing):
            failed.append(f"rmsnorm rows={rows}")
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failed}")
    return mm, fa, rn


def _sdpa(torch, F, q, k, v, mask):
    """The library yardstick: one scaled_dot_product_attention call on the
    same inputs (heads-first views; GQA by enable_gqa)."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    m = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m,
                                                  enable_gqa=True)


# ---------------------------------------------------------------------------
# Phases 2 and 4: the paged server, as a user starts it.
# ---------------------------------------------------------------------------

SERVE = dict(slots=4, prefill_chunk=64, page_size=16, max_seq=272, max_new=16)
PROMPT_LEN = 256   # prompt lengths are drawn from [64, 256]


def launches_per_step(cfg) -> dict:
    """Kernel launches of one paged step of a dense rmsnorm/swiglu model at
    d1 = d2 = 1: two entry norms per layer and the final norm; the fused
    q/k/v, wo, fused up+gate and down GEMMs per layer and the head; one
    attention core per layer."""
    n = cfg.num_layers
    return {"matmul": 4 * n + 1, "flash_attention": n, "rmsnorm": 2 * n + 1}


class StepMeter:
    """Wraps the server's step: counts its calls and sums their host time
    by kind (a prefill chunk feeds [1, chunk] tokens, a decode tick
    [slots, 1]).  The step hands back numpy tokens, so every call ends
    synchronised with the device and its host time covers its device
    work."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = {"prefill": 0, "decode": 0}
        self.seconds = {"prefill": 0.0, "decode": 0.0}

    def __call__(self, tokens, *rest):
        t0 = time.perf_counter()
        out = self.fn(tokens, *rest)
        kind = "prefill" if tokens.shape[1] > 1 else "decode"
        self.calls[kind] += 1
        self.seconds[kind] += time.perf_counter() - t0
        return out


def serve_phase(torch, cfg, requests: int, seed: int, dev="cuda",
                kernel_ms=None, profile: bool = False) -> dict:
    """Serve ``requests`` seeded prompts through ``make_paged_server`` and
    ``run_until_drained``; check every request and the page pool, and that
    each kernel launched exactly its per-step count times the steps taken.
    ``kernel_ms`` (the kernel phase's kernel time per prefill chunk and per
    decode tick) is set beside each step's mean wall time.  With
    ``profile`` the same requests are served once more under
    ``torch.profiler`` for the device's busy share and its time by kernel
    (the counts are read before).  Returns the launch counts of the run."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.runtime.server import Request

    t0 = time.perf_counter()
    prompts = serve.sample_prompts(cfg, requests, PROMPT_LEN, seed)
    scfg = serve.paged_server_config([len(p) for p in prompts], **SERVE)
    server, _ = serve.make_paged_server(
        cfg, scfg, lm.init_params(cfg, seed=seed, device=dev), device=dev)
    meter = StepMeter(server.step_fn)
    server.step_fn = meter
    for rid, p in enumerate(prompts):
        server.submit(Request(rid=rid, prompt=p, max_new=SERVE["max_new"]))
    if dev == "cuda":
        torch.cuda.synchronize()
    log(f"serve {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {requests} requests of "
        f"{[len(p) for p in prompts]} prompt tokens, {SERVE}; set-up "
        f"{time.perf_counter() - t0:.1f}s"
        + (f", device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB"
           if dev == "cuda" else ""))

    ops.reset_launches()
    t0 = time.perf_counter()
    ticks = server.run_until_drained()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)

    done = sorted(server.completed, key=lambda r: r.rid)
    assert [r.rid for r in done] == list(range(requests)), "requests lost"
    for r in done:
        assert len(r.out) == SERVE["max_new"], (r.rid, r.out)
        assert all(0 <= t < cfg.vocab_size for t in r.out), (r.rid, r.out)
    assert server.alloc.free_pages == scfg.paged.num_pages - 1, \
        "pages did not return to the pool"
    steps = sum(meter.calls.values())
    want = {k: v * steps for k, v in launches_per_step(cfg).items()}
    assert launches == want, f"launches {launches}, expected {want}"

    prefill_tok = sum(len(p) for p in prompts)
    decode_tok = requests * (SERVE["max_new"] - 1)
    log(f"  served {requests} requests in {ticks} ticks, {wall:.3f}s: "
        f"{meter.calls['prefill']} prefill chunks "
        f"{meter.seconds['prefill']:.3f}s "
        f"({prefill_tok / meter.seconds['prefill']:.1f} prompt tok/s), "
        f"{meter.calls['decode']} decode ticks {meter.seconds['decode']:.3f}s "
        f"({decode_tok / meter.seconds['decode']:.1f} new tok/s)")
    for kind, ms in (kernel_ms or {}).items():
        wall_ms = 1e3 * meter.seconds[kind] / meter.calls[kind]
        log(f"  {kind}: {wall_ms:.2f} ms per step, of which the kernels "
            f"{ms:.2f} ms ({ms / wall_ms:.0%}; kernel phase's times)")
    log(f"  launches over {steps} steps: {launches} (= per step "
        f"{launches_per_step(cfg)} x {steps})")
    log(f"  request 0 -> {done[0].out}")
    if profile:
        profile_run(torch, server, prompts, cfg.name, wall)
    del server, meter  # the step holds the weights
    if dev == "cuda":
        torch.cuda.empty_cache()
    return launches


def profile_run(torch, server, prompts, name: str, wall_s: float) -> None:
    """Serve ``prompts`` again under ``torch.profiler``: the device time of
    the run (the sum over device kernels, as the profiler's own table
    totals it) against the profiled wall time and against ``wall_s``, the
    same run's wall time without the profiler, and the device time by
    kernel (the table goes to ``chiprun_out/profile_<name>.txt``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.server import Request

    for rid, p in enumerate(prompts):
        server.submit(Request(rid=1000 + rid, prompt=p,
                              max_new=SERVE["max_new"]))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run_until_drained()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    (OUT_DIR / f"profile_{name}.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=25))
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"  profiled rerun: device busy {device_ms:.1f} ms, "
        f"{device_ms / wall_ms:.0%} of its {wall_ms:.1f} ms wall and "
        f"{device_ms / (1e3 * wall_s):.0%} of the unprofiled run's "
        f"{1e3 * wall_s:.1f} ms; by kernel:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
            f"{e.key[:70]}")


# ---------------------------------------------------------------------------
# Phase 3: the path on the card against the path on the CPU.
# ---------------------------------------------------------------------------

#: per-row relative L2 error of the logits, card (bf16, kernels) against
#: CPU (fp32, plain versions).  bf16 keeps 8 significant bits (relative
#: spacing 2^-8 = 0.0039), and the path rounds the residual stream and
#: every GEMM output to bf16 at about a dozen points in two layers.  The
#: plain versions run in bf16 on the CPU, at the 2-layer reduced width,
#: show 1.95e-2 against fp32; the kernels round at the same points or at
#: fewer (fp32 probabilities), so the limit is 2.5 times that.
PATH_TOL = 5e-2


def path_check(torch, cfg, seed: int, dev="cuda") -> None:
    """Two prefill chunks (slots 0 and 1) and one decode tick (4 slots, two
    live) of ``lm.paged_step`` on ``dev`` in the model dtype and on the CPU
    in fp32 from the same weights; the logits must agree within
    ``PATH_TOL``."""
    import numpy as np

    from repro_torch.core.atp import make_context
    from repro_torch.core.mesh import atp_topo
    from repro_torch.models import lm
    from repro_torch.models.paging import PageAllocator, PagedConfig

    topo = atp_topo(1, 1, 1)
    chunk, slots = SERVE["prefill_chunk"], SERVE["slots"]
    pcfg = PagedConfig(page_size=SERVE["page_size"], num_pages=16,
                       pages_per_slot=-(-SERVE["max_seq"] // SERVE["page_size"]))
    alloc = PageAllocator(pcfg, slots)
    alloc.ensure(0, chunk + 1)
    alloc.ensure(1, chunk + 1)
    table = alloc.table()
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (slots, chunk + 1), dtype=np.int32)
    calls = [  # (tokens, start, table, rows compared)
        (toks[0:1, :chunk], [0], table[0:1], 1),
        (toks[1:2, :chunk], [0], table[1:2], 1),
        (toks[:, chunk:], [chunk, chunk, 0, 0], table, 2),
    ]
    params = lm.shard_params(cfg, lm.init_params(cfg, seed=seed, device=dev),
                             lm.layout_context(topo, 0))
    cpu_params = lm.tree_map(lambda t: t.cpu().float(), params)
    logits = []
    for where, p, dtype in ((dev, params, None),
                            ("cpu", cpu_params, torch.float32)):
        ctx = make_context(topo, device_type=where)
        caches = lm.init_paged_caches(cfg, ctx, pcfg, dtype=dtype,
                                      device=where)
        out = []
        with torch.no_grad():
            for tok, start, tab, _ in calls:
                got, caches = lm.paged_step(
                    ctx, cfg, p, torch.as_tensor(tok, device=where),
                    torch.as_tensor(np.asarray(start, np.int32), device=where),
                    torch.as_tensor(tab, device=where), caches)
                out.append(got.float().cpu())
        logits.append(out)
    worst, max_abs, agree, rows = 0.0, 0.0, 0, 0
    for (_, _, _, live), got, want in zip(calls, *logits):
        got, want = got[:live].flatten(0, 1), want[:live].flatten(0, 1)
        assert got.isfinite().all(), "non-finite logits on the card"
        rel = (got - want).norm(dim=-1) / want.norm(dim=-1)
        worst = max(worst, float(rel.max()))
        max_abs = max(max_abs, float((got - want).abs().max()))
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
        rows += got.shape[0]
    log(f"path-check {cfg.name} at {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}: {rows} logit rows, worst relative L2 error "
        f"{worst:.3e} (limit {PATH_TOL}), max abs error {max_abs:.3e}, "
        f"top-1 agreement {agree}/{rows}")
    assert worst <= PATH_TOL, f"path-check: relative error {worst:.3e}"


# ---------------------------------------------------------------------------
# Entry point.
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the port's sources (src/repro_torch) are missing",
              file=sys.stderr)
        return 2
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build, ops, ref

    OUT_DIR.mkdir(exist_ok=True)
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f}s wall "
        + " ".join(f"{k}={v:.1f}s" for k, v in built.items()))
    for name in _build.SOURCES:
        report = _build.library_path(name).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    from repro_torch.configs.registry import get_config

    reports = []
    if "kernels" in phases:
        reports = kernel_phase(torch, F, ops, ref,
                               chunk=SERVE["prefill_chunk"],
                               slots=SERVE["slots"], skv=SERVE["max_seq"],
                               timer=Timer(torch))
    llama = get_config("llama3-8b")
    if "serve-llama" in phases:
        # the main path: its counts are the ones the result line reports
        kernel_ms = {s: sum(r.step_ms[s] for r in reports)
                     for s in ("prefill", "decode")} if reports else None
        launches = serve_phase(torch, llama, requests=8, seed=0,
                               kernel_ms=kernel_ms, profile=True)
        for r in reports:
            r.row["launches"] = launches[r.row["name"]]
    if "path-check" in phases:
        # depth cut to 2 layers so that the fp32 CPU side stays small
        path_check(torch, dataclasses.replace(llama, num_layers=2), seed=0)
    if "serve-qwen" in phases:
        serve_phase(torch, get_config("qwen1.5-0.5b"), requests=4, seed=1)

    kernels = [r.finish() for r in reports]
    (OUT_DIR / "kernel_checks.json").write_text(json.dumps(
        [{"row": r.row, "checks": r.checks} for r in reports], indent=1))
    log(f"card: {card_line()}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
