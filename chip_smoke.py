#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as a release check runs it

Phases, in order, each failing the run on any error:

1. kernels -- build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` with nvcc, one process per source, then
   call each kernel at the shapes the llama3-8b and the zamba2-7b serving
   paths give it and hold it against its plain PyTorch version on the same
   inputs, with the tolerance stated beside each check: the block norms and
   the Mamba2 grouped, gated norm; the SSD scan with a state in and out and
   in its slot-addressed form (a pool updated in place, with permuted
   slots, a sentinel and a fresh row, the whole pool checked).  Times the
   kernel, its plain version, one library call for the same function where
   there is one (a yardstick the port never calls), and computes the least
   time the card could take (the bound).  Each timed matmul, attention and
   SSD shape prints the plan it took (``ops.matmul_plan``,
   ``ops.attention_plan``, ``ops.ssd_plan``), and a prefill chunk of the
   SSD scan is timed at every split of the head dim.  Also times an empty kernel
   with the same timer (its floor) and each wrapper's host cost per call.
2. serve-llama -- llama3-8b at full width and depth, random bf16 weights from
   a seed, through ``launch.serve.make_paged_server``: 8 requests of seeded
   prompt lengths in 64-256, 16 new tokens each, 4 slots, prefill chunk 64,
   page size 16.  The step runs as CUDA graphs (``launch.steps.
   CapturedStep``), captured at the first prefill chunk and the first
   decode tick: exactly two, each shape's warm-up and capture seconds and
   graph pool bytes printed.  Every count of kernel launches is set to 0
   just before and read just after; every kernel must have launched, at
   the per-step counts of one paged step (65 rmsnorm, 129 matmul, 32
   flash_attention) times the steps and the two warm-up runs (a replay
   counts what its capture recorded).  Then the same prompts through the
   uncaptured body (``info.plain``) and the captured step, five runs of
   each in turns (U C C U U C ...): every request's greedy tokens must
   equal the counted run's; the wall ms per prefill chunk and decode tick
   of both, and the replays' device time by CUDA events.  Last a profiled
   rerun through the graphs (busy share, launches a step, time by kernel).
3. path-check -- llama3-8b at full width with the depth cut to 2 layers: two
   prefill chunks and one decode tick of ``models.lm.paged_step`` on the card
   (kernels, bf16) and on the CPU (plain versions, fp32, from the same bf16
   weights); the logits must agree within the bf16 tolerance stated there
   (``PATH_TOL``), and the top-1 agreement is reported.
4. serve-qwen -- qwen1.5-0.5b at full size (qkv bias in the matmul
   epilogue, the head tied to the embedding), 4 requests, captured, and
   once more uncaptured for the tokens.
5. serve-zamba -- zamba2-7b at full width and all 81 layers (13 super-blocks
   of shared attention + 5 Mamba2 blocks, and 3 tail Mamba2 blocks), random
   bf16 weights from a seed, in the server's recurrent mode: 4 requests of
   seeded prompt lengths in 64-256, 16 new tokens each, 4 slots, prefill
   chunk 64, page size 16; the prompt tails go through the decode-shaped
   graph.  Graphs, launch counts, tokens, timed pairs and profile as in
   phase 2, at 283 matmul, 163 rmsnorm (95 block norms and 68 grouped
   norms), 13 flash_attention and 68 ssd_scan per step.  The result line's
   forward rows read their launches from it.
5b. serve-wave -- the wave baseline over contiguous decode caches
   (``launch.serve.make_wave_server``, ``launch.steps.build_decode_step``:
   one CUDA graph for a wave's prefill and one for its decode tick).
   qwen3-8b at its published widths, not cut (36 layers, d_model 4096, 32
   q / 8 kv heads of 128 with qk-norm, d_ff 12288, vocab 151936), random
   bf16 weights from a seed: a wave of 4 prompts of 256 tokens, 16 new
   each; then zamba2-7b with serve-zamba's weights (kept from that phase;
   built from its seed when it did not run): 4 prompts of 128 tokens.
   Each model's weights also serve the same prompts through a paged
   server (4 slots, prefill chunk 64, page size 16).  Every count is set
   to 0 just before the first captured wave and read just after: the
   per-step counts of the paged step times the wave's steps and its two
   warm-ups (printed with the attention's split by ``attention_plan``
   variant).  Then captured and uncaptured waves and the paged server in
   turns (``TIMED_PAIRS`` of each): every wave's tokens equal the counted
   run's, and the medians of the wall ms per prefill and per decode tick,
   and of the whole wave, are printed beside the paged server's for the
   same prompts.  The logits, uncaptured: the wave's first new token's
   logit rows within ``PATH_TOL`` (relative L2 a row) of the paged path's
   at the wave's own shapes (every prompt in one step, then the same
   ticks), and its tokens equal to that path's up to each request's first
   near-tie (a step whose top-2 logit gap is below ``NEAR_TIE`` in either
   path's logits); then against the paged path's last prefill chunk of
   64 and the paged server's tokens: qwen3-8b within ``PATH_TOL`` and up
   to a near-tie of ``NEAR_TIE``; zamba2-7b, whose bf16 rounding moves a
   row by more than that, within ``RECURRENT_FACTOR`` times the paged
   path's own distance between one step and chunks of 64, and up to a
   near-tie of twice the paths' largest logit difference (the requests
   that reach one, and where the tokens part, are printed).  Last the
   path check of ``path_check`` on the wave's prefill at the first
   layers of the same weights (``WAVE_PATH_LAYERS``): the first new
   token's rows on the card (kernels, bf16) against the CPU (plain, fp32)
   within ``PATH_TOL``, and for zamba2-7b the rows and the batch-row SSD
   state within ``RECURRENT_FACTOR`` times the plain bf16 path's error.
6. path-check-zamba -- zamba2-7b at full width with the depth cut to 7
   layers (one super-block and one tail Mamba2 block): slot 0's chunks at 0
   and 64 (the second carries the state), slot 1's chunk at 0, and one
   decode tick of 4 slots (2 live, 2 sentinel), card against CPU as in
   phase 3; the fp32 SSD state pools are compared too.
7. train-kernels -- at llama3-8b's training shapes (4096 wide, 32 q / 8
   kv heads of 128, d_ff 14336, vocab 128256, 2048 tokens), first each
   projection's matmul forward against its plain version as in phase 1 and
   its backward (dgrad and wgrad, wgrad reading ``a^T`` without a copy)
   against the plain backward (``matmul_steps``), then the attention with
   its fp32 log-sum-exp within 1e-3 at llama3-8b's, gpt-m2's, gpt-m3's and
   zamba2-7b's heads (``TRAIN_ATTENTION``: ``attention_plan``'s variant 1,
   ``flash_attention_train.cu``, also against its plain mirror
   ``ref.attention_train_ref``, and timed in turns with variant 0,
   ``flash_attention.cu``, forced through the plan) and the block norm,
   then the other
   backward kernels (flash_attention_bwd, rmsnorm_bwd) against their plain
   backward on the same bf16 inputs (the plain attention backward reads
   the plain forward's output and log-sum-exp): every gradient within a
   per-tensor relative L2 error of 2e-2, rmsnorm's fp32 dgamma of 1e-3;
   the attention backward also with rows that see no key and at s = 2100
   (not a multiple of 64) at 32 / 8 heads, and its dK/dV plan
   (``ops.attention_bwd_plan``: items, longest and mean) is printed.  All
   timed as in phase 1 against the bound, the timer's floor and the
   library call (torch.matmul, scaled_dot_product_attention, F.rms_norm;
   for the backward, their autograd backward); each timed matmul line
   names the plans it took, and the matmul at K = N = 4096 is timed on
   variants 1 and 2 at M = 256-2048 (what sets ``ops.TRAIN_M``).
   ``--parent DIR``: the matmul, flash_attention_bwd and rmsnorm backward
   kernels of the older checkout in DIR, built by its own ``_build`` into
   its own build directory (the matmul launched with that tree's plans
   and C arguments), timed interleaved with this tree's (parent, tree,
   tree, parent): the matmul forward and backward at each shape and per
   training step; the backward kernels' launches are also timed by the
   profiler, kernel by kernel.
7b. split-norm -- the split rmsnorm of a d2 > 1 mesh (``ops.split_rmsnorm``:
   a row's features on the tp2 ranks), its four kernels in
   ``csrc/rmsnorm.cu`` (forward partial ``rmsnorm_ss``, forward apply
   ``rmsnorm_apply``, backward partial ``rmsnorm_bwd_partial`` with the
   slice's dgamma, backward apply ``rmsnorm_bwd_apply``), one card playing
   the tp2 all-reduce: the d2 slices' row sums are added in one process.
   At llama3-8b (h 4096) and zamba2-7b (3584) at d2 = 2 and 4 and gemma2-2b
   (2304, its 1 + gamma) at d2 = 2, each at 2048, 64 and 4 rows (a training
   step, a prefill chunk, a decode tick): each kernel against its plain
   version on the same inputs (the fp32 partial sums within 1e-5 relative,
   y within one bf16 ulp, dx within ``SPLIT_DX_REL`` = 1e-3 relative L2 of
   the plain apply on the same rstd and dot), the slices' y against the
   whole-row kernel (``ops.rmsnorm``) within one bf16 ulp and against the
   fp32 whole row within ``RN_TOL``, dx against the whole-row backward
   kernel within 1e-3 relative L2 and dgamma within 1e-3.  Every count is
   set to 0 before the checked run and read after: each kernel launched d2
   times a shape (this slice's row of the result line).  Two planted
   faults must fail at every (arch, d2): the forward apply reading slice
   0's own sum of squares (the one-ulp check), and the backward apply
   reading slice 0's own dot (the 1e-3 check on dx).  Each kernel is timed at
   llama3-8b's 2048 training rows at d2 = 2 against its bound from bytes,
   its plain version and the whole-row kernel over the same rows; no
   PyTorch call computes the split form.
7c. int8-matmul -- the matmul's int8 ``scale`` mode (``csrc/matmul_int8.cu``,
   ``ops.matmul_int8``) on llama3-8b's three projections at 64 and 2048
   rows, with bias and gelu and with neither, each quantized from bf16 by
   ``ops.quantize_for_matmul`` as a user calls it; the launches counted
   (``ops.QUANT_LAUNCHES``, this path's row of the result line); each
   output against ``ref.matmul_int8_ref`` (bit for bit with no epilogue,
   within ``MM_TOL`` with it), a planted fault (the scale after the bias)
   that must fail, and each shape timed beside its bound (int8 peak or
   bytes), its plain version and ``torch._int_mm`` with the epilogue in
   torch.
7d. quant-wire -- llama3-8b at full width, 2 layers, one training step's
   forward and backward of 256 tokens on a (1, 2, 1) mesh of two processes
   on the card over gloo, on the bf16, int8 and fp8 wires (psum
   boundaries: the only collective this mesh issues is the all-reduce,
   the one gloo moves for CUDA tensors): the losses and each gradient
   within ``QUANT_TOL`` of the bf16 wire's and within ``QUANT_BWD`` of the
   same wire with the forward alone quantized, equal losses on both ranks,
   one quantized pmax and one quantized f32 all-reduce per row boundary in
   each forward record; the plain witness (``wire_witness_loss``, one
   process, no kernel of the port) on the same weights and batch, within
   ``QUANT_TOL`` too; a planted fault (each rank quantizing with its own
   amax, no pmax) must fail the loss's bound and the gradients'.
8. train -- ``launch.steps.build_train_step`` on llama3-8b at full width
   with the depth cut to 4 layers, b = 1, s = 2048, bf16 weights and fp32
   AdamW moments, remat on: 6 steps on one repeated batch; the loss must
   fall from step 1 to step 6.  Every count of kernel launches is set to 0
   just before the 6 steps and read just after: each forward and backward
   kernel must have launched its per-step count, every attention on the
   training kernel (``ops.ATTENTION_VARIANT_LAUNCHES``).  Prints ms per step,
   tokens/s, peak memory and the device's busy share in one profiled step,
   then the device time of the copies and casts by torch op and input
   shape in one more (``profile_train_ops.txt``).  This is this slice's
   main path: the backward rows of the result line take their launches
   from it.  ``--parent DIR``: then the training step of the tree in DIR
   and of this one, a process each, in turns (parent, tree, tree,
   parent).
9. path-check-train -- llama3-8b at full width with the depth cut to 2
   layers, b = 1, s = 256: the gradient of every parameter (norm scales
   included) on the card (kernels, bf16) against the CPU (plain versions,
   fp32, from the same bf16 weights), within a per-tensor relative L2 error
   of 5e-2 (``PATH_TOL``); the card's attention runs the training kernel
   (every training path check's s is at least 128).
10. train-zamba-kernels -- at zamba2-7b's training shapes (b = 1, s = 2048,
   112 SSD heads of 64, chunk 64; 32 / 32 attention heads of 112), the two
   Mamba2 backward kernels against their plain backward on the same bf16
   inputs: ``ssd_scan_bwd`` (dx, dB, dC within 2e-2 relative L2; ddt,
   dA_log, dD, fp32 sums in another order, within 1e-3) and the grouped,
   gated norm's backward (dy, dgate within 2e-2, dgamma within 1e-3, the
   gate read through its stride), timed as in phase 1 against the bound,
   the plain version and the timer's floor (no PyTorch call computes
   either), each also at every grid its plan chooses among (heads a block
   of ``ops.ssd_bwd_plan``, token shares of ``ops.group_rmsnorm_bwd_plan``)
   and kernel by kernel with the profiler (the SSD entry's four kernels:
   ``ssd_bwd_chunk_kernel``, ``ssd_bwd_pass_kernel``,
   ``ssd_bwd_grad_kernel``, ``ssd_bwd_reduce_kernel``); the SSD backward's
   bounds are printed three ways (the function's bytes, its operations at
   the bf16 peak, the design's own bytes and products).  ``--parent DIR``:
   the two kernels of the older checkout in DIR (its C entries, which take
   this tree's arguments, called through this tree's wrappers) timed in
   turns with this tree's (parent, tree, tree, parent).  Then the nine projections'
   matmul forward and backward at M = 2048 (``matmul_steps``: checked,
   timed against the bound and the library, and with ``--parent DIR`` in
   turns with DIR's kernel, per shape and per training step; B|C|dt, whose
   B is small, also on variant 0), and for correctness
   every other forward kernel at the shapes the zamba step gives it,
   within phase 1's limits (the block norm over rows of 3584, the grouped,
   gated norm over 2048 x 112 rows of 64, the SSD scan from zeros over 32
   chunks with its final state, the attention at head dim 112 with its
   log-sum-exp), and the backward shapes the llama phases do not meet:
   the rmsnorm backward over rows of 3584 and the attention backward at
   head dim 112 with a GQA group of 1.
11. train-zamba -- ``build_train_step`` on zamba2-7b at its published
   widths, depth cut to 14 layers (two super-blocks of the shared block
   and 5 Mamba2 blocks, and a 2-block Mamba2 tail), b = 1, s = 2048, bf16
   weights and fp32 AdamW moments (zero1), remat on: 6 steps on one
   repeated batch, the loss must fall; every launch count is set to 0
   just before the 6 steps and read just after, and must equal the count
   derived from the block structure (``train_launches_per_step``).
   Prints ms per step, tokens/s, peak memory and, in one profiled step,
   the device's busy share, its launches and its time by kernel.  The
   result line's two Mamba2 backward rows take their launches from it.
   ``--parent DIR``: then the zamba training step of the tree in DIR and of
   this one, a process each, in turns (parent, tree, tree, parent).
12. path-check-train-zamba -- zamba2-7b at full width with the depth cut
   to 7 layers (one super-block and a one-block tail), b = 1, s = 128 (two
   SSD chunks, so the state's gradient crosses a chunk): every gradient
   on the card (kernels, bf16) against the CPU (plain versions, fp32, from
   the same bf16 weights), and the plain versions on the CPU in bf16
   against the same; each gradient within ``PATH_TOL`` or within
   ``RECURRENT_FACTOR`` times the plain bf16 path's own error (bf16
   gradients of this model are O(1) from fp32 upstream of the last block,
   in the reference too).  Then the backward kernels on one forward: the
   same step with the plain backward versions run on the card (the same
   loss bit for bit, no backward kernel launched), every gradient of the
   kernels within ``PATH_TOL`` of it; and a planted fault
   (``ssd_scan_bwd``'s dB set to zero) must break that limit.
13. train-gpt-kernels -- at gpt-m2's training shapes (the paper's Table 2
   GPT: d_model 4096, 32 heads of 128 with no GQA, d_ff 16384, vocab
   51200, no RoPE; b = 1, s = 2048): its five GEMMs forward and backward
   as in phase 7 (``matmul_steps``); the up projection also writing its
   pre-activation (``ops._matmul(..., z_out=True)``): z must equal the
   launch without the activation and y the launch without z, bit for bit,
   and it is timed beside the launch without z; the activation's
   derivative (``csrc/act_bwd.cu``) within one bf16 ulp of
   ``ref.epilogue_bwd`` for gelu and silu, timed against its bound, the
   plain version and ``aten.gelu_backward``; the attention forward with
   its log-sum-exp and its backward at 32 / 32 heads (a GQA group of 1),
   timed against SDPA.
14. train-gpt -- ``build_train_step`` on gpt-m2 at its own 4 layers (a
   whole model: 1.23 B parameters), b = 1, s = 2048, zero1, remat on, as
   phase 8: 6 steps on one batch, the loss must fall, launch counts equal
   to ``train_launches_per_step`` (a LayerNorm model launches no rmsnorm;
   one activation derivative per gelu MLP), ms a step, tokens/s, peak
   memory and a profiled step; then gpt-m1 and gpt-m3 (4.06 B parameters,
   about 61 GiB at its peak) at their 4 layers, the same steps and checks
   without the profiled steps.  ``--parent DIR``: then gpt-m2's step of
   the tree in DIR and of this one, a process each, in turns.
15. path-check-train-gpt -- gpt-m2 at 2 layers, b = 1, s = 512 (so that
   the up projection's pre-activation comes from variant 2): the loss and
   every gradient on the card against the CPU's fp32 plain path within
   ``PATH_TOL``; then the same step with ``activation_backward`` swapped
   for its plain version on the card (the same loss bit for bit, no
   derivative kernel launched), every gradient within ``PATH_TOL`` of the
   kernels'; and a planted fault (``activation_backward`` passing ``dy``
   on unchanged) must break that limit.
16. plan -- the strategy stack (``core.plan``, ROADMAP A6) driving the
   port: ``launch.plan_smoke.paper_plans()`` (the paper's Fig. 10 and
   Fig. 11 searches) must equal ``BENCH_paper_plans.json`` key for key,
   predicted costs included; ``launch.train.pick_plan``'s top four plans
   for gpt-m1..m4 at b = 4, s = 2048 on ``h100-sxm-8`` (tp 8) and
   ``h100-sxm-2x8`` (tp 16) are printed with their modelled t_comm,
   t_exposed and t_gemm (cost-model output, not measurements); gpt-m2 at
   its 4 layers, b = 1, s = 2048, trains 3 zero1 steps from the plan
   ``pick_plan`` searches on ``h100-sxm-8`` at tp 1, from that plan saved
   (``plan_gpt-m2.json`` in the output directory) and loaded, each of its
   steps under the collective record (``analysis.signature``), and from the loose
   topology (1, 1, 1): the contexts must be equal (the loose one by its
   segment views, as it carries no segment entries), the losses equal bit
   for bit and the record empty outside ``opt:*``; qwen1.5-0.5b serves 4
   requests through ``make_paged_server(plan=...)`` with a plan that
   carries a decode sub-plan (decode batch 4), every request's greedy
   tokens equal to those of the server built from the topology.

17. calibrate -- ``core.calibrate.calibrate_mesh(8, h100-sxm-8)`` in this
   one process: no factorization of tp 8 fits one rank, so the table is
   empty, and ``launch.train.pick_plan`` for gpt-m4 at tp 8 with it gives
   the analytic search's plan (d1, d2, chunks, boundary mode and the
   predicted costs, printed both ways; model output, not measurements).

Prints the card's name and power limit, the kernels' build time and each
kernel's registers and spills from the build report, one JSON
line ``{"kernels": [...]}`` (one row per kernel: the four forward kernels
at the zamba2-7b path's shapes and launches, the three backward kernels
and the training attention kernel at the llama3-8b training step's, the
two Mamba2 backward kernels at the zamba
training step's, the activation's derivative at the gpt-m2 training
step's, the four split rmsnorm kernels at the split-norm phase's launches
and a launch's time at llama3-8b's training rows at d2 = 2, the int8
matmul at the int8-matmul phase's twelve projections; the llama3-8b serving rows and the training steps' other rows go
to the log and, with every check, to
``kernel_checks.json`` in the output directory) and, last,
``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, where no CUDA device is present or the
port's sources are missing.  Long outputs go to ``chiprun_out/``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
PHASES = ("kernels", "serve-llama", "path-check", "serve-qwen",
          "serve-zamba", "serve-wave", "path-check-zamba", "train-kernels",
          "split-norm", "int8-matmul", "quant-wire", "train",
          "path-check-train", "train-zamba-kernels", "train-zamba",
          "path-check-train-zamba", "train-gpt-kernels", "train-gpt",
          "path-check-train-gpt", "plan", "calibrate")
#: the serving path whose forward rows the result line reports
MAIN = "zamba2-7b"
#: the training path: the backward rows of the result line
TRAIN = "train"
#: the zamba2-7b training path: the Mamba2 backward rows
TRAIN_ZAMBA = "train-zamba"
#: the paper's gpt-m2 training path: the activation derivative's row
TRAIN_GPT = "train-gpt"
#: the split rmsnorm's checked run (d2 > 1): its four kernels' rows
SPLIT = "split-norm"
#: the int8 matmul's checked run: the quantized llama3-8b projections
INT8 = "int8-matmul"

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

LLAMA_GEMMS = (  # (name, K, N, launches per step) of llama3-8b's projections
    ("fused_qkv", 4096, 6144, 32), ("wo", 4096, 4096, 32),
    ("fused_up_gate", 4096, 28672, 32), ("down", 14336, 4096, 32),
    ("lm_head", 4096, 128256, 1),
)
ZAMBA_GEMMS = (  # the same for zamba2-7b: 68 Mamba2 blocks, 13 shared blocks
    ("mamba z|x", 3584, 14336, 68), ("mamba B|C|dt", 3584, 240, 68),
    ("mamba out", 7168, 3584, 68), ("shared in-proj", 3584, 3584, 26),
    ("fused_qkv", 3584, 10752, 13), ("wo", 3584, 3584, 13),
    ("fused_up_gate", 3584, 28672, 13), ("down", 14336, 3584, 13),
    ("lm_head", 3584, 32000, 1),
)
MM_TOL = dict(atol=1e-2, rtol=1.6e-2)     # bf16 output: 2 ulp at |x|~1
FA_TOL = dict(atol=2e-2, rtol=2e-2)       # + bf16 vs fp32 probabilities
RN_TOL = dict(atol=1e-2, rtol=1.6e-2)     # bf16 output rounding (and gate)
SSD_TOL = dict(atol=1e-2, rtol=1.6e-2)    # bf16 y
#: fp32 state: the kernel sums in another order, and its expf may differ
#: from torch's exp by an ulp
SSD_STATE_TOL = dict(atol=1e-3, rtol=1e-3)


class KernelReport:
    """One kernel's checks, and per serving path its totals over one
    prefill chunk plus one decode tick (each shape weighted by its launches
    per step) and its kernel time in each of the two steps.  ``floor_ms``,
    the timer's own time for an empty kernel, is printed beside each timed
    shape."""

    def __init__(self, name, route, source, replaces, floor_ms=None):
        self.meta = {"name": name, "route": route, "source": source,
                     "replaces": replaces}
        self.floor_ms = floor_ms
        self.checks = []
        self.max_err = 0.0
        self.paths = {}

    def _path(self, path):
        return self.paths.setdefault(path, {
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
            "bytes_ms": 0.0, "ops_ms": 0.0, "library_missing": False,
            "step_ms": {"prefill": 0.0, "decode": 0.0, "train": 0.0}})

    def add(self, label, ok, err, tol, path=None, step=None, weight=0,
            ms=None, plain_ms=None, library_ms=None, nbytes=0.0, flops=0.0,
            peak=BF16_TFLOPS, fp32_bound=False):
        """One check; with ``ms`` it is timed, and with ``weight`` launches
        per ``step`` ("prefill" or "decode") of ``path`` it also counts
        towards that path's totals.  ``fp32_bound``: also print the bound
        at the fp32 peak (a kernel whose products run on bf16 tensor cores
        for fp32 accuracy)."""
        check = {"shape": label, "ok": ok, "max_abs_err": err, "tol": tol,
                 "path": path, "per_step": weight}
        self.max_err = max(self.max_err, err)
        if ms is not None:
            b, kind = bound_ms(nbytes, flops, peak)
            check.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=b, bound_by=kind)
        if weight:
            t = self._path(path)
            t["ms"] += weight * ms
            t["step_ms"][step] += weight * ms
            t["plain_ms"] += weight * plain_ms
            t["bound_ms"] += weight * check["bound_ms"]
            t["bytes_ms"] += weight * nbytes / HBM_BYTES_S * 1e3
            t["ops_ms"] += weight * flops / peak * 1e3
            if library_ms is None:
                t["library_missing"] = True
            else:
                t["library_ms"] += weight * library_ms
        self.checks.append(check)
        lib = check.get("library_ms")
        log(f"  {self.meta['name']:16s} {label:60s} err={err:.3e} "
            f"tol={tol} {'ok' if ok else 'FAIL'}"
            + (f"  kernel={ms:.4f}ms plain={plain_ms:.4f}ms library="
               f"{'n/a' if lib is None else f'{lib:.4f}ms'} "
               f"bound={check['bound_ms']:.4f}ms ({check['bound_by']})"
               + (f" fp32-bound={bound_ms(nbytes, flops, FP32_TFLOPS)[0]:.4f}ms"
                  if fp32_bound else "")
               + (f" floor={self.floor_ms:.4f}ms"
                  if self.floor_ms is not None else "")
               if ms is not None else ""))
        return ok

    def step_ms(self, path, step):
        t = self.paths.get(path)
        return t["step_ms"][step] if t else 0.0

    def row(self, path, launches: int) -> dict:
        """The result line's row: ``path``'s totals per step pair."""
        t = self._path(path)
        return {**self.meta, "launches": launches,
                "max_abs_err": self.max_err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                             else "operations"),
                "library_ms": None if t["library_missing"] else t["library_ms"]}


def ssd_cost(b, s, nh, hd, ds, chunk, reads, writes):
    """(bytes, flops) of one SSD scan: x, y, B, C, dt, A_log and D each
    moved once, and the state of ``reads`` batch rows read and of
    ``writes`` written (a fresh or sentinel row reads none, a sentinel
    writes none); per head and chunk of length l, the causal halves of
    C.B^T and of its product with x, C.state^T and the state update."""
    nbytes = (2 * 2 * b * s * nh * hd + 2 * 2 * b * s * ds + 4 * b * s * nh
              + 8 * nh + 4 * nh * hd * ds * (reads + writes))
    flops = 0
    for c0 in range(0, s, chunk):
        n = min(chunk, s - c0)
        flops += n * (n + 1) * (ds + hd) + 4 * n * hd * ds
    return nbytes, b * nh * flops


def kernel_phase(torch, F, ops, ref, chunk: int, slots: int, skv: int,
                 timer, dev="cuda"):
    """Returns the four KernelReports; raises if any check fails."""
    gen = torch.Generator(device=dev).manual_seed(0)
    floor = None
    if dev == "cuda":
        # an empty kernel (a spin of 0 cycles) under the same timer: what
        # the flush, the events and a launch cost by themselves
        floor = timer(lambda: torch.cuda._sleep(0))
        log(f"kernels: timer floor {floor:.4f} ms (an empty kernel, timed as "
            f"every kernel below is)")

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    failed = []
    mm = KernelReport("matmul", "cuda", "src/repro_torch/kernels/csrc/matmul.cu",
                      "src/repro/kernels/matmul.py:102", floor)
    for path, gemms in (("llama3-8b", LLAMA_GEMMS), ("zamba2-7b", ZAMBA_GEMMS)):
        log(f"kernels: matmul at {path}'s shapes (tolerance |err| <= atol + "
            f"rtol*|plain|)")
        for M, step in ((chunk, "prefill"), (slots, "decode")):
            for label, K, N, weight in gemms:
                plan = ops.matmul_plan(M, N, K)
                a, b = randn(M, K), randn(K, N, scale=K ** -0.5)
                got, want = ops.matmul(a, b), ref.matmul_ref(a, b)
                ok, err = within(got, want, **MM_TOL)
                ms = timer(lambda: ops.matmul(a, b))
                plain = timer(lambda: ref.matmul_ref(a, b))
                lib = timer(lambda: torch.matmul(a, b))
                if not mm.add(f"{label} M={M} K={K} N={N} [{plan.name} "
                              f"stream-K blocks={plan.blocks} "
                              f"share<={plan.max_share}]", ok, err, MM_TOL,
                              path, step, weight, ms, plain, lib,
                              nbytes=2 * (M * K + K * N + M * N),
                              flops=2 * M * K * N):
                    failed.append(f"matmul {path} {label} M={M}")
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
                      "src/repro/kernels/flash_attention.py:102", floor)

    def fa_case(label, b, sq, q_off, kv_len, path=None, step=None, weight=0,
                window=0, softcap=0.0, d=128, hq=32, hkv=8):
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
        plan = ops.attention_plan(b, sq, hq, hkv, skv, d=d)
        label += (f" [variant {plan.variant} row_tiles={plan.row_tiles} "
                  f"splits={plan.splits}]")
        if not fa.add(label, ok, err, FA_TOL, path, step, weight, **timing):
            failed.append(f"flash_attention {label}")

    lens = [137, 64, 250, 9][:slots] + [1] * max(0, slots - 4)
    for path, d, hq, hkv, weight in (("llama3-8b", 128, 32, 8, 32),
                                     ("zamba2-7b", 112, 32, 32, 13)):
        log(f"kernels: flash_attention at {path}'s shapes (hq={hq}, "
            f"hkv={hkv}, d={d})")
        heads = dict(d=d, hq=hq, hkv=hkv)
        fa_case(f"prefill b=1 sq={chunk} skv={skv} q_offset=128 d={d}", 1,
                chunk, [128], [128 + chunk], path, "prefill", weight, **heads)
        fa_case(f"decode b={slots} sq=1 skv={skv} d={d}", slots, 1, lens,
                [x + 1 for x in lens], path, "decode", weight, **heads)
    fa_case("window=48 softcap=30", 2, 40, [10, 100], [50, 140],
            window=48, softcap=30.0)
    fa_case("d=64 hq=hkv=16 (qwen1.5)", 2, 33, [0, 7], [33, 40], d=64,
            hq=16, hkv=16)
    fa_case("d=112 ragged rows, fully masked row", 2, 37, [0, 5], [37, 0],
            d=112, hq=4, hkv=4)
    fa_case("fully masked rows give 0", 2, 3, [0, 5], [0, 0])

    rn = KernelReport("rmsnorm", "cuda",
                      "src/repro_torch/kernels/csrc/rmsnorm.cu",
                      "src/repro/kernels/rmsnorm.py:30", floor)
    for path, h, eps, weight in (("llama3-8b", 4096, 1e-5, 65),
                                 ("zamba2-7b", 3584, 1e-6, 95)):
        log(f"kernels: rmsnorm at {path}'s shapes (h={h})")
        for rows, step, w in ((chunk, "prefill", weight),
                              (slots, "decode", weight), (37, None, 0)):
            x = randn(rows, h)
            g = torch.randn(h, generator=gen, device=dev)
            got, want = ops.rmsnorm(x, g, eps=eps), ref.rmsnorm_ref(x, g, eps)
            ok, err = within(got, want, **RN_TOL)
            timing = {}
            if w:
                gb = g.to(torch.bfloat16)
                timing = dict(
                    ms=timer(lambda: ops.rmsnorm(x, g, eps=eps)),
                    plain_ms=timer(lambda: ref.rmsnorm_ref(x, g, eps)),
                    library_ms=timer(lambda: F.rms_norm(x, (h,), gb, eps)),
                    nbytes=2 * 2 * x.numel() + 4 * g.numel(),
                    flops=4 * x.numel(), peak=FP32_TFLOPS)
            plan = ops.rmsnorm_plan(rows, h)
            if not rn.add(f"rows={rows} h={h} [{plan.name}]", ok, err, RN_TOL,
                          path, step, w, **timing):
                failed.append(f"rmsnorm {path} rows={rows}")
    nh, hd = 112, 64
    log(f"kernels: the grouped, gated norm of zamba2-7b's Mamba2 blocks "
        f"(rows of {hd}, a scale row per head of {nh}; the gate a slice of "
        f"the z|x output)")
    for label, b, s, step in (("prefill b=1 s=64", 1, chunk, "prefill"),
                              (f"decode b={slots} s=1", slots, 1, "decode"),
                              ("one-token b=1 s=1", 1, 1, None)):
        y = randn(b, s, nh, hd)
        g = torch.randn(nh, hd, generator=gen, device=dev)
        z = randn(b, s, 2 * nh * hd)[..., :nh * hd].unflatten(-1, (nh, hd))
        got = ops.group_rmsnorm(y, g, gate=z)
        want = ref.group_rmsnorm_ref(y, g, 1e-6, z)
        ok, err = within(got, want, **RN_TOL)
        timing = dict(
            ms=timer(lambda: ops.group_rmsnorm(y, g, gate=z)),
            plain_ms=timer(lambda: ref.group_rmsnorm_ref(y, g, 1e-6, z)),
            library_ms=None, nbytes=2 * 3 * y.numel() + 4 * g.numel(),
            flops=8 * y.numel(), peak=FP32_TFLOPS)
        plan = ops.rmsnorm_plan(b * s * nh, hd)
        if not rn.add(f"grouped+gate {label} ({b * s * nh} rows of {hd}) "
                      f"[{plan.name}]", ok, err, RN_TOL, "zamba2-7b", step,
                      68 if step else 0, **timing):
            failed.append(f"rmsnorm grouped {label}")

    ssd = KernelReport("ssd_scan", "cuda",
                       "src/repro_torch/kernels/csrc/ssd_scan.cu",
                       "src/repro/kernels/ssd_scan.py:74", floor)
    ds, ssd_chunk, pool_slots = 64, 64, 4
    log(f"kernels: ssd_scan at zamba2-7b's shapes (nh={nh}, hd={hd}, "
        f"ds={ds}, chunk={ssd_chunk}); y and the state both checked")

    def ssd_inputs(b, s, nh=nh):
        x = randn(b, s, nh, hd)
        dt = F.softplus(torch.randn(b, s, nh, generator=gen, device=dev))
        A_log = torch.randn(nh, generator=gen, device=dev) * 0.5
        D = torch.randn(nh, generator=gen, device=dev)
        bc = randn(b, s, 2 * ds)     # B and C are halves of one tensor
        return x, dt, A_log, bc[..., :ds], bc[..., ds:], D

    # the state in and out as tensors (the kernel phase of earlier trees)
    for label, b, s, with_state in (
            ("prefill b=1 s=64, state in", 1, 64, True),
            (f"decode b={slots} s=1, state in", slots, 1, True),
            ("one-token b=1 s=1, state in", 1, 1, True),
            ("long prompt b=1 s=1024 (16 chunks)", 1, 1024, False),
            ("ragged b=2 s=100, state in", 2, 100, True)):
        args = ssd_inputs(b, s)
        st = (torch.randn(b, nh, hd, ds, generator=gen, device=dev) * 0.5
              if with_state else None)
        y, st_out = ops.ssd_scan(*args, chunk=ssd_chunk, state_in=st)
        y_ref, st_ref = ref.ssd_ref(*args, ssd_chunk, st)
        ok_y, err_y = within(y, y_ref, **SSD_TOL)
        ok_s, err_s = within(st_out, st_ref, **SSD_STATE_TOL)
        nbytes, flops = ssd_cost(b, s, nh, hd, ds, ssd_chunk,
                                 b if with_state else 0, b)
        timing = dict(
            ms=timer(lambda: ops.ssd_scan(*args, chunk=ssd_chunk, state_in=st)),
            plain_ms=timer(lambda: ref.ssd_ref(*args, ssd_chunk, st)),
            library_ms=None, nbytes=nbytes, flops=flops, fp32_bound=True)
        label += f" [{ops.ssd_plan(b, s, nh).name}]"
        if not ssd.add(f"{label}: y", ok_y, err_y, SSD_TOL, **timing):
            failed.append(f"ssd_scan {label} y")
        if not ssd.add(f"{label}: state_out", ok_s, err_s, SSD_STATE_TOL):
            failed.append(f"ssd_scan {label} state")

    # the serving path's form: the layer's pool of slot rows, in place
    sentinel = pool_slots
    for label, b, s, ids, fresh_rows, step in (
            ("prefill b=1 s=64, pool form, slot 2", 1, 64, [2], [], "prefill"),
            (f"decode b={slots} s=1, pool form, slots 3,1,0,2", slots, 1,
             [3, 1, 0, 2], [], "decode"),
            (f"prompt tail b={slots} s=1, pool form, 1 live + 3 sentinel",
             slots, 1, [sentinel, 1, sentinel, sentinel], [], None),
            (f"b={slots} s=64, pool form, slots 3,sentinel,0,1 (1 fresh)",
             slots, 64, [3, sentinel, 0, 1], [3], None),
            (f"b={slots} s=1, pool form, slots 3,sentinel,0,1 (1 fresh)",
             slots, 1, [3, sentinel, 0, 1], [3], None)):
        args = ssd_inputs(b, s)
        pool = torch.randn(pool_slots, nh, hd, ds, generator=gen,
                           device=dev) * 0.5
        slot = torch.tensor(ids, dtype=torch.int32, device=dev)
        fresh = torch.zeros(b, dtype=torch.bool, device=dev)
        fresh[fresh_rows] = True
        want = pool.clone()
        y_ref, _ = ref.ssd_pool_ref(*args, ssd_chunk, want, slot, fresh)
        got = pool.clone()
        y, _ = ops.ssd_scan(*args, chunk=ssd_chunk, pool=got, slot=slot,
                            fresh=fresh)
        ok_y, err_y = within(y, y_ref, **SSD_TOL)
        ok_s, err_s = within(got, want, **SSD_STATE_TOL)
        kept = [i for i in range(pool_slots) if i not in ids]
        ok_s = ok_s and torch.equal(got[kept], pool[kept])
        live = sum(i < pool_slots for i in ids)
        nbytes, flops = ssd_cost(b, s, nh, hd, ds, ssd_chunk,
                                 live - len(fresh_rows), live)
        timing = dict(
            ms=timer(lambda: ops.ssd_scan(*args, chunk=ssd_chunk, pool=got,
                                          slot=slot, fresh=fresh)),
            plain_ms=timer(lambda: ref.ssd_pool_ref(*args, ssd_chunk, want,
                                                    slot, fresh)),
            library_ms=None, nbytes=nbytes, flops=flops, fp32_bound=True)
        label += f" [{ops.ssd_plan(b, s, nh).name}]"
        if not ssd.add(f"{label}: y", ok_y, err_y, SSD_TOL, "zamba2-7b",
                       step, 68 if step else 0, **timing):
            failed.append(f"ssd_scan {label} y")
        if not ssd.add(f"{label}: whole pool (rows {kept} untouched)", ok_s,
                       err_s, SSD_STATE_TOL):
            failed.append(f"ssd_scan {label} pool")

    # the plan's choice: a one-row prefill chunk at every split of the head
    # dim, at the SSD heads of one card and of one of 2 or 4 tensor-parallel
    # ranks (the plan is forced by name, as the wrapper reads it)
    log("kernels: ssd_scan prefill b=1 s=64 at each split of the head dim "
        "(* marks ops.ssd_plan's choice)")
    chosen = ops.ssd_plan
    for heads in (112, 56, 28):
        args = ssd_inputs(1, 64, heads)
        st = torch.randn(1, heads, hd, ds, generator=gen, device=dev) * 0.5
        y_ref, st_ref = ref.ssd_ref(*args, ssd_chunk, st)
        plain = timer(lambda: ref.ssd_ref(*args, ssd_chunk, st))
        nbytes, flops = ssd_cost(1, 64, heads, hd, ds, ssd_chunk, 1, 1)
        for splits in ops.SSD_SPLITS:
            plan = ops.SsdPlan(1, heads, splits, False, hd)
            ops.ssd_plan = lambda *_, plan=plan: plan
            try:
                y, st_out = ops.ssd_scan(*args, chunk=ssd_chunk, state_in=st)
                ms = timer(lambda: ops.ssd_scan(*args, chunk=ssd_chunk,
                                                state_in=st))
            finally:
                ops.ssd_plan = chosen
            ok_y, err_y = within(y, y_ref, **SSD_TOL)
            ok_s, err_s = within(st_out, st_ref, **SSD_STATE_TOL)
            label = (f"{'*' if plan == chosen(1, 64, heads) else ' '}"
                     f"nh={heads} [{plan.name}]")
            if not ssd.add(f"{label}: y", ok_y, err_y, SSD_TOL, ms=ms,
                           plain_ms=plain, library_ms=None, nbytes=nbytes,
                           flops=flops, fp32_bound=True):
                failed.append(f"ssd_scan nh={heads} splits={splits} y")
            if not ssd.add(f"{label}: state_out", ok_s, err_s,
                           SSD_STATE_TOL):
                failed.append(f"ssd_scan nh={heads} splits={splits} state")
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failed}")
    if dev == "cuda":
        host_costs(torch, ops, randn, gen, chunk, slots)
    return mm, fa, rn, ssd


def host_us(torch, fn, calls: int = 300) -> float:
    """Host microseconds per call of ``fn``: ``calls`` back-to-back calls
    timed by ``perf_counter`` with no wait on the device inside (what a
    step pays to enqueue the kernel), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def host_costs(torch, ops, randn, gen, chunk, slots):
    """Each wrapper's host cost per call at a zamba2-7b serving shape."""
    h, nh = 3584, 112
    x, g = randn(chunk, h), torch.randn(h, generator=gen, device="cuda")
    y = randn(slots, 1, nh, 64)
    gn = torch.randn(nh, 64, generator=gen, device="cuda")
    z = randn(slots, 1, nh, 64)
    xs = randn(slots, 1, nh, 64)
    dt = torch.rand(slots, 1, nh, device="cuda")
    vec = torch.randn(nh, device="cuda")
    bc = randn(slots, 1, 128)
    pool = torch.zeros(slots, nh, 64, 64, device="cuda")
    slot = torch.arange(slots, dtype=torch.int32, device="cuda")
    fresh = torch.zeros(slots, dtype=torch.bool, device="cuda")
    a, w = randn(slots, h), randn(h, h)
    calls = {
        f"rmsnorm rows={chunk} h={h}": lambda: ops.rmsnorm(x, g),
        f"group_rmsnorm+gate {slots * nh} rows of 64":
            lambda: ops.group_rmsnorm(y, gn, gate=z),
        f"ssd_scan pool form b={slots} s=1": lambda: ops.ssd_scan(
            xs, dt, vec, bc[..., :64], bc[..., 64:], vec, chunk=64,
            pool=pool, slot=slot, fresh=fresh),
        f"matmul M={slots} {h}x{h}": lambda: ops.matmul(a, w),
    }
    log("kernels: host cost per call (perf_counter over 300 enqueues, no "
        "wait on the device):")
    for label, fn in calls.items():
        log(f"  {label:48s} {host_us(torch, fn):8.2f} us")


def _sdpa(torch, F, q, k, v, mask):
    """The library yardstick: one scaled_dot_product_attention call on the
    same inputs (heads-first views; GQA by enable_gqa)."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    m = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m,
                                                  enable_gqa=True)


# ---------------------------------------------------------------------------
# Phases 2, 4 and 5: the paged server, as a user starts it.
# ---------------------------------------------------------------------------

SERVE = dict(slots=4, prefill_chunk=64, page_size=16, max_seq=272, max_new=16)
PROMPT_LEN = 256   # prompt lengths are drawn from [64, 256]


def launches_per_step(cfg) -> dict:
    """Kernel launches of one paged step at d1 = d2 = 1 (every step shape
    launches the same kernels), summed over the segments:
      - dense layer: 2 entry norms (rmsnorm launches only for an RMSNorm
        model: a LayerNorm model's norms run as plain torch, the final one
        too); fused q/k/v, wo, fused up+gate (or up) and down GEMMs; one
        attention core;
      - zamba super-block of ``inner`` blocks: the shared block's 2
        in-projections and its dense layer, and ``inner - 1`` Mamba2 blocks;
      - Mamba2 block: its ``ln`` norm and its grouped, gated norm; z|x,
        B|C|dt and out GEMMs; one scan;
    plus the final norm and the head GEMM.  zamba2-7b (13 super-blocks of
    6, 3 tail Mamba2 blocks): matmul 13 * (2 + 4 + 5 * 3) + 3 * 3 + 1 = 283,
    rmsnorm 13 * (2 + 5 * 2) + 3 * 2 + 1 = 163, flash_attention 13,
    ssd_scan 13 * 5 + 3 = 68.  gpt-m2 (4 dense layers, LayerNorm): matmul
    17, flash_attention 4, rmsnorm 0."""
    from repro_torch.configs.base import segments

    norm = 0 if cfg.norm_kind == "layernorm" else 1   # a block norm's launch
    n = {"matmul": 1, "flash_attention": 0, "rmsnorm": norm, "ssd_scan": 0}
    per = {"dense": {"matmul": 4, "flash_attention": 1, "rmsnorm": 2 * norm},
           "mamba": {"matmul": 3, "rmsnorm": norm + 1, "ssd_scan": 1}}
    for seg in segments(cfg):
        blocks = ({"dense": 1, "mamba": seg.inner - 1} if seg.kind == "zamba"
                  else {seg.kind: 1})
        if seg.kind == "zamba":
            n["matmul"] += 2 * seg.count
        for kind, k in blocks.items():
            for name, v in per[kind].items():
                n[name] += seg.count * k * v
    return n


class StepMeter:
    """Wraps the server's step: counts its calls and sums their host time
    by kind.  A prefill chunk feeds [1, chunk] tokens; a decode tick
    [slots, 1]; in recurrent mode a prompt tail is fed one token at a time
    through the decode-shaped step, and a call whose live row belongs to a
    slot still prefilling is counted as a "tail", not as a decode tick.
    The step hands back numpy tokens, so every call ends synchronised with
    the device and its host time covers its device work.  ``replay_ms``
    sums, by kind, the device time of the graph replays inside the calls
    (the CUDA events ``serve_once`` records around each replay)."""

    KINDS = ("prefill", "tail", "decode")

    def __init__(self, server):
        self.server = server
        self.fn = server.step_fn
        self.calls = dict.fromkeys(self.KINDS, 0)
        self.seconds = dict.fromkeys(self.KINDS, 0.0)
        self.replay_ms = dict.fromkeys(self.KINDS, 0.0)
        self.events = None     # (start, end) of the replays of this call

    def _kind(self, tokens, rest) -> str:
        if tokens.shape[1] > 1:
            return "prefill"
        if self.server.cfg.recurrent:
            slots = self.server.slots
            live = [int(i) for i in rest[2] if i < len(slots)]
            if any(not slots[i].decoding for i in live):
                return "tail"
        return "decode"

    def __call__(self, tokens, *rest):
        kind = self._kind(tokens, rest)
        self.events = []
        t0 = time.perf_counter()
        out = self.fn(tokens, *rest)
        self.calls[kind] += 1
        self.seconds[kind] += time.perf_counter() - t0
        self.replay_ms[kind] += sum(s.elapsed_time(e) for s, e in self.events)
        return out


def serve_once(torch, server, step_fn, prompts, rid0: int):
    """Serve ``prompts`` through ``step_fn`` (rids from ``rid0``) on the
    drained ``server``; returns (its meter, each request's tokens by prompt
    index).  For the captured step, CUDA events around each graph replay
    give the meter the device time of every step, from its first kernel's
    start to its last one's end."""
    from repro_torch.runtime.server import Request

    server.step_fn = step_fn
    meter = StepMeter(server)
    server.step_fn = meter
    graphs = [s.graph for s in step_fn.step.shapes.values()
              if step_fn.captured and s.graph is not None]
    for graph in graphs:
        def timed(graph=graph, replay=type(graph).replay):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            replay(graph)
            end.record()
            meter.events.append((start, end))

        graph.replay = timed
    for i, p in enumerate(prompts):
        server.submit(Request(rid=rid0 + i, prompt=p, max_new=SERVE["max_new"]))
    try:
        server.run_until_drained()
    finally:
        for graph in graphs:
            del graph.replay
    return meter, {r.rid - rid0: r.out for r in server.completed
                   if r.rid >= rid0}


#: captured and uncaptured runs of a serve phase's workload timed in turns
#: (uncaptured, captured, captured, uncaptured, ...): the host sets the
#: uncaptured step's time and moves between calls, so the two are compared
#: only inside one call, interleaved
TIMED_PAIRS = 5
#: serve-zamba's pairs: its uncaptured runs take about 30 s each, and the
#: whole script has to stay well inside its time limit
ZAMBA_PAIRS = 3


def serve_phase(torch, cfg, requests: int, seed: int, dev="cuda",
                kernel_ms=None, profile: bool = False,
                pairs: int = 0, keep: dict | None = None) -> dict:
    """Serve ``requests`` seeded prompts through ``make_paged_server`` and
    ``run_until_drained``, the step captured as a CUDA graph at each of its
    two shapes; check every request and the page pool, that exactly two
    graphs were captured, and that each kernel launched exactly its
    per-step count times the steps taken and the warm-up runs of the body
    (a replay counts what its capture recorded).  The capture's cost is
    printed per shape (warm-up, capture, graph pool bytes).  Then the same
    prompts through the uncaptured body (``info.plain``): every request's
    greedy tokens must be identical.  ``pairs`` more pairs of runs, in
    turns, time the captured and the uncaptured step by kind (wall ms per
    step; for the captured one also the device time of its replays, by
    CUDA events).  ``kernel_ms`` (the kernel phase's kernel time per
    prefill chunk and per decode tick) is set beside each step's mean wall
    time.  With ``profile`` the same requests are served once more through
    the captured step under ``torch.profiler`` for the device's busy share,
    its launches per step and its time by kernel (the counts are read
    before, and checked after the profile, so that a tree whose counts
    differ still prints it).  Returns the launch counts of the counted
    run.  ``keep`` (a dict) receives the server's sharded weights
    (``"params"``) for a later phase."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.runtime.server import Request

    t0 = time.perf_counter()
    prompts = serve.sample_prompts(cfg, requests, PROMPT_LEN, seed)
    scfg = serve.paged_server_config([len(p) for p in prompts], **SERVE)
    server, _ = serve.make_paged_server(
        cfg, scfg, lm.init_params(cfg, seed=seed, device=dev), device=dev)
    step = server.step_fn
    captured = step.step
    meter = StepMeter(server)
    server.step_fn = meter
    for rid, p in enumerate(prompts):
        server.submit(Request(rid=rid, prompt=p, max_new=SERVE["max_new"]))
    if dev == "cuda":
        torch.cuda.synchronize()
    log(f"serve {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {requests} requests of "
        f"{[len(p) for p in prompts]} prompt tokens, {SERVE}, "
        f"{'recurrent' if server.cfg.recurrent else 'plain'} mode; set-up "
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
    per_step = launches_per_step(cfg)
    want = {k: v * (steps + captured.warmups) for k, v in per_step.items()}

    prefill_tok = sum(len(p) for p in prompts)
    decode_tok = requests * (SERVE["max_new"] - 1)
    calls, secs = meter.calls, meter.seconds
    prompt_s = secs["prefill"] + secs["tail"]
    log(f"  served {requests} requests in {ticks} ticks, {wall:.3f}s "
        f"(captures included): "
        f"{calls['prefill']} prefill chunks {secs['prefill']:.3f}s and "
        f"{calls['tail']} prompt-tail steps {secs['tail']:.3f}s "
        f"({prefill_tok / prompt_s:.1f} prompt tok/s), "
        f"{calls['decode']} decode ticks {secs['decode']:.3f}s "
        f"({decode_tok / secs['decode']:.1f} new tok/s, "
        f"{1e3 * secs['decode'] / calls['decode']:.2f} ms per tick)")
    for key, shape in captured.shapes.items():
        log(f"  graph for tokens {key[0]}: warm-up {shape.warmup_s:.3f}s, "
            f"capture {shape.capture_s:.3f}s, graph pool "
            f"{shape.pool_bytes} bytes ({shape.pool_bytes / 2**20:.1f} MiB), "
            f"launches a replay {shape.launches}")
    log(f"  launches over {steps} steps and {captured.warmups} warm-up runs: "
        f"{launches} (= per step {per_step} x {steps + captured.warmups})")
    log(f"  request 0 -> {done[0].out}")
    assert captured.captures == 2 and len(captured.shapes) == 2, \
        f"{captured.captures} captures of {len(captured.shapes)} shapes"
    for key, shape in captured.shapes.items():
        assert shape.launches == per_step, (key, shape.launches)
    assert launches == want, f"launches {launches}, expected {want}"

    tokens = {r.rid: r.out for r in done}
    runs = compare_runs(torch, server, step, prompts, tokens, pairs)
    log(f"  uncaptured step: greedy tokens of every request identical to "
        f"the captured step's, in {len(runs['uncaptured'])} uncaptured and "
        f"{len(runs['captured'])} more captured runs")
    if pairs:
        wall = report_pairs(runs, kernel_ms)
    if profile:
        server.step_fn = step
        meter = StepMeter(server)
        server.step_fn = meter
        profile_run(torch, server, meter, prompts, cfg.name, wall)
    if keep is not None:
        keep["params"] = step.params
    # the step holds the weights; each meter and its server refer to each
    # other, so only a collection frees them
    del server, meter, step, captured, runs
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return launches


def compare_runs(torch, server, step, prompts, tokens, pairs: int) -> dict:
    """Serve ``prompts`` again through the uncaptured body, and with
    ``pairs`` through the uncaptured and the captured step in turns (U C C
    U U C ...: ``pairs`` runs of each, the first of them that one
    uncaptured run); every run's tokens must be ``tokens``.  Returns each
    mode's meters."""
    runs = {"uncaptured": [], "captured": []}
    order = [m for i in range(pairs) for m in (
        ("uncaptured", "captured") if i % 2 == 0 else
        ("captured", "uncaptured"))] or ["uncaptured"]
    for i, mode in enumerate(order):
        fn = step if mode == "captured" else step.uncaptured()
        meter, outs = serve_once(torch, server, fn, prompts, 2000 + 100 * i)
        bad = [r for r in tokens if outs.get(r) != tokens[r]]
        assert not bad, f"run {i}, {mode}: the tokens of requests {bad} " \
            f"differ from the counted captured run's"
        runs[mode].append(meter)
    return runs


def report_pairs(runs: dict, kernel_ms) -> float:
    """The wall ms per step by kind of each run of ``compare_runs``, their
    medians, and for the captured runs the replays' device ms per step and
    its share of the wall.  Returns the median captured run's seconds in
    its steps."""
    pairs = len(runs["captured"])
    walls = [sum(m.seconds.values()) for m in runs["captured"]]
    log(f"  captured against uncaptured, {pairs} pairs in turns (wall ms "
        f"per step by kind, host clock around each step, which ends "
        f"synchronised):")
    for kind in StepMeter.KINDS:
        ms = {mode: [1e3 * m.seconds[kind] / m.calls[kind] for m in meters]
              for mode, meters in runs.items() if meters[0].calls[kind]}
        if not ms:
            continue
        dev = statistics.median(m.replay_ms[kind] / m.calls[kind]
                                for m in runs["captured"])
        unc, cap = (statistics.median(ms[m]) for m in ("uncaptured",
                                                        "captured"))
        log(f"    {kind} ({runs['captured'][0].calls[kind]} a run): "
            f"uncaptured {', '.join(f'{x:.2f}' for x in ms['uncaptured'])} "
            f"(median {unc:.2f}); captured "
            f"{', '.join(f'{x:.2f}' for x in ms['captured'])} (median "
            f"{cap:.2f}, {unc / cap:.2f}x faster); the replays' device time "
            f"{dev:.2f} ms a step ({dev / cap:.0%} of the captured wall)"
            + (f"; the kernel phase's kernels {kernel_ms[kind]:.2f} ms"
               if kernel_ms and kind in kernel_ms else ""))
    return statistics.median(walls)


def profile_run(torch, server, meter, prompts, name: str,
                wall_s: float) -> None:
    """Serve ``prompts`` again under ``torch.profiler``: the device time of
    the run (the sum over device kernels, as the profiler's own table
    totals it) against the profiled wall time and against ``wall_s``, the
    same run's wall time without the profiler; the device launches per
    step over all kernels, torch's own included (``meter`` counts the
    steps); the device time by kernel (the table goes to
    ``chiprun_out/profile_<name>.txt``) and every gather and scatter
    kernel by its full name (whose template names the dtype it moves)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.server import Request

    for rid, p in enumerate(prompts):
        server.submit(Request(rid=1000 + rid, prompt=p,
                              max_new=SERVE["max_new"]))
    # device activity only: the host operators' events would multiply the
    # trace, and its post-processing, several times over
    steps0 = sum(meter.calls.values())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run_until_drained()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    steps = sum(meter.calls.values()) - steps0
    t0 = time.perf_counter()
    events = prof.key_averages()
    (OUT_DIR / f"profile_{name}.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=25))
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"  profiled rerun: device busy {device_ms:.1f} ms, "
        f"{device_ms / wall_ms:.0%} of its {wall_ms:.1f} ms wall and "
        f"{device_ms / (1e3 * wall_s):.0%} of the unprofiled run's "
        f"{1e3 * wall_s:.1f} ms (the trace took "
        f"{time.perf_counter() - t0:.1f}s to read); by kernel:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
            f"{e.key[:70]}")
    launches = sum(e.count for e in kernels)
    log(f"  profiled rerun: {launches} device launches over {steps} steps, "
        f"{launches / steps:.1f} per step (all kernels, torch's included); "
        f"gathers and scatters:")
    for e in kernels:
        if "index" in e.key.lower():
            log(f"    {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
                f"{e.key[:300]}")


# ---------------------------------------------------------------------------
# Phases 3 and 6: the path on the card against the path on the CPU.
# ---------------------------------------------------------------------------

#: per-row relative L2 error of the logits, card (bf16, kernels) against
#: CPU (fp32, plain versions).  bf16 keeps 8 significant bits (relative
#: spacing 2^-8 = 0.0039), and the path rounds the residual stream and
#: every GEMM output to bf16 at about a dozen points in two layers.  The
#: plain versions run in bf16 on the CPU, at the 2-layer reduced width,
#: show 1.95e-2 against fp32; the kernels round at the same points or at
#: fewer (fp32 probabilities), so the limit is 2.5 times that.
PATH_TOL = 5e-2
#: a recurrent model (zamba2) has no fixed limit: the grouped RMSNorm
#: before its out projection divides each head's SSD output by its RMS,
#: so where the scan's terms nearly cancel in one head and token, bf16
#: rounding of the inputs becomes a large relative error of that row (one
#: row of 64 at 12% where the rest sit near 1.4%, in one Mamba2 block at
#: the reduced width on the CPU), and a carried state spreads it to later
#: tokens.  So the same calls also run through the plain versions in bf16
#: on the CPU, and the card's error against fp32, over each call's logits
#: and each segment's state pool, may be at most this factor times theirs
#: (the factor of PATH_TOL's own derivation).
RECURRENT_FACTOR = 2.5


def path_calls(cfg, seed: int):
    """The page geometry and the ``lm.paged_step`` calls of the path check:
    (tokens, start, table, slot, rows compared) each.  A dense model: slots
    0 and 1 each prefill one chunk, then a tick with two of four slots
    live.  A recurrent model: slot 0 prefills two chunks (the second
    carries the state), slot 1 one, then a tick with slots 0 and 1 live
    and two sentinel rows."""
    import numpy as np

    from repro_torch.models import lm
    from repro_torch.models.paging import PageAllocator, PagedConfig

    chunk, slots = SERVE["prefill_chunk"], SERVE["slots"]
    pcfg = PagedConfig(page_size=SERVE["page_size"], num_pages=16,
                       pages_per_slot=-(-SERVE["max_seq"] // SERVE["page_size"]))
    alloc = PageAllocator(pcfg, slots)
    n0 = 2 * chunk if lm.is_recurrent(cfg) else chunk
    alloc.ensure(0, n0 + 1)
    alloc.ensure(1, chunk + 1)
    table = alloc.table()
    table[2:] = 0                  # rows 2 and 3 of the tick are not live
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (slots, n0 + 1), dtype=np.int32)
    tick = np.stack([toks[0, n0], toks[1, chunk], 0, 0])[:, None]
    calls = [
        (toks[0:1, :chunk], [0], table[0:1], [0], 1),
        (toks[1:2, :chunk], [0], table[1:2], [1], 1),
        (tick, [n0, chunk, 0, 0], table, [0, 1, slots, slots], 2),
    ]
    if lm.is_recurrent(cfg):
        calls.insert(1, (toks[0:1, chunk:n0], [chunk], table[0:1], [0], 1))
    return pcfg, calls


def run_path(torch, cfg, params, pcfg, calls, where, dtype=None):
    """``calls`` through ``lm.paged_step`` on ``where`` with fresh caches
    (``dtype``: the pools' dtype, the model's when None).  Returns the
    logits of each call (fp32, on the CPU) and the SSD state pools' rows
    of slots 0 and 1 (an empty list for a dense model)."""
    import numpy as np

    from repro_torch.core.atp import make_context
    from repro_torch.core.mesh import atp_topo
    from repro_torch.models import lm

    recurrent = lm.is_recurrent(cfg)
    ctx = make_context(atp_topo(1, 1, 1), device_type=where)
    caches = lm.init_paged_caches(cfg, ctx, pcfg, dtype=dtype, device=where,
                                  slots=SERVE["slots"] if recurrent else None)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=where)

    out = []
    with torch.no_grad():
        for tok, start, tab, slot, _ in calls:
            got, caches = lm.paged_step(
                ctx, cfg, params, put(tok), put(start), put(tab), caches,
                slot=put(slot) if recurrent else None)
            out.append(got.float().cpu())
    pools = [t[:, :, :2].cpu() if t.dim() == 6 else t[:, :2].cpu()
             for t in _ssd_pools(caches)]
    return out, pools


def compare_logits(calls, got, want) -> dict:
    """Per-row relative L2 error of ``got`` against ``want`` over the live
    rows of every call: the worst, the worst of each call, the max abs
    error and the top-1 agreement."""
    out = {"worst": 0.0, "per_call": [], "frob": [], "max_abs": 0.0,
           "agree": 0, "rows": 0}
    for (*_, live), g, w in zip(calls, got, want):
        g, w = g[:live].flatten(0, 1), w[:live].flatten(0, 1)
        assert g.isfinite().all(), "non-finite logits"
        rel = float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())
        out["per_call"].append(rel)
        out["frob"].append(float((g - w).norm() / w.norm()))
        out["worst"] = max(out["worst"], rel)
        out["max_abs"] = max(out["max_abs"], float((g - w).abs().max()))
        out["agree"] += int((g.argmax(-1) == w.argmax(-1)).sum())
        out["rows"] += g.shape[0]
    return out


def path_check(torch, cfg, seed: int, dev="cuda") -> None:
    """``path_calls`` on ``dev`` in the model dtype and on the CPU in fp32
    from the same weights.  A dense model: the logits must agree within
    ``PATH_TOL``.  A recurrent model: the plain versions also run on the
    CPU in bf16, and the card must be as close to fp32 as they are (see
    ``RECURRENT_FACTOR``), for the logits and the fp32 SSD state pools."""
    from repro_torch.core.mesh import atp_topo
    from repro_torch.models import lm

    pcfg, calls = path_calls(cfg, seed)
    params = lm.shard_params(cfg, lm.init_params(cfg, seed=seed, device=dev),
                             lm.layout_context(atp_topo(1, 1, 1), 0))
    card = run_path(torch, cfg, params, pcfg, calls, dev)
    fp32 = run_path(torch, cfg, lm.tree_map(lambda t: t.cpu().float(), params),
                    pcfg, calls, "cpu", torch.float32)

    def report(what, c):
        log(f"  {what}: worst relative L2 error per row {c['worst']:.3e} "
            f"(per call {', '.join(f'{e:.3e}' for e in c['per_call'])}); "
            f"over each call {', '.join(f'{e:.3e}' for e in c['frob'])}; "
            f"max abs error {c['max_abs']:.3e}, top-1 agreement "
            f"{c['agree']}/{c['rows']}")

    c = compare_logits(calls, card[0], fp32[0])
    log(f"path-check {cfg.name} at {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {c['rows']} logit rows:")
    report("card (kernels, bf16) against CPU (plain, fp32)", c)
    if not card[1]:
        assert c["worst"] <= PATH_TOL, \
            f"path-check: relative error {c['worst']:.3e} (limit {PATH_TOL})"
        return
    bf16 = run_path(torch, cfg, lm.tree_map(lambda t: t.cpu(), params), pcfg,
                    calls, "cpu")
    plain = compare_logits(calls, bf16[0], fp32[0])
    report("CPU (plain, bf16) against CPU (plain, fp32)", plain)
    report("card (kernels, bf16) against CPU (plain, bf16)",
           compare_logits(calls, card[0], bf16[0]))

    def pool_err(a, b):
        return [float((x - y).norm() / y.norm()) for x, y in zip(a, b)]

    pools, plain_pools = pool_err(card[1], fp32[1]), pool_err(bf16[1], fp32[1])
    log(f"  SSD state pools (slots 0 and 1) per segment, relative L2 error "
        f"against fp32: card {', '.join(f'{e:.3e}' for e in pools)}; plain "
        f"bf16 {', '.join(f'{e:.3e}' for e in plain_pools)}")
    assert all(t.isfinite().all() for t in card[1]), "non-finite state"
    f = RECURRENT_FACTOR
    bad = [i for i, (e, p) in enumerate(zip(c["frob"], plain["frob"]))
           if e > f * p]
    assert not bad, f"path-check: calls {bad} beyond {f}x the bf16 error"
    bad = [i for i, (e, p) in enumerate(zip(pools, plain_pools)) if e > f * p]
    assert not bad, f"path-check: state pools {bad} beyond {f}x the bf16 error"


def _ssd_pools(caches) -> list:
    """The fp32 SSD state pools of every recurrent segment."""
    return [c["mamba"]["ssd"] if "mamba" in c else c["ssd"]
            for c in caches.values() if "ssd" in c or "mamba" in c]


# ---------------------------------------------------------------------------
# Phase 6b: the wave baseline over contiguous decode caches.
# ---------------------------------------------------------------------------

#: the wave's workloads: a wave of ``batch`` prompts of ``prompt_len``
#: tokens and ``SERVE["max_new"]`` new ones each, the weights from ``seed``
#: (zamba2-7b's are serve-zamba's when that phase ran)
WAVE = {"qwen3-8b": dict(batch=4, prompt_len=256, seed=3),
        "zamba2-7b": dict(batch=4, prompt_len=128, seed=2)}
#: a step whose top-2 logit gap is below this in the wave's or the paged
#: path's logits is a near-tie: two paths that round differently may pick
#: either token there, and their continuations part
NEAR_TIE = 5e-2
#: the depth of the wave's path check: the first layers of the served
#: weights, full width, so that the fp32 CPU side stays small (path-check's
#: depths: zamba2-7b's first super-block and a tail Mamba2 block)
WAVE_PATH_LAYERS = {"qwen3-8b": 2, "zamba2-7b": 7}


class WaveMeter:
    """Wraps a ``WaveServer``'s ``tick``: counts its calls and sums their
    host time by kind (a prefill feeds [b, s > 1] tokens, a decode tick
    [b, 1]).  A tick hands back numpy tokens, so it ends synchronised."""

    KINDS = ("prefill", "decode")

    def __init__(self, wave):
        self.wave, self.fn = wave, wave.tick
        self.calls = dict.fromkeys(self.KINDS, 0)
        self.seconds = dict.fromkeys(self.KINDS, 0.0)
        wave.tick = self

    def __call__(self, tokens, pos):
        kind = "prefill" if tokens.shape[1] > 1 else "decode"
        t0 = time.perf_counter()
        out = self.fn(tokens, pos)
        self.seconds[kind] += time.perf_counter() - t0
        self.calls[kind] += 1
        return out

    def done(self):
        del self.wave.tick     # the instance's method again


def wave_once(wave, prompts, captured: bool = True):
    """One wave through the captured step or the uncaptured body; returns
    (its meter, the tokens [batch, max_new])."""
    w = wave if captured else wave.uncaptured()
    meter = WaveMeter(w)
    try:
        return meter, w.serve(prompts, SERVE["max_new"])
    finally:
        meter.done()


def _rows_and_gaps(torch, rows):
    """Greedy tokens and top-2 logit gaps [b, steps] of per-step logit
    rows [b, V]."""
    stacked = torch.stack(rows, 1)
    top = stacked.topk(2, dim=-1).values
    return (stacked.argmax(-1).cpu().numpy(),
            (top[..., 0] - top[..., 1]).cpu().numpy())


def wave_logit_run(torch, cfg, wave, prompts):
    """The wave's body uncaptured, its logits kept: (the first new token's
    logit rows [b, V] fp32, the tokens and top-2 gaps [b, max_new])."""
    import numpy as np

    from repro_torch.models import lm

    ctx, dev = wave.info.ctx, wave.info.device
    lm.reset_decode_caches(wave.caches)
    toks = torch.as_tensor(np.stack(prompts), device=dev)
    pos, rows = 0, []
    with torch.no_grad():
        for _ in range(SERVE["max_new"]):
            logits, _ = lm.decode_step(ctx, cfg, wave.params, toks, pos,
                                       wave.caches)
            rows.append(logits.float())
            pos += toks.shape[1]
            toks = rows[-1].argmax(-1)[:, None].int()
    return (rows[0].cpu(), *_rows_and_gaps(torch, rows))


def paged_logit_run(torch, cfg, params, prompts, dev, batched=False):
    """The paged path's ``lm.paged_step`` on the same prompts, uncaptured:
    each prompt's prefill chunks of ``SERVE["prefill_chunk"]`` tokens in
    its own slot (``batched``: every prompt whole in one step, the wave's
    shapes), then decode ticks of every slot.  Returns (each prompt's last
    prefill chunk's last logit row [b, V] fp32, the tokens and top-2 gaps
    [b, max_new])."""
    import numpy as np

    from repro_torch.core.atp import make_context
    from repro_torch.core.mesh import atp_topo
    from repro_torch.models import lm
    from repro_torch.models.paging import PageAllocator, PagedConfig

    b, plen, new = len(prompts), len(prompts[0]), SERVE["max_new"]
    chunk, pg = SERVE["prefill_chunk"], SERVE["page_size"]
    pcfg = PagedConfig(page_size=pg, num_pages=1 + b * -(-(plen + new) // pg),
                       pages_per_slot=-(-SERVE["max_seq"] // pg))
    alloc = PageAllocator(pcfg, b)
    for i in range(b):
        alloc.ensure(i, plen + new)
    recurrent = lm.is_recurrent(cfg)
    ctx = make_context(atp_topo(1, 1, 1), device_type=dev)
    caches = lm.init_paged_caches(cfg, ctx, pcfg, device=dev,
                                  slots=b if recurrent else None)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    table = put(alloc.table())
    toks = put(np.stack(prompts))
    first = []
    with torch.no_grad():
        if batched:
            logits, _ = lm.paged_step(ctx, cfg, params, toks, put([0] * b),
                                      table, caches,
                                      slot=put(range(b)) if recurrent else None)
            first = list(logits[:, -1].float())
        for i in range(0 if batched else b):
            for c0 in range(0, plen, chunk):
                logits, _ = lm.paged_step(
                    ctx, cfg, params, toks[i:i + 1, c0:c0 + chunk], put([c0]),
                    table[i:i + 1], caches,
                    slot=put([i]) if recurrent else None)
            first.append(logits[0, -1].float())
        rows = [torch.stack(first)]
        for t in range(new - 1):
            logits, _ = lm.paged_step(
                ctx, cfg, params, rows[-1].argmax(-1)[:, None].int(),
                put([plen + t] * b), table, caches,
                slot=put(range(b)) if recurrent else None)
            rows.append(logits[:, 0].float())
    return (rows[0].cpu(), *_rows_and_gaps(torch, rows))


def row_errors(got, want) -> tuple[float, int]:
    """The worst per-row relative L2 error of logit rows and their top-1
    agreement."""
    rel = float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())
    return rel, int((got.argmax(-1) == want.argmax(-1)).sum())


def cut_params(cfg, cut, params) -> dict:
    """The first layers of a sharded tree: each segment of ``cut`` (a
    config whose segments are the first of ``cfg``'s, as deep or less) takes
    the leading blocks of ``cfg``'s segment."""
    from repro_torch.configs.base import segments
    from repro_torch.models import lm

    full, part = segments(cfg), segments(cut)
    assert [(s.kind, s.inner) for s in part] == \
        [(s.kind, s.inner) for s in full[:len(part)]], (part, full)
    out = {k: v for k, v in params.items() if not k.startswith("seg")}
    for i, seg in enumerate(part):
        out[f"seg{i}"] = lm.tree_map(lambda t, n=seg.count: t[:n],
                                     params[f"seg{i}"])
    return out


def wave_path_check(torch, cfg, wave, prompts, layers: int) -> None:
    """The wave's prefill at the served weights' first ``layers`` layers,
    full width: the first new token's logit rows on the card (kernels,
    bf16) against the CPU (plain versions, fp32, from the same bf16
    weights), as ``path_check`` holds the paged path.  A dense model within
    ``PATH_TOL`` a row; a recurrent one, as close to fp32 as the plain
    versions in bf16 on the CPU are (``RECURRENT_FACTOR``), over the rows
    and over the batch-row SSD state the prefill leaves in its caches."""
    import numpy as np

    from repro_torch.core.atp import make_context
    from repro_torch.core.mesh import atp_topo
    from repro_torch.models import lm

    cut = dataclasses.replace(cfg, num_layers=layers)
    params = cut_params(cfg, cut, wave.params)
    recurrent = lm.is_recurrent(cfg)
    toks = np.stack(prompts)
    runs = [("card", wave.info.device.type, params, None),
            ("fp32", "cpu", lm.tree_map(lambda t: t.cpu().float(), params),
             torch.float32)]
    if recurrent:
        runs.append(("bf16", "cpu", lm.tree_map(lambda t: t.cpu(), params),
                     None))
    out, states = {}, {}
    for name, where, tree, dtype in runs:
        ctx = make_context(atp_topo(1, 1, 1), device_type=where)
        caches = lm.init_decode_caches(cut, ctx, len(prompts),
                                       SERVE["max_seq"], dtype=dtype,
                                       device=where)
        with torch.no_grad():
            logits, _ = lm.decode_step(ctx, cut, tree,
                                       torch.as_tensor(toks, device=where), 0,
                                       caches)
        out[name] = logits.float().cpu()
        states[name] = [t.cpu() for t in _ssd_pools(caches)]
    rel, agree = row_errors(out["card"], out["fp32"])
    log(f"  path check, the first {layers} layers of these weights: the "
        f"first new token's {len(prompts)} logit rows, card (kernels, bf16) "
        f"against CPU (plain, fp32): worst relative L2 error per row "
        f"{rel:.3e}, over the rows {frob(out['card'], out['fp32']):.3e}, top-1 "
        f"agreement {agree}/{len(prompts)}")
    if not recurrent:
        assert rel <= PATH_TOL, f"wave path check: {rel:.3e} > {PATH_TOL}"
        return
    f = RECURRENT_FACTOR
    pairs = [("logit rows", out["card"], out["fp32"], out["bf16"])] + [
        (f"SSD state of segment {i}", c, w, p) for i, (c, w, p) in
        enumerate(zip(states["card"], states["fp32"], states["bf16"]))]
    for what, c, w, p in pairs:
        got, plain = frob(c, w), frob(p, w)
        log(f"    {what} against fp32: card {got:.3e}, plain bf16 "
            f"{plain:.3e} (limit {f} x the plain)")
        assert got <= f * plain, f"wave path check: {what} {got:.3e} " \
            f"beyond {f} x {plain:.3e}"


def frob(got, want) -> float:
    """Relative L2 error of a whole tensor."""
    return float((got.float() - want.float()).norm() / want.float().norm())


def near_tie_rule(wave_toks, paged_toks: dict, gaps, tie: float) -> list:
    """Wave and paged tokens must be equal up to each request's first
    near-tie (a step whose top-2 gap, in either path's logits, is below
    ``tie``).  Returns, per request that reaches one, (request, that step,
    the first step whose tokens differ or None, the gap there)."""
    tied = []
    for r, want in enumerate(wave_toks.tolist()):
        below = [t for t in range(len(want)) if gaps[r, t] < tie]
        upto = below[0] if below else len(want)
        got = paged_toks[r]
        assert got[:upto] == want[:upto], \
            f"request {r}: paged {got} against wave {want} before its " \
            f"first near-tie at step {upto}"
        if below:
            differ = next((t for t, (g, w) in enumerate(zip(got, want))
                           if g != w), None)
            tied.append((r, upto, differ, None if differ is None else
                         round(float(gaps[r, differ]), 4)))
    return tied


def wave_run(torch, cfg, wave, server, step, prompts, pairs: int) -> dict:
    """The checks and timings of one model's wave (see the module
    docstring, serve-wave): returns the counted run's launches."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import lm

    recurrent = lm.is_recurrent(cfg)

    b, plen = len(prompts), len(prompts[0])
    # the counted run: every count 0 just before, read just after
    ops.reset_launches()
    meter, tokens = wave_once(wave, prompts)
    launches, variants = dict(ops.LAUNCHES), list(ops.ATTENTION_VARIANT_LAUNCHES)
    steps = sum(meter.calls.values())
    per_step = launches_per_step(cfg)
    want = {k: v * (steps + wave.step.warmups) for k, v in per_step.items()}
    log(f"  counted captured wave: {steps} steps and {wave.step.warmups} "
        f"warm-up runs, launches {launches} (= per step {per_step} x "
        f"{steps + wave.step.warmups}); flash_attention by "
        f"``attention_plan`` variant {variants} (0: flash_attention.cu, 1: "
        f"flash_attention_train.cu); request 0 -> {tokens[0].tolist()}")
    for key, shape in wave.step.shapes.items():
        log(f"  graph for tokens {key[0]}: warm-up {shape.warmup_s:.3f}s, "
            f"capture {shape.capture_s:.3f}s, graph pool {shape.pool_bytes} "
            f"bytes ({shape.pool_bytes / 2**20:.1f} MiB), launches a replay "
            f"{shape.launches}")
    assert wave.step.captures == 2 and len(wave.step.shapes) == 2, \
        f"{wave.step.captures} captures of {len(wave.step.shapes)} shapes"
    assert launches == want, f"launches {launches}, expected {want}"
    assert tokens.shape == (b, SERVE["max_new"])
    assert ((tokens >= 0) & (tokens < cfg.vocab_size)).all()

    # captured, uncaptured and the paged server, in turns
    runs = {"captured": [], "uncaptured": [], "paged": []}
    for i in range(pairs):
        order = (("uncaptured", "captured", "paged") if i % 2 == 0 else
                 ("paged", "captured", "uncaptured"))
        for mode in order:
            if mode == "paged":
                m, outs = serve_once(torch, server, step, prompts,
                                     3000 + 100 * i)
                runs[mode].append((m, outs))
                continue
            m, got = wave_once(wave, prompts, captured=mode == "captured")
            assert (got == tokens).all(), \
                f"run {i}, {mode}: wave tokens differ from the counted run's"
            runs[mode].append((m, got))
    paged = runs["paged"][0][1]
    assert all(o == paged for _, o in runs["paged"]), "paged runs differ"

    def med(mode, kind):
        return statistics.median(1e3 * m.seconds[kind] / m.calls[kind]
                                 for m, _ in runs[mode])

    def total(mode):
        return statistics.median(1e3 * sum(m.seconds.values())
                                 for m, _ in runs[mode])

    log(f"  {pairs} runs of each in turns (wall ms per step on the host "
        f"clock around a step that ends synchronised, medians):")
    for kind in WaveMeter.KINDS:
        unc, cap = med("uncaptured", kind), med("captured", kind)
        log(f"    wave {kind} ({runs['captured'][0][0].calls[kind]} a "
            f"wave): captured {cap:.2f} ms, uncaptured {unc:.2f} ms "
            f"({unc / cap:.2f}x)")
    pm = runs["paged"][0][0]
    log(f"    the whole wave: captured {total('captured'):.2f} ms, "
        f"uncaptured {total('uncaptured'):.2f} ms; the paged server "
        f"(captured) on the same prompts {total('paged'):.2f} ms in its "
        f"steps: " + ", ".join(
            f"{pm.calls[k]} {k} at {med('paged', k):.2f} ms"
            for k in StepMeter.KINDS if pm.calls[k]))

    # the logits of both paths, uncaptured
    first, logit_toks, wave_gaps = wave_logit_run(torch, cfg, wave, prompts)
    assert (logit_toks == tokens).all(), \
        "the wave's logit run picked other tokens than its step"
    dev = wave.info.device.type
    # the paged path at the wave's own shapes (every prompt in one step):
    # the same kernels at the same shapes, so it must give the wave's rows
    # and tokens
    same, same_toks, same_gaps = paged_logit_run(torch, cfg, wave.params,
                                                 prompts, dev, batched=True)
    rel, agree = row_errors(first, same)
    log(f"  first new token's logit rows, wave against the paged path at the "
        f"wave's shapes (every prompt in one step): worst relative L2 error "
        f"per row {rel:.3e} (limit {PATH_TOL}), top-1 agreement {agree}/{b}")
    assert rel <= PATH_TOL, f"wave against paged: {rel:.3e} > {PATH_TOL}"
    tied = near_tie_rule(tokens, {r: list(t) for r, t in
                                  enumerate(same_toks.tolist())},
                         np.minimum(wave_gaps, same_gaps), NEAR_TIE)
    log(f"    their tokens equal up to each request's first near-tie (top-2 "
        f"gap < {NEAR_TIE}): {len(tied)} of {b} requests reach one "
        f"(request, its step, the first step that differs, its gap): "
        f"{tied}")
    # the paged path as the server runs it, chunks of SERVE["prefill_chunk"]
    pfirst, _, paged_gaps = paged_logit_run(torch, cfg, wave.params, prompts,
                                            dev)
    rel, agree = row_errors(first, pfirst)
    own = row_errors(same, pfirst)[0]
    log(f"  first new token's logit rows, wave against the paged path's "
        f"last prefill chunk: worst relative L2 error per row {rel:.3e}, "
        f"top-1 agreement {agree}/{b}; the paged path's own distance between "
        f"one step and chunks of {SERVE['prefill_chunk']}: {own:.3e}")
    tie = NEAR_TIE
    if recurrent:
        # bf16 rounding on this model moves a row by more than PATH_TOL
        # (the plain bf16 path on the CPU: PERF.md): hold the wave as far
        # from the server's chunking as the paged path itself is, and count
        # as near a gap below twice the paths' largest logit difference
        assert rel <= RECURRENT_FACTOR * own, \
            f"wave against paged: {rel:.3e} > {RECURRENT_FACTOR} x {own:.3e}"
        tie = max(NEAR_TIE, 2 * float((first - pfirst).abs().max()))
    else:
        assert rel <= PATH_TOL, f"wave against paged: {rel:.3e} > {PATH_TOL}"
    gaps = np.minimum(wave_gaps, paged_gaps)
    tied = near_tie_rule(tokens, paged, gaps, tie)
    log(f"  wave and paged server tokens equal up to each request's first "
        f"near-tie (top-2 gap < {tie:.3g} in either path's logits): "
        f"{len(tied)} of {b} requests reach one (request, its step, the "
        f"first step that differs, its gap): {tied}; the smallest gap of "
        f"each request {[round(float(g), 4) for g in gaps.min(1)]}")
    wave_path_check(torch, cfg, wave, prompts,
                    WAVE_PATH_LAYERS[cfg.name])
    return launches


def serve_wave_phase(torch, dev="cuda", zamba_params=None,
                     pairs: int = 0) -> dict:
    """qwen3-8b at its published widths, then zamba2-7b (with serve-zamba's
    sharded weights, ``zamba_params``, when that phase kept them), each as
    a wave (``launch.serve.make_wave_server``) and through a paged server
    on the same prompts and the same weights.  Returns each model's
    counted launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

    out = {}
    for arch, w in WAVE.items():
        t0 = time.perf_counter()
        cfg = get_config(arch)
        prompts = serve.wave_prompts(cfg, w["batch"], w["prompt_len"],
                                     w["seed"])
        max_seq = SERVE["max_seq"]
        if arch == MAIN and zamba_params is not None:
            wave = serve.make_wave_server(cfg, w["batch"], max_seq,
                                          zamba_params, device=dev,
                                          sharded=True)
            built = "serve-zamba's weights"
        else:
            wave = serve.make_wave_server(
                cfg, w["batch"], max_seq,
                lm.init_params(cfg, seed=w["seed"], device=dev), device=dev)
            built = "weights from a seed"
        scfg = serve.paged_server_config([len(p) for p in prompts], **SERVE)
        server, _ = serve.make_paged_server(cfg, scfg, wave.params,
                                            device=dev, sharded=True)
        step = server.step_fn
        if dev == "cuda":
            torch.cuda.synchronize()
        log(f"serve-wave {arch}: {cfg.num_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.num_heads} q / {cfg.num_kv_heads} kv heads "
            f"of {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; a wave of "
            f"{w['batch']} prompts of {w['prompt_len']} tokens, "
            f"{SERVE['max_new']} new each, caches of {max_seq} positions; "
            f"{built}, shared with a paged server; set-up "
            f"{time.perf_counter() - t0:.1f}s"
            + (f", device memory {torch.cuda.memory_allocated() / 2**30:.2f}"
               f" GiB" if dev == "cuda" else ""))
        out[arch] = wave_run(torch, cfg, wave, server, step, prompts, pairs)
        del wave, server, step
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 6c: calibration in one process.
# ---------------------------------------------------------------------------

#: the calibrated search: the paper's largest GPT at tp 8 on the H100 preset
CALIBRATE = dict(arch="gpt-m4", tp=8, seq=2048, batch=1,
                 topology="h100-sxm-8")


def calibrate_phase(torch) -> None:
    """``calibrate_mesh`` in one process on the card: no factorization of tp
    8 fits one rank, so the table is empty, and ``pick_plan`` with it gives
    the analytic search's plan (d1, d2, chunks and predicted cost).  No
    number here is a measurement of the card."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import comm_matrix
    from repro_torch.core.calibrate import calibrate_mesh
    from repro_torch.launch import train

    c = CALIBRATE
    table = calibrate_mesh(c["tp"], comm_matrix.PRESETS[c["topology"]]())
    log(f"calibrate: calibrate_mesh({c['tp']}, {c['topology']}) at world "
        f"size 1 on {torch.cuda.get_device_name(0)}: {len(table)} entries "
        f"(source {table.source!r})")
    assert table.entries == (), table
    cfg = get_config(c["arch"])
    plans = {cal: train.pick_plan(cfg, c["tp"], c["seq"], c["batch"],
                                  c["topology"], calibrate=cal).best
             for cal in (False, True)}
    for cal, p in plans.items():
        log(f"  pick_plan({c['arch']}, tp {c['tp']}, seq {c['seq']}, batch "
            f"{c['batch']}, calibrate={cal}): {p.describe()}; predicted "
            f"{p.predicted}")
    knobs = ("d1", "d2", "chunks", "boundary_mode", "seq_parallel",
             "wire_dtype", "predicted")
    a, b = ([getattr(plans[cal], k) for k in knobs] for cal in (False, True))
    assert a == b, f"the calibrated plan differs: {b} against {a}"


# ---------------------------------------------------------------------------
# Phases 7-9: training.
# ---------------------------------------------------------------------------

#: the training step's shape and depth (llama3-8b at its published widths)
TRAIN_SHAPE = dict(batch=1, seq=2048, layers=4, steps=6)
#: per-tensor relative L2 error of a bf16 gradient of a backward kernel
#: against its plain version (fp32 sums of bf16 inputs, output rounded at
#: 2^-8 and summed in another order)
BWD_REL = 2e-2
#: the same for rmsnorm's fp32 dgamma (its sum over rows is fp32 on both
#: sides; only the order differs)
DGAMMA_REL = 1e-3
#: the attention forward's fp32 log-sum-exp, absolute: an error e scales
#: the backward's recomputed probabilities by exp(e), so 1e-3 stays under
#: a quarter of a bf16 ulp
LSE_ATOL = 1e-3
#: the training path check's sequence (the fp32 CPU side's cost)
PATH_SEQ = 256


def rel_l2(got, want) -> float:
    g, w = got.float(), want.float()
    assert g.isfinite().all(), "non-finite gradient"
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def train_launches_per_step(cfg, remat: bool) -> tuple[dict, dict]:
    """Kernel launches of one training step at d1 = d2 = 1: the forward of
    ``launches_per_step`` (each remat unit's forward -- a dense block, a
    zamba super-block, a tail Mamba2 block -- once more when ``remat``
    recomputes it in the backward; the final norm and the head once), and
    per matmul two backward launches (dgrad and wgrad), per attention and
    per SSD scan one, per block norm one, per Mamba2 block one of the
    grouped, gated norm's backward (counted apart from the block norms'),
    and per gelu MLP (a dense block whose up projection fuses gelu) one of
    the activation's derivative.  llama3-8b at 4 layers: forward 33
    matmul, 8 flash_attention, 17 rmsnorm; backward 34 matmul, 4
    attention, 9 rmsnorm.  zamba2-7b at 14 layers (2 super-blocks of 6, a
    2-block tail: 12 Mamba2 blocks, 2 shared-block applications): forward
    97 matmul, 4 flash_attention, 57 rmsnorm, 24 ssd_scan; backward 98
    matmul, 2 attention, 17 rmsnorm, 12 grouped norm, 12 ssd_scan.  gpt-m2
    (4 layers, LayerNorm, gelu MLP): forward 33 matmul, 8
    flash_attention, 0 rmsnorm; backward 34 matmul, 4 attention, 4
    activation derivatives."""
    serve = launches_per_step(cfg)
    again = 2 if remat else 1
    # the head and the final norm (a launch only for an RMSNorm model)
    once = {"matmul": 1, "rmsnorm": 0 if cfg.norm_kind == "layernorm" else 1}
    fwd = {k: again * (v - once.get(k, 0)) + once.get(k, 0)
           for k, v in serve.items()}
    mamba_blocks = serve["ssd_scan"]
    bwd = {"matmul_bwd": 2 * serve["matmul"],
           "flash_attention_bwd": serve["flash_attention"],
           "rmsnorm_bwd": serve["rmsnorm"] - mamba_blocks,
           "group_rmsnorm_bwd": mamba_blocks, "ssd_scan_bwd": mamba_blocks,
           "matmul_act_bwd": (serve["flash_attention"]
                              if cfg.mlp_kind == "gelu" else 0)}
    return fwd, bwd


def _parent_build(parent, sources, what: str):
    """The older checkout's ``_build`` module (from ``parent``), its
    ``sources`` built into its own ``build/torch_kernels``."""
    import importlib.util

    path = Path(parent) / "src/repro_torch/kernels/_build.py"
    spec = importlib.util.spec_from_file_location("parent_build", path)
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    t0 = time.perf_counter()
    pb.build(sources)
    log(f"{what}: the parent's {', '.join(sources)} built in "
        f"{time.perf_counter() - t0:.1f}s into {pb.BUILD_DIR}")
    return pb


def parent_matmul(torch, ops, pb, parent):
    """The matmul kernel of the older checkout in ``parent`` (built by its
    ``_build`` module ``pb``), launched with that tree's own plans (its
    ``ops.matmul_plan``, loaded from its source) and its C arguments:
    callables ``fwd(a, b)`` (``a`` row-major, ``b`` row-major or a
    transposed view) and ``bwd(a, b, dz)``, the two launches of that
    tree's ``ops.matmul_backward``.  A C entry without ``a_trans`` (the
    trees before the training variant) gets wgrad's ``a^T`` as a copy, made
    inside the timed call, as its wrapper made it; one with the
    pre-activation pointer ``z`` gets null there."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "parent_ops", Path(parent) / "src/repro_torch/kernels/ops.py")
    po = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = po   # its dataclasses look their module up
    spec.loader.exec_module(po)
    entry = pb.entry("matmul")
    argtypes = pb.SIGNATURES["matmul"][2]
    reads_a_trans = len(argtypes) > 15
    # a tree whose matmul writes the pre-activation: a pointer z after out
    writes_z = argtypes.count(argtypes[0]) > 7
    p, stream = ops._ptr, ops._stream

    def mm(a, b):
        a_trans = int(reads_a_trans and not a.is_contiguous())
        M, K = a.shape
        N = b.shape[1]
        b_trans = int(not b.is_contiguous())
        vec = int((M if a_trans else K) % 8 == 0
                  and (K if b_trans else N) % 8 == 0)
        plan = po.matmul_plan(M, N, K, a_trans=True) if a_trans else \
            po.matmul_plan(M, N, K)
        out = torch.empty(M, N, dtype=a.dtype, device=a.device)
        ws = counters = None
        if plan.max_share > 1:
            ws = torch.empty(2 * plan.blocks * plan.bm * plan.bn,
                             dtype=torch.float32, device=a.device)
            counters = po._counters(a, plan.tiles)
        head = (p(a), p(b), None, p(out), *((None,) if writes_z else ()),
                p(ws), p(counters), M, N, K)
        tail = (0, vec, plan.variant, plan.blocks)
        args = (*head, a_trans, b_trans, *tail, plan.whole) \
            if reads_a_trans else (*head, b_trans, *tail)
        ops._check(entry(*args, stream(a)), "parent matmul")
        return out

    def bwd(a, b, dz):
        at = a.t() if reads_a_trans else a.t().contiguous()
        return mm(dz, b.t()), mm(at, dz)

    return mm, bwd


def parent_backward(torch, ops, parent):
    """The matmul, flash-attention and rmsnorm backward kernels of the older
    checkout in ``parent`` (from its own ``csrc`` sources), built by its own
    ``_build`` into its own ``build/torch_kernels``: callables with
    ``ops.flash_attention_backward``'s and ``ops.rmsnorm_backward``'s
    arguments, and the matmul's forward and backward
    (``parent_matmul``), for timing beside this tree's kernels.  The
    attention and norm C entries take this tree's arguments, so this
    tree's ``ops.*_backward_with`` prepares and launches them."""
    pb = _parent_build(parent, ("matmul", "flash_attention_bwd", "rmsnorm"),
                       "train-kernels")
    fa, rn = pb.entry("flash_attention_bwd"), pb.entry("rmsnorm_bwd")

    def fa_bwd(q, k, v, o, do, lse, qo, kl, causal=True, window=0,
               softcap=0.0):
        return ops.attention_backward_with(fa, q, k, v, o, do, lse, qo, kl,
                                           causal=causal, window=window,
                                           softcap=softcap)

    def rn_bwd(x, g, dy, eps):
        return ops.rmsnorm_backward_with(rn, x, g, dy, eps)

    return (fa_bwd, rn_bwd, *parent_matmul(torch, ops, pb, parent))


def parent_mamba_backward(torch, ops, parent):
    """The SSD-scan and grouped-norm backward kernels of the older checkout
    in ``parent``, built by its own ``_build``: this tree's
    ``ops.ssd_scan_backward`` and ``ops.group_rmsnorm_backward`` with the
    older tree's C entries loaded in place of this tree's for the call
    (their C arguments must be this tree's, as those of the chunk-parallel
    SSD backward are), for timing beside this tree's kernels.  Also that
    tree's matmul forward and backward (``parent_matmul``)."""
    from repro_torch.kernels import _build

    pb = _parent_build(parent, ("matmul", "ssd_scan_bwd", "rmsnorm"),
                       "train-zamba-kernels")
    names = ("ssd_scan_bwd", "group_rmsnorm_bwd")
    if any(pb.SIGNATURES[n] != _build.SIGNATURES[n] for n in names):
        raise ValueError(f"the C arguments of {parent}'s Mamba2 backward "
                         f"kernels differ from this tree's: time them with a "
                         f"chip_smoke.py whose tree matches them")
    theirs = {n: pb.entry(n) for n in names}

    def with_theirs(fn):
        def call(*args, **kw):
            saved = {n: _build._loaded.get(n) for n in names}
            _build._loaded.update(theirs)
            try:
                return fn(*args, **kw)
            finally:
                for n, f in saved.items():
                    if f is None:
                        _build._loaded.pop(n, None)
                    else:
                        _build._loaded[n] = f
        return call

    return (with_theirs(ops.ssd_scan_backward),
            with_theirs(ops.group_rmsnorm_backward),
            *parent_matmul(torch, ops, pb, parent))


def turns(timer, parent_fn, fn) -> list:
    """Parent, change, change, parent on the same timer: four medians."""
    return [timer(parent_fn), timer(fn), timer(fn), timer(parent_fn)]


def turns_line(t) -> str:
    """The four medians of ``turns``, for a before/after inside one call."""
    return (f"parent {t[0]:.4f} / {t[3]:.4f} ms, this tree {t[1]:.4f} / "
            f"{t[2]:.4f} ms (parent, tree, tree, parent)")


def interleaved(timer, parent_fn, fn) -> str:
    return turns_line(turns(timer, parent_fn, fn))


def plan_of(ops, variant: int):
    """``ops.matmul_plan`` with the tile variant forced (cached as it is),
    for ``swapped``: what another variant would take at a shape."""
    @functools.lru_cache(maxsize=None)
    def plan(M, N, K, sms=ops.SMS, *, a_trans=False):
        if variant == 2:
            return ops._persistent_plan(M, N, K, sms)
        return ops._stream_k_plan(M, N, K, sms, variant)
    return plan


def split_plan_of(ops):
    """``ops.attention_plan`` forced to variant 0 (``flash_attention.cu``,
    its row tiles and key splits) at any shape, for ``swapped``: what the
    serving kernel would take at a training shape."""
    def plan(b, sq, hq, hkv, skv, sms=ops.SMS, *, d=128):
        return ops.split_plan(b, sq, hq, hkv, skv, sms)
    return plan


#: the training attention's timed shapes at ``TRAIN_SHAPE``'s s, b = 1,
#: causal: (model, q heads, kv heads, head dim)
TRAIN_ATTENTION = (("llama3-8b", 32, 8, 128), ("gpt-m2", 32, 32, 128),
                   ("gpt-m3", 64, 64, 128), ("zamba2-7b", 32, 32, 112))


def train_attention_phase(torch, F, ops, ref, timer, floor, randn, failed,
                          weight: int):
    """The attention forward with its fp32 log-sum-exp at each model's
    training shape (``TRAIN_ATTENTION``): ``ops.attention_plan`` gives it
    variant 1 (``flash_attention_train.cu``, one launch, counted in
    ``ops.ATTENTION_VARIANT_LAUNCHES[1]``), held against the plain version
    (O within ``FA_TOL``, the log-sum-exp within ``LSE_ATOL``) and O against
    the plain mirror of the kernel's own order (``ref.attention_train_ref``,
    ``FA_TOL``); timed in turns with variant 0 (``flash_attention.cu``,
    forced through ``split_plan_of``: variant 0, 1, 1, 0), against the
    bound, the plain version, ``scaled_dot_product_attention`` and the
    timer's floor.  Each line names both plans.  Returns the KernelReport,
    with llama3-8b's ``weight`` launches a step on the ``TRAIN`` path."""
    T = TRAIN_SHAPE["batch"] * TRAIN_SHAPE["seq"]
    rep = KernelReport("flash_attention_train", "cuda",
                       "src/repro_torch/kernels/csrc/flash_attention_train.cu",
                       "src/repro/kernels/flash_attention.py:102", floor)
    log(f"train-kernels: flash_attention forward with its fp32 log-sum-exp "
        f"at b=1 s={T}, causal, on variant 1 (flash_attention_train.cu); O "
        f"within {FA_TOL} of the plain version and of the kernel's plain "
        f"mirror, log-sum-exp within {LSE_ATOL} absolute; timed in turns "
        f"with variant 0 (flash_attention.cu: 0, 1, 1, 0)")
    qo = torch.zeros(1, dtype=torch.int32, device="cuda")
    kl = torch.full((1,), T, dtype=torch.int32, device="cuda")
    for model, hq, hkv, d in TRAIN_ATTENTION:
        q, k, v = randn(1, T, hq, d), randn(1, T, hkv, d), randn(1, T, hkv, d)
        plan = ops.attention_plan(1, T, hq, hkv, T, d=d)
        before = ops.ATTENTION_VARIANT_LAUNCHES[1]
        out, lse = ops.flash_attention_lse(q, k, v, qo, kl)
        launched = ops.ATTENTION_VARIANT_LAUNCHES[1] - before
        want_out, want_lse = ref.attention_lse_ref(q, k, v, qo, kl)
        ok, err = within(out, want_out, **FA_TOL)
        ok_m, err_m = within(out, ref.attention_train_ref(q, k, v, qo, kl)[0],
                             **FA_TOL)
        lse_err = float((lse - want_lse).abs().max())
        ok = (ok and ok_m and bool(lse.isfinite().all())
              and lse_err <= LSE_ATOL and plan.variant == 1 and launched == 1)
        del out, lse, want_out, want_lse

        def v1():
            return ops.flash_attention_lse(q, k, v, qo, kl)

        def v0():
            with swapped(ops, attention_plan=split_plan_of(ops)):
                return ops.flash_attention_lse(q, k, v, qo, kl)

        t = turns(timer, v0, v1)
        old = ops.split_plan(1, T, hq, hkv, T)
        sched = ops.attention_train_schedule(1, T, hq, hkv, T)
        mask = ref.attention_mask(T, T, qo, kl)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        main = model == "llama3-8b"
        if not rep.add(
                f"{model} {hq}/{hkv} heads d={d}: mirror err {err_m:.2e}, lse "
                f"err {lse_err:.2e} [variant 1: {plan.row_tiles} row tiles "
                f"of {plan.rows} a head, {len(sched.blocks)} blocks; variant "
                f"0: {old.row_tiles} row tiles of {old.rows}, splits "
                f"{old.splits}] variant 0 {t[0]:.4f} / {t[3]:.4f} ms, "
                f"variant 1 {t[1]:.4f} / {t[2]:.4f} ms (0, 1, 1, 0)", ok,
                max(err, err_m, lse_err), {**FA_TOL, "lse_atol": LSE_ATOL},
                TRAIN if main else None, "train" if main else None,
                weight if main else 0, ms=(t[1] + t[2]) / 2,
                plain_ms=timer(lambda: ref.attention_lse_ref(q, k, v, qo, kl)),
                library_ms=timer(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=hq != hkv)),
                nbytes=2 * 2 * (q.numel() + k.numel()) + 4 * hq * T,
                flops=4 * d * int(mask.sum()) * hq):
            failed.append(f"flash_attention_train {model}")
        del q, k, v, qt, kt, vt, mask
    return rep


def matmul_steps(timer, ops, ref, torch, gemms, T, weights, prior, report,
                 bwd_report, failed, path, dev="cuda"):
    """Each projection ``(label, K, N)`` of ``gemms`` at M = ``T``, its
    forward against the plain version (``MM_TOL``) and its backward (dgrad
    and wgrad) against the plain backward (``BWD_REL`` relative L2), both
    timed against the bound and ``torch.matmul``, with ``weights[label]``
    = (forward launches, backward calls) per step of ``path``; each timed
    line names its plan.  ``prior`` (``parent_matmul``'s callables): also
    timed in turns with the older tree's kernel.  A shape whose B is small
    enough to stay in L2 (``ops.SMALL_B_BYTES``: the serving rule gives it
    variant 0) is also timed on variant 0, forward and dgrad: what
    ``ops.TRAIN_M`` overrides.  Returns the per-step ms in turns,
    ``{"forward": [4], "backward": [4]}``."""
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    per_step = {"forward": [0.0] * 4, "backward": [0.0] * 4}
    for label, K, N in gemms:
        w_fwd, w_bwd = weights[label]
        a, b = randn(T, K), randn(K, N, scale=K ** -0.5)
        dz = randn(T, N, scale=N ** -0.5)
        ok, err = within(ops.matmul(a, b), ref.matmul_ref(a, b), **MM_TOL)
        plan = ops.matmul_plan(T, N, K)
        small_b = 2 * K * N <= ops.SMALL_B_BYTES
        note = ""
        if small_b:
            with swapped(ops, matmul_plan=plan_of(ops, 0)):
                note = (f"; on {ops._stream_k_plan(T, N, K, ops.SMS, 0).name}"
                        f" {timer(lambda: ops.matmul(a, b)):.4f} ms")
        if not report.add(f"{label} M={T} K={K} N={N} [{plan.name} "
                          f"blocks={plan.blocks} whole={plan.whole}]{note}",
                          ok, err, MM_TOL, path, "train", w_fwd,
                          ms=timer(lambda: ops.matmul(a, b)),
                          plain_ms=timer(lambda: ref.matmul_ref(a, b)),
                          library_ms=timer(lambda: torch.matmul(a, b)),
                          nbytes=2 * (T * K + K * N + T * N),
                          flops=2 * T * K * N):
            failed.append(f"matmul {path} {label} M={T}")
        if prior is not None:
            t = turns(timer, lambda: prior[0](a, b), lambda: ops.matmul(a, b))
            per_step["forward"] = [x + w_fwd * y for x, y in
                                   zip(per_step["forward"], t)]
            log(f"  {'':16s} {label} forward: " + turns_line(t))
        da, db = ops.matmul_backward(a, b, dz)
        want_a, want_b = ref.matmul_bwd_ref(a, b, dz)
        errs = (rel_l2(da, want_a), rel_l2(db, want_b))
        err = max(float((da.float() - want_a.float()).abs().max()),
                  float((db.float() - want_b.float()).abs().max()))
        del da, db, want_a, want_b
        plans = (ops.matmul_plan(T, K, N), ops.matmul_plan(K, N, T,
                                                           a_trans=True))
        bt = b.t()
        note = ""
        if small_b:
            alone = timer(lambda: ops.matmul(dz, bt))
            with swapped(ops, matmul_plan=plan_of(ops, 0)):
                note = (f"; dgrad alone {alone:.4f} ms, on "
                        f"{ops._stream_k_plan(T, K, N, ops.SMS, 0).name} "
                        f"{timer(lambda: ops.matmul(dz, bt)):.4f} ms")
        if not bwd_report.add(
                f"{label} M={T} K={K} N={N} rel L2 dA {errs[0]:.2e} dB "
                f"{errs[1]:.2e} [dgrad {plans[0].name} blocks="
                f"{plans[0].blocks} whole={plans[0].whole}, wgrad "
                f"{plans[1].name} blocks={plans[1].blocks} whole="
                f"{plans[1].whole}]{note}", max(errs) <= BWD_REL, err,
                BWD_REL, path, "train", w_bwd,
                ms=timer(lambda: ops.matmul_backward(a, b, dz)),
                plain_ms=timer(lambda: ref.matmul_bwd_ref(a, b, dz)),
                library_ms=timer(lambda: (torch.matmul(dz, bt),
                                          torch.matmul(a.t(), dz))),
                nbytes=2 * (2 * T * K + 2 * K * N + T * N),
                flops=4 * T * K * N):
            failed.append(f"matmul_bwd {path} {label}")
        if prior is not None:
            t = turns(timer, lambda: prior[1](a, b, dz),
                      lambda: ops.matmul_backward(a, b, dz))
            per_step["backward"] = [x + w_bwd * y for x, y in
                                    zip(per_step["backward"], t)]
            log(f"  {'':16s} {label} backward: " + turns_line(t))
        del a, b, dz, bt
    if prior is not None:
        for what, t in per_step.items():
            log(f"{path}: matmul {what} per step, " + turns_line(t))
    return per_step


def by_kernel(torch, fn, calls: int = 10) -> str:
    """Device µs a launch of each kernel ``fn`` launches (once a call), by
    the profiler over ``calls`` back-to-back calls (no L2 flush between
    them).  After the serving phases' long profiles the profiler may
    record only some of these launches, or none: each mean is over the
    launches it recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    def name(key):
        m = re.search(r"(\w+kernel)(<[^>(]*>)?", key)
        return m[1] + (m[2] or "").replace(" ", "") if m else key[:40]

    return ", ".join(
        f"{name(e.key)} {e.self_device_time_total / e.count:.1f}"
        for e in prof.key_averages() if e.device_type == DeviceType.CUDA
    ) or "none recorded"


TRAIN_AB = """import statistics, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.launch import train
rows = train.main(sys.argv[2:])
print(statistics.median(r["ms"] for r in rows[2:]))"""


def parent_train_steps(parent, arch: str = "llama3-8b",
                       layers: int = TRAIN_SHAPE["layers"],
                       what: str = "train") -> None:
    """The training step of ``arch`` at ``layers`` of the tree in
    ``parent`` and of this one, in turns (parent, tree, tree, parent), each
    a process of its own running ``repro_torch.launch.train`` at
    ``TRAIN_SHAPE`` for 8 steps: the median ms of steps 3-8 of each run."""
    args = ["--arch", arch, "--layers", str(layers),
            "--seq", str(TRAIN_SHAPE["seq"]), "--batch",
            str(TRAIN_SHAPE["batch"]), "--steps", "8"]
    ms = []
    for tree in (Path(parent), ROOT, ROOT, Path(parent)):
        out = subprocess.run(
            [sys.executable, "-c", TRAIN_AB, str(tree / "src"), *args],
            capture_output=True, text=True, timeout=600, check=True)
        ms.append(float(out.stdout.split()[-1]))
    log(f"{what}: ms per step, parent {ms[0]:.2f} / {ms[3]:.2f}, this tree "
        f"{ms[1]:.2f} / {ms[2]:.2f} (parent, tree, tree, parent; steps 3-8 "
        f"of 8, a process each)")


def train_kernel_phase(torch, F, ops, ref, timer, floor, parent=None):
    """The forward kernels (the attention also writing its log-sum-exp)
    and the backward kernels at llama3-8b's training shapes against their
    plain versions; returns (the three forward KernelReports, the three
    backward ones), with totals per training step of ``TRAIN_SHAPE``.
    ``parent``: an older checkout whose backward kernels are timed beside
    this tree's (``parent_backward``)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    T, L = TRAIN_SHAPE["batch"] * TRAIN_SHAPE["seq"], TRAIN_SHAPE["layers"]
    prior = None if parent is None else parent_backward(torch, ops, parent)
    if floor is None:
        floor = timer(lambda: torch.cuda._sleep(0))
        log(f"train-kernels: timer floor {floor:.4f} ms (an empty kernel)")

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    failed = []
    # launches per step of each forward kernel (remat runs each block's
    # forward twice)
    fwd_per_step = train_launches_per_step(_train_config("llama3-8b", L),
                                           remat=True)[0]
    again = fwd_per_step["flash_attention"] // L
    mmf = KernelReport("matmul", "cuda", "src/repro_torch/kernels/csrc/matmul.cu",
                       "src/repro/kernels/matmul.py:102", floor)
    mm = KernelReport("matmul_bwd", "cuda",
                      "src/repro_torch/kernels/csrc/matmul.cu",
                      "src/repro/kernels/matmul.py:102", floor)
    log(f"train-kernels: matmul forward (tolerance |err| <= atol + "
        f"rtol*|plain|) and backward (dgrad dz.b^T and wgrad a^T.dz, two "
        f"launches; limit {BWD_REL} relative L2) at M = {T} tokens")
    weights = {label: ((L * again, L) if w > 1 else (1, 1))
               for label, _, _, w in LLAMA_GEMMS}
    matmul_steps(timer, ops, ref, torch,
                 [(label, K, N) for label, K, N, _ in LLAMA_GEMMS], T,
                 weights, None if prior is None else prior[2:], mmf, mm,
                 failed, TRAIN)
    log("train-kernels: the matmul's variant by rows (K = N = 4096), "
        "what sets ops.TRAIN_M")
    for M in (256, 512, 1024, 2048):
        a, b = randn(M, 4096), randn(4096, 4096, scale=1 / 64)
        t = {}
        for v in (1, 2):
            with swapped(ops, matmul_plan=plan_of(ops, v)):
                t[v] = timer(lambda: ops.matmul(a, b))
        names = [f"{bm}x{bn} {kind}" for bm, bn, _, kind in
                 ops.MATMUL_VARIANTS[1:]]
        log(f"  M={M}: {names[0]} {t[1]:.4f} ms, {names[1]} {t[2]:.4f} ms, "
            f"library {timer(lambda: torch.matmul(a, b)):.4f} ms; the plan "
            f"takes {ops.matmul_plan(M, 4096, 4096).name}")
        del a, b
    log("train-kernels: variant 2 by K at M = 2048, N = 4096 (256 tiles, two "
        "waves): the slope is the K step's cost, the rest the tile's")
    for role in ("forward", "dgrad", "wgrad"):
        cells = []
        for K in (1024, 4096, 16384):
            if role == "wgrad":
                a, b = randn(K, 2048).t(), randn(K, 4096, scale=K ** -0.5)
            elif role == "dgrad":
                a, b = randn(2048, K), randn(4096, K, scale=K ** -0.5).t()
            else:
                a, b = randn(2048, K), randn(K, 4096, scale=K ** -0.5)
            with swapped(ops, matmul_plan=plan_of(ops, 2)):
                ms = timer(lambda: ops.matmul(a, b))
            cells.append(f"K={K} {ms:.4f} ms (library "
                         f"{timer(lambda: torch.matmul(a, b)):.4f})")
            del a, b
        log(f"  {role}: " + ", ".join(cells))

    faf = train_attention_phase(torch, F, ops, ref, timer, floor, randn,
                                failed, L * again)

    rnf = KernelReport("rmsnorm", "cuda",
                       "src/repro_torch/kernels/csrc/rmsnorm.cu",
                       "src/repro/kernels/rmsnorm.py:30", floor)
    x = randn(T, 4096)
    g = torch.randn(4096, generator=gen, device="cuda")
    gb = g.to(torch.bfloat16)
    ok, err = within(ops.rmsnorm(x, g, eps=1e-5), ref.rmsnorm_ref(x, g, 1e-5),
                     **RN_TOL)
    plan = ops.rmsnorm_plan(T, 4096)
    if not rnf.add(f"rows={T} h=4096 [{plan.name}]", ok, err, RN_TOL, TRAIN,
                   "train", fwd_per_step["rmsnorm"],
                   ms=timer(lambda: ops.rmsnorm(x, g, eps=1e-5)),
                   plain_ms=timer(lambda: ref.rmsnorm_ref(x, g, 1e-5)),
                   library_ms=timer(lambda: F.rms_norm(x, (4096,), gb, 1e-5)),
                   nbytes=2 * 2 * x.numel() + 4 * g.numel(),
                   flops=4 * x.numel(), peak=FP32_TFLOPS):
        failed.append(f"rmsnorm rows={T}")
    del x

    fa = KernelReport("flash_attention_bwd", "cuda",
                      "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                      "src/repro/kernels/flash_attention.py:102", floor)
    log(f"train-kernels: flash_attention backward (dq, dk, dv; the kernel "
        f"reads the forward kernel's O and log-sum-exp, the plain backward "
        f"the plain forward's); limit {BWD_REL} relative L2")
    plan = ops.attention_bwd_plan(1, T, 32, 8, T)
    lens = plan.lengths()
    spans = [ops.bwd_visible_tiles(kt, 0, T, T, 4, True, 0)
             for kt in range(plan.key_tiles)]
    log(f"  dK/dV plan at s={T}, 32/8 heads: key tiles see "
        f"{spans[0][1] - spans[0][0]} to {spans[-1][1] - spans[-1][0]} row "
        f"tiles; {len(lens)} items of at most {plan.max_len} (longest "
        f"{max(lens)}, mean {sum(lens) / len(lens):.2f}, longest/mean "
        f"{max(lens) * len(lens) / sum(lens):.3f}), {plan.slots} partial "
        f"slots, {plan.blocks} persistent blocks")
    for label, b, s, hq, hkv, d, kw, kv_len, weight in (
            (f"llama3-8b b=1 s={T} causal", 1, T, 32, 8, 128, {}, None, L),
            ("d=112 hq=hkv=4 s=300, window 64, softcap 30", 1, 300, 4, 4,
             112, dict(window=64, softcap=30.0), None, 0),
            ("d=64 b=2 s=200 GQA 2:1, ragged kv", 2, 200, 4, 2, 64, {},
             (200, 163), 0),
            ("rows that see no key: b=2 s=96 window 32, kv_len 0 and 50", 2,
             96, 4, 2, 128, dict(window=32), (0, 50), 0),
            ("s=2100 (not a multiple of 64), 32/8 heads", 1, 2100, 32, 8,
             128, {}, None, 0)):
        q, do = randn(b, s, hq, d), randn(b, s, hq, d)
        k, v = randn(b, s, hkv, d), randn(b, s, hkv, d)
        qo = torch.zeros(b, dtype=torch.int32, device="cuda")
        kl = torch.tensor(kv_len or (s,) * b, dtype=torch.int32,
                          device="cuda")
        out, lse = ops.flash_attention_lse(q, k, v, qo, kl, **kw)
        got = ops.flash_attention_backward(q, k, v, out, do, lse, qo, kl, **kw)
        out_ref, lse_ref = ref.attention_lse_ref(q, k, v, qo, kl, **kw)
        want = ref.attention_bwd_ref(q, k, v, out_ref, do, lse_ref, qo, kl,
                                     **kw)
        del out_ref, lse_ref
        errs = [rel_l2(g, w) for g, w in zip(got, want)]
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        del got, want
        timing = {}
        if weight:
            mask = ref.attention_mask(s, s, qo, kl)
            visible = int(mask.sum()) * hq
            leaves = [t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v)]
            o_lib = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                   enable_gqa=True)
            do_lib = do.transpose(1, 2)
            timing = dict(
                ms=timer(lambda: ops.flash_attention_backward(
                    q, k, v, out, do, lse, qo, kl, **kw)),
                plain_ms=timer(lambda: ref.attention_bwd_ref(
                    q, k, v, out, do, lse, qo, kl, **kw)),
                library_ms=timer(lambda: torch.autograd.grad(
                    o_lib, leaves, do_lib, retain_graph=True)),
                nbytes=2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel(),
                flops=5 * 2 * d * visible)
            log(f"  {label}: 7-product bound (the design's count, dQ "
                f"recomputing S and dP) "
                f"{7 * 2 * d * visible / BF16_TFLOPS * 1e3:.4f} ms; by "
                f"kernel, µs a launch: " + by_kernel(
                    torch, lambda: ops.flash_attention_backward(
                        q, k, v, out, do, lse, qo, kl, **kw)))
            if prior is not None:
                log(f"  {label}: " + interleaved(timer, lambda: prior[0](
                    q, k, v, out, do, lse, qo, kl, **kw), lambda: (
                    ops.flash_attention_backward(q, k, v, out, do, lse, qo,
                                                 kl, **kw))))
        if not fa.add(f"{label}: rel L2 dq {errs[0]:.2e} dk {errs[1]:.2e} "
                      f"dv {errs[2]:.2e}", max(errs) <= BWD_REL, err,
                      BWD_REL, TRAIN if weight else None,
                      "train" if weight else None, weight, **timing):
            failed.append(f"flash_attention_bwd {label}")

    rn = KernelReport("rmsnorm_bwd", "cuda",
                      "src/repro_torch/kernels/csrc/rmsnorm.cu",
                      "src/repro/kernels/rmsnorm.py:30", floor)
    log(f"train-kernels: rmsnorm backward; dx limit {BWD_REL}, dgamma "
        f"{DGAMMA_REL} relative L2")
    for rows, h, weight in ((T, 4096, 2 * L + 1), (37, 3584, 0)):
        x, dy = randn(rows, h, scale=3.0), randn(rows, h)
        g = torch.rand(h, generator=gen, device="cuda") + 0.5
        dx, dg = ops.rmsnorm_backward(x, g, dy, eps=1e-5)
        want_dx, want_dg = ref.rmsnorm_bwd_ref(x, g, dy, 1e-5)
        errs = (rel_l2(dx, want_dx), rel_l2(dg, want_dg))
        err = max(float((dx.float() - want_dx.float()).abs().max()),
                  float((dg - want_dg).abs().max()))
        timing = {}
        if weight:
            xl = x.detach().requires_grad_(True)
            gl = g.to(torch.bfloat16).requires_grad_(True)
            y_lib = F.rms_norm(xl, (h,), gl, 1e-5)
            timing = dict(
                ms=timer(lambda: ops.rmsnorm_backward(x, g, dy, eps=1e-5)),
                plain_ms=timer(lambda: ref.rmsnorm_bwd_ref(x, g, dy, 1e-5)),
                library_ms=timer(lambda: torch.autograd.grad(
                    y_lib, (xl, gl), dy, retain_graph=True)),
                nbytes=2 * 3 * x.numel() + 4 * 2 * h,
                flops=8 * x.numel(), peak=FP32_TFLOPS)
            log(f"  rows={rows} h={h}: by kernel, µs a launch: " + by_kernel(
                torch, lambda: ops.rmsnorm_backward(x, g, dy, eps=1e-5)))
            if prior is not None:
                log(f"  rows={rows} h={h}: " + interleaved(
                    timer, lambda: prior[1](x, g, dy, 1e-5),
                    lambda: ops.rmsnorm_backward(x, g, dy, eps=1e-5)))
        if not rn.add(f"rows={rows} h={h}: rel L2 dx {errs[0]:.2e} dgamma "
                      f"{errs[1]:.2e}", errs[0] <= BWD_REL
                      and errs[1] <= DGAMMA_REL, err,
                      {"dx": BWD_REL, "dgamma": DGAMMA_REL},
                      TRAIN if weight else None,
                      "train" if weight else None, weight, **timing):
            failed.append(f"rmsnorm_bwd rows={rows}")
    if failed:
        raise AssertionError(f"training-shape kernels disagree with their "
                             f"plain versions: {failed}")
    return (mmf, faf, rnf), (mm, fa, rn)


#: the split rmsnorm's phase: (arch, d_model, the d2 it runs at, gemma's
#: 1 + gamma); each at every ``SPLIT_ROWS`` rows
SPLIT_SHAPES = (("llama3-8b", 4096, (2, 4), False),
                ("zamba2-7b", 3584, (2, 4), False),
                ("gemma2-2b", 2304, (2,), True))
#: a training step's rows (s = 2048), a prefill chunk's, a decode tick's
SPLIT_ROWS = (2048, 64, 4)
#: the split kernels' fp32 partial sums against their plain versions (the
#: same sums in another order)
SPLIT_REL = 1e-5
#: the split dx, relative L2, against the plain apply on the same rstd and
#: dot and against the whole-row backward kernel: the same fp32 arithmetic
#: (sums in another order) rounded to bf16, 1e-5 measured.  The dot's term
#: is about 1/sqrt(h) of dx on these inputs, so a dx that misses it, or
#: takes one slice's dot for the all-reduced one, is 1e-2 off
SPLIT_DX_REL = 1e-3
#: the four split kernels: (``ops.SPLIT_LAUNCHES`` key, what it computes)
SPLIT_KERNELS = (("rmsnorm_ss", "forward partial: sum x^2 a row"),
                 ("rmsnorm_apply", "forward apply: rstd, y = x rstd gamma"),
                 ("rmsnorm_bwd_partial",
                  "backward partial: sum dy gamma x a row, dgamma"),
                 ("rmsnorm_bwd_apply", "backward apply: dx"))


def split_norm(torch, ops, x, g, dy, d2: int, eps: float, fault=None):
    """The split norm of ``x [rows, h]`` on ``d2`` slices of its features
    in one process, the tp2 all-reduce played on the card: each slice's
    partial kernel, the slices' row sums added in slice order, each
    slice's apply kernel; then the same for the backward of ``dy``.
    ``fault``: ``"ss"``, the forward apply reads slice 0's own sum of
    squares, or ``"dot"``, the backward apply reads slice 0's own dot (no
    all-reduce).  Returns the slices' inputs and every kernel's outputs
    (``dot``: the all-reduced one)."""
    h = x.shape[-1]
    w = h // d2
    cut = [slice(i * w, (i + 1) * w) for i in range(d2)]
    xs = [x[:, c].contiguous() for c in cut]
    gs = [g[c].contiguous() for c in cut]
    dys = [dy[:, c].contiguous() for c in cut]
    ss_parts = [ops.rmsnorm_ss(xi) for xi in xs]
    ss = ss_parts[0] if fault == "ss" else torch.stack(ss_parts).sum(0)
    applied = [ops.rmsnorm_apply(xi, gi, ss, h, eps) for xi, gi in zip(xs, gs)]
    back = [ops.rmsnorm_bwd_partial(xi, gi, di, r)
            for xi, gi, di, (_, r) in zip(xs, gs, dys, applied)]
    dot = torch.stack([d for d, _ in back]).sum(0)
    dot_in = back[0][0] if fault == "dot" else dot
    dxs = [ops.rmsnorm_bwd_apply(xi, gi, di, r, dot_in, h)
           for xi, gi, di, (_, r) in zip(xs, gs, dys, applied)]
    return dict(xs=xs, gs=gs, dys=dys, ss_parts=ss_parts, ss=ss,
                applied=applied, back=back, dot=dot, dxs=dxs,
                y=torch.cat([y for y, _ in applied], -1),
                dx=torch.cat(dxs, -1),
                dgamma=torch.cat([dg for _, dg in back], -1))


def split_inputs(torch, gen, rows, h, plus_one):
    dev = gen.device
    x = (torch.randn(rows, h, generator=gen, device=dev) * 3).bfloat16()
    if plus_one:   # gemma2's 1 + gamma, resolved before the call
        g = 1.0 + 0.1 * torch.randn(h, generator=gen, device=dev)
    else:
        g = torch.rand(h, generator=gen, device=dev) + 0.5
    return x, g, torch.randn(rows, h, generator=gen, device=dev).bfloat16()


def within_ulp(torch, got, want) -> tuple[bool, float]:
    """Whether bf16 ``got`` is within one bf16 ulp of ``want`` everywhere;
    the largest difference."""
    err = (got.float() - want.float()).abs()
    return (bool((err <= bf16_ulp(torch, want)).all()
                 and got.float().isfinite().all()), float(err.max()))


def max_rel(got, want) -> float:
    """The largest elementwise relative difference (positive sums)."""
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


#: the split-norm phase's mesh run: llama3-8b's training rows at d2 = 2
#: (rows, d_model, d2, eps) and the inputs' seed
SPLIT_MESH = (2048, 4096, 2, 1e-5)
SPLIT_MESH_SEED = 8
#: one rank of that run (argv: the repo's root, the rank, a directory for
#: the file store and the results, the device, ``SPLIT_MESH`` as JSON)
SPLIT_RANK = """import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import torch
import torch.distributed as dist
import chip_smoke as cs
from repro_torch.analysis import signature
from repro_torch.core.atp import make_context
from repro_torch.core.mesh import atp_topo
from repro_torch.kernels import ops
from repro_torch.models import layers
rank, d, dev = int(sys.argv[2]), sys.argv[3], sys.argv[4]
rows, h, d2, eps = json.loads(sys.argv[5])
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=d2)
ctx = make_context(atp_topo(1, 1, d2), device_type="cpu")
x, g, dy = cs.split_inputs(torch, torch.Generator(device=dev).manual_seed(
    cs.SPLIT_MESH_SEED), rows, h, False)
w = h // d2
cut = slice(ctx.index2() * w, (ctx.index2() + 1) * w)
xs = x[:, cut].contiguous().requires_grad_(True)
gs = g[cut].contiguous().requires_grad_(True)
ops.reset_launches()
with signature.recording("fwd") as rec:
    y = layers.rms_norm(ctx, xs, gs, eps)
with signature.recording("bwd", rec):
    dx, dg = torch.autograd.grad(y, (xs, gs), dy[:, cut].contiguous())
if dev == "cuda":
    torch.cuda.synchronize()
torch.save(dict(y=y.detach().cpu(), dx=dx.cpu(), dg=dg.cpu(),
                split=dict(ops.SPLIT_LAUNCHES),
                whole=ops.LAUNCHES["rmsnorm"] + ops.BACKWARD_LAUNCHES[
                    "rmsnorm_bwd"], fwd=rec.by_key("fwd"),
                bwd=rec.by_key("bwd")),
           f"{d}/rank{rank}.pt")
dist.destroy_process_group()
"""


def split_norm_mesh(torch, ops, dev="cuda") -> list:
    """``models.layers.rms_norm`` on a (dp, d1, d2) = (1, 1, 2) mesh of two
    processes on the one card, over gloo (whose all-reduce takes CUDA
    tensors; NCCL refuses two ranks on one GPU), forward and backward:
    each rank must launch each split kernel once and the whole-row kernels
    never, and note one fp32 all-reduce of its rows over tp2 each way;
    the two slices' y, dx and dgamma against the whole-row kernels.
    Returns each rank's split launches."""
    import tempfile

    rows, h, d2, eps = SPLIT_MESH
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen([sys.executable, "-c", SPLIT_RANK,
                                   str(ROOT), str(r), d, dev,
                                   json.dumps(SPLIT_MESH)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(d2)]
        try:
            logs = [p.communicate(timeout=300)[0] for p in procs]
        finally:   # a rank that died leaves the other in a collective
            for p in procs:
                p.kill()
        for r, (p, out) in enumerate(zip(procs, logs)):
            if p.returncode:
                raise AssertionError(f"split-norm rank {r} failed:\n{out}")
        res = [torch.load(f"{d}/rank{r}.pt") for r in range(d2)]
    x, g, dy = split_inputs(torch, torch.Generator(device=dev).manual_seed(
        SPLIT_MESH_SEED), rows, h, False)
    y = torch.cat([r["y"] for r in res], -1).to(dev)
    ok_y, err_y = within_ulp(torch, y, ops.rmsnorm(x, g, eps=eps))
    wdx, wdg = ops.rmsnorm_backward(x, g, dy, eps=eps)
    e_dx = rel_l2(torch.cat([r["dx"] for r in res], -1).to(dev), wdx)
    e_dg = rel_l2(torch.cat([r["dg"] for r in res], -1).to(dev), wdg)
    ones = {k: 1 for k in ops.SPLIT_LAUNCHES}
    sums = {("", "psum", ("tp2",), False): (1, 4 * rows)}
    failed = [f"rank {i}: launches {r['split']}, whole-row {r['whole']}, "
              f"record {r['fwd']} {r['bwd']}" for i, r in enumerate(res)
              if r["split"] != ones or r["whole"] or r["fwd"] != sums
              or r["bwd"] != sums]
    log(f"split-norm: layers.rms_norm on a (1, 1, {d2}) gloo mesh of "
        f"{d2} processes on the card, {rows} rows of {h}: y within one bf16 "
        f"ulp of the whole-row kernel {ok_y} (max {err_y:.3e}), rel L2 dx "
        f"{e_dx:.2e}, dgamma {e_dg:.2e}; launches a rank "
        f"{[r['split'] for r in res]}, whole-row kernels "
        f"{[r['whole'] for r in res]}; rank 0's record, forward "
        f"{res[0]['fwd']}, backward {res[0]['bwd']}")
    if not ok_y or e_dx > SPLIT_DX_REL or e_dg > DGAMMA_REL or failed:
        raise AssertionError(f"the split rmsnorm on the two-rank mesh: "
                             f"{failed}")
    return [r["split"] for r in res]


def split_norm_phase(torch, ops, ref, timer, floor, dev="cuda"):
    """The split rmsnorm (d2 > 1) on the card at ``SPLIT_SHAPES``: the
    four kernels against their plain versions on the same inputs, the
    slices together against the whole-row kernels, a planted fault, and
    each kernel timed at llama3-8b's training rows at d2 = 2.  Returns
    the four KernelReports and the launches of the checked run."""
    from repro_torch.configs.registry import get_config

    gen = torch.Generator(device=dev).manual_seed(7)
    reports = {name: KernelReport(name, "cuda",
                                  "src/repro_torch/kernels/csrc/rmsnorm.cu",
                                  "src/repro/kernels/rmsnorm.py:30", floor)
               for name, _ in SPLIT_KERNELS}
    ss_r, apply_r, part_r, dx_r = reports.values()
    log(f"split-norm: the four kernels of the split rmsnorm, the tp2 "
        f"all-reduce played on the card (the slices' row sums added in one "
        f"process); partial sums within {SPLIT_REL} relative of their plain "
        f"versions, y within one bf16 ulp of the whole-row kernel and within "
        f"{RN_TOL} of the fp32 whole row, dx within {SPLIT_DX_REL} relative "
        f"L2 of the plain apply and of the whole-row backward kernel, dgamma "
        f"within {DGAMMA_REL}")
    failed, want_launches = [], {name: 0 for name, _ in SPLIT_KERNELS}
    ops.reset_launches()
    for arch, h, d2s, plus_one in SPLIT_SHAPES:
        eps = get_config(arch).norm_eps
        for d2 in d2s:
            for rows in SPLIT_ROWS:
                label = f"{arch} h={h} d2={d2} rows={rows}"
                x, g, dy = split_inputs(torch, gen, rows, h, plus_one)
                run = split_norm(torch, ops, x, g, dy, d2, eps)
                for name in want_launches:
                    want_launches[name] += d2
                # each kernel against its plain version on the same inputs
                err = max(max_rel(s, ref.rmsnorm_ss_ref(xi))
                          for s, xi in zip(run["ss_parts"], run["xs"]))
                if not ss_r.add(label, err <= SPLIT_REL, err, SPLIT_REL):
                    failed.append(f"rmsnorm_ss {label}")
                ok, err = True, 0.0
                for xi, gi, (y, r) in zip(run["xs"], run["gs"],
                                          run["applied"]):
                    py, pr = ref.rmsnorm_apply_ref(xi, gi, run["ss"], h, eps)
                    o, e = within_ulp(torch, y, py)
                    ok, err = ok and o and max_rel(r, pr) <= SPLIT_REL, \
                        max(err, e)
                whole = ops.rmsnorm(x, g, eps=eps)
                o, e = within_ulp(torch, run["y"], whole)
                o2, e2 = within(run["y"], ref.rmsnorm_ref(x.float(), g, eps),
                                **RN_TOL)
                if not apply_r.add(
                        f"{label}: y vs plain apply, whole-row kernel "
                        f"{e:.3e} (1 ulp), fp32 row {e2:.3e}", ok and o and o2,
                        max(err, e, e2), "1 bf16 ulp; RN_TOL vs fp32"):
                    failed.append(f"rmsnorm_apply {label}")
                ok_dot, err = True, 0.0
                for xi, gi, di, (_, r), (dot, dg) in zip(
                        run["xs"], run["gs"], run["dys"], run["applied"],
                        run["back"]):
                    pdot, pdg = ref.rmsnorm_bwd_partial_ref(xi, gi, di, r)
                    ok_dot = ok_dot and rel_l2(dot, pdot) <= SPLIT_REL and \
                        rel_l2(dg, pdg) <= SPLIT_REL
                    err = max(err, float((dot - pdot).abs().max()),
                              float((dg - pdg).abs().max()))
                wdx, wdg = ops.rmsnorm_backward(x, g, dy, eps=eps)
                e_dg = rel_l2(run["dgamma"], wdg)
                if not part_r.add(f"{label}: dot, dgamma vs plain; dgamma vs "
                                  f"whole-row kernel {e_dg:.2e} rel L2",
                                  ok_dot and e_dg <= DGAMMA_REL, err,
                                  {"plain": SPLIT_REL,
                                   "dgamma": DGAMMA_REL}):
                    failed.append(f"rmsnorm_bwd_partial {label}")
                e_plain = max(rel_l2(dxi, ref.rmsnorm_bwd_apply_ref(
                    xi, gi, di, r, run["dot"], h)) for xi, gi, di, (_, r), dxi
                    in zip(run["xs"], run["gs"], run["dys"], run["applied"],
                           run["dxs"]))
                e_dx = rel_l2(run["dx"], wdx)
                if not dx_r.add(f"{label}: dx rel L2 vs plain {e_plain:.2e}, "
                                f"vs whole-row kernel {e_dx:.2e}",
                                max(e_plain, e_dx) <= SPLIT_DX_REL,
                                float((run["dx"].float() - wdx.float()).abs()
                                      .max()), SPLIT_DX_REL):
                    failed.append(f"rmsnorm_bwd_apply {label}")
    if dev == "cuda":
        torch.cuda.synchronize()
    launches = dict(ops.SPLIT_LAUNCHES)
    log(f"split-norm: launches {launches} (expected {want_launches})")
    if launches != want_launches:
        failed.append(f"launch counts {launches} != {want_launches}")

    # planted faults: the forward apply reads slice 0's own sum of
    # squares; the backward apply reads slice 0's own dot
    for arch, h, d2s, plus_one in SPLIT_SHAPES:
        for d2 in d2s:
            x, g, dy = split_inputs(torch, gen, SPLIT_ROWS[0], h, plus_one)
            eps = get_config(arch).norm_eps
            bad = split_norm(torch, ops, x, g, dy, d2, eps, fault="ss")
            caught = not within_ulp(torch, bad["y"], ops.rmsnorm(
                x, g, eps=eps))[0]
            bad = split_norm(torch, ops, x, g, dy, d2, eps, fault="dot")
            e_dot = max(rel_l2(dxi, ref.rmsnorm_bwd_apply_ref(
                xi, gi, di, r, bad["dot"], h)) for xi, gi, di, (_, r), dxi
                in zip(bad["xs"], bad["gs"], bad["dys"], bad["applied"],
                       bad["dxs"]))
            e_whole = rel_l2(bad["dx"], ops.rmsnorm_backward(x, g, dy,
                                                             eps=eps)[0])
            caught_dot = min(e_dot, e_whole) > SPLIT_DX_REL
            log(f"  planted faults ({arch} d2={d2}): apply with the local "
                f"sum of squares {'caught' if caught else 'MISSED'}; dx with "
                f"the local dot {'caught' if caught_dot else 'MISSED'} (rel "
                f"L2 {e_dot:.2e} vs plain, {e_whole:.2e} vs whole row)")
            if not caught:
                failed.append(f"planted ss fault {arch} d2={d2} missed")
            if not caught_dot:
                failed.append(f"planted dot fault {arch} d2={d2} missed")

    # timing: llama3-8b's training rows at d2 = 2, one slice
    arch, h, _, _ = SPLIT_SHAPES[0]
    rows, d2, eps = SPLIT_ROWS[0], 2, get_config(arch).norm_eps
    x, g, dy = split_inputs(torch, gen, rows, h, False)
    run = split_norm(torch, ops, x, g, dy, d2, eps)
    x0, g0, dy0 = run["xs"][0], run["gs"][0], run["dys"][0]
    r0 = run["applied"][0][1]
    w, n = h // d2, rows * (h // d2)
    whole = {"forward": timer(lambda: ops.rmsnorm(x, g, eps=eps)),
             "backward": timer(lambda: ops.rmsnorm_backward(x, g, dy,
                                                            eps=eps))}
    label = f"{arch} rows={rows} d2={d2} (a {w}-wide slice)"
    for rep, fn, plain, nbytes, flops, side in (
            (ss_r, lambda: ops.rmsnorm_ss(x0),
             lambda: ref.rmsnorm_ss_ref(x0), 2 * n + 4 * rows, 2 * n,
             "forward"),
            (apply_r, lambda: ops.rmsnorm_apply(x0, g0, run["ss"], h, eps),
             lambda: ref.rmsnorm_apply_ref(x0, g0, run["ss"], h, eps),
             2 * 2 * n + 4 * w + 4 * 2 * rows, 3 * n, "forward"),
            (part_r, lambda: ops.rmsnorm_bwd_partial(x0, g0, dy0, r0),
             lambda: ref.rmsnorm_bwd_partial_ref(x0, g0, dy0, r0),
             2 * 2 * n + 4 * 2 * w + 4 * 2 * rows, 6 * n, "backward"),
            (dx_r, lambda: ops.rmsnorm_bwd_apply(x0, g0, dy0, r0, run["dot"],
                                                 h),
             lambda: ref.rmsnorm_bwd_apply_ref(x0, g0, dy0, r0, run["dot"],
                                               h),
             3 * 2 * n + 4 * w + 4 * 2 * rows, 5 * n, "backward")):
        grid = (ops.rmsnorm_plan(rows, w).name if side == "forward" else
                f"4 warps a row, {ops.RMSNORM_BWD_ROWS} rows a block at a "
                f"time, {ops.rmsnorm_bwd_blocks(rows)} blocks")
        ok = rep.add(f"{label} [{grid}]; whole-row "
                     f"{side} kernel over the {h}-wide rows "
                     f"{whole[side]:.4f}ms; no library call computes the "
                     f"split form", True, 0.0, None, SPLIT, "train", 1,
                     ms=timer(fn), plain_ms=timer(plain), library_ms=None,
                     nbytes=nbytes, flops=flops, peak=FP32_TFLOPS)
        assert ok
    if failed:
        raise AssertionError(f"the split rmsnorm kernels disagree: {failed}")
    split_norm_mesh(torch, ops, dev)
    return list(reports.values()), launches


# ---------------------------------------------------------------------------
# The matmul's int8 ``scale`` mode, and the quantized wire on the card.
# ---------------------------------------------------------------------------

#: llama3-8b's projections (name, K, N) at the rows of a serving chunk and
#: of a training step, with bias and gelu and with neither
INT8_GEMMS = (("q|k|v", 4096, 6144), ("up|gate", 4096, 28672),
              ("down", 14336, 4096))
INT8_ROWS = (64, 2048)
INT8_EPILOGUES = ((False, None), (True, "gelu"))
INT8_TOPS = 1979e12   # H100 SXM dense int8 tensor-core peak


def scale_after_bias(torch, ref, qa, qb, bias, scale, activation):
    """A planted fault: the int8 epilogue with the dequant scale applied
    after the bias."""
    acc = (qa.double() @ qb.double()).float()
    return ref.epilogue((acc + bias.float()) * scale, None,
                        activation).to(torch.bfloat16)


def int8_inputs(torch, gen, m, k, n, dev):
    """A quantized projection's operands as a user makes them: bf16
    activations and weights through ``ops.quantize_for_matmul``."""
    from repro_torch.kernels import ops

    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=gen, device=dev)
         / k ** 0.5).to(torch.bfloat16)
    bias = (torch.randn(n, generator=gen, device=dev) * 0.1).to(
        torch.bfloat16)
    (qa, sa), (qb, sb) = ops.quantize_for_matmul(x), ops.quantize_for_matmul(w)
    return qa, qb, bias, float(sa * sb)


def int8_matmul_phase(torch, ops, ref, timer, floor, dev="cuda"):
    """The int8 matmul kernel on llama3-8b's projections (``INT8_GEMMS`` at
    ``INT8_ROWS``, ``INT8_EPILOGUES``).  The path: each projection
    quantized and multiplied as a user calls it, counted; then the kernel
    against ``ref.matmul_int8_ref`` on the same operands (equal bit for bit
    with no activation: the int32 sum is exact and the scale one f32
    product; with bias and gelu within ``MM_TOL``, as the bf16 kernel's
    epilogue: tanhf against torch's gelu in f32, then the bf16 rounding),
    a planted fault (the scale after the bias) that the same check must
    catch, and each shape
    timed against the plain version, the bound and ``torch._int_mm``
    (cuBLASLt int8 -> int32) with the same epilogue in torch.  Returns the
    KernelReport and the path's launches."""
    gen = torch.Generator(device=dev).manual_seed(11)
    rep = KernelReport("matmul_int8", "cuda",
                       "src/repro_torch/kernels/csrc/matmul_int8.cu",
                       "src/repro/kernels/matmul.py:102", floor)
    shapes = [(name, m, k, n, has_bias, act)
              for name, k, n in INT8_GEMMS for m in INT8_ROWS
              for has_bias, act in INT8_EPILOGUES]
    inputs = [int8_inputs(torch, gen, m, k, n, dev)
              for _, m, k, n, _, _ in shapes]

    def call(i):
        (_, _, _, _, has_bias, act), (qa, qb, bias, scale) = shapes[i], \
            inputs[i]
        return ops.matmul_int8(qa, qb, bias if has_bias else None,
                               scale=scale, activation=act)

    ops.reset_launches()
    outs = [call(i) for i in range(len(shapes))]
    if dev == "cuda":
        torch.cuda.synchronize()
    launches = dict(ops.QUANT_LAUNCHES)
    log(f"int8-matmul: {len(shapes)} quantized llama3-8b projections, "
        f"launches {launches}")
    failed = [] if launches["matmul_int8"] == len(shapes) else [
        f"launches {launches}, expected {len(shapes)}"]
    for i, ((name, m, k, n, has_bias, act), (qa, qb, bias, scale)) in \
            enumerate(zip(shapes, inputs)):
        b = bias if has_bias else None
        want = ref.matmul_int8_ref(qa, qb, b, scale=scale, activation=act)
        if act is None:
            ok, err = bool(torch.equal(outs[i], want)), float(
                (outs[i].float() - want.float()).abs().max())
        else:
            ok, err = within(outs[i], want, **MM_TOL)
        ulps = float(((outs[i].float() - want.float()).abs()
                      / bf16_ulp(torch, want)).max())
        label = (f"{name} [{m}x{k}]@[{k}x{n}] "
                 f"{'bias+' + act if has_bias else 'no epilogue'} "
                 f"({ulps:.0f} bf16 ulp at most)")
        if has_bias and i == len(shapes) - 1:
            bad = scale_after_bias(torch, ref, qa, qb, bias, scale, act)
            caught = not within(outs[i], bad, **MM_TOL)[0]
            log(f"  planted fault (the scale after the bias) "
                f"{'caught' if caught else 'MISSED'}")
            if not caught:
                failed.append("planted scale-after-bias fault missed")

        def library(qa=qa, qb=qb, b=b, scale=scale, act=act):
            acc = torch._int_mm(qa, qb)
            return ref.epilogue(acc.float() * scale, b, act).to(
                torch.bfloat16)

        nbytes = m * k + k * n + 2 * m * n + (2 * n if has_bias else 0)
        if not rep.add(label, ok, err, "exact" if act is None else MM_TOL,
                       INT8, "train", 1,
                       ms=timer(lambda i=i: call(i)),
                       plain_ms=timer(lambda qa=qa, qb=qb, b=b, s=scale,
                                      a=act: ref.matmul_int8_ref(
                                          qa, qb, b, scale=s, activation=a)),
                       library_ms=timer(library), nbytes=nbytes,
                       flops=2 * m * k * n, peak=INT8_TOPS):
            failed.append(label)
    if failed:
        raise AssertionError(f"the int8 matmul kernel disagrees: {failed}")
    return rep, launches


#: the quant-wire phase: llama3-8b at its published widths, depth cut to
#: (layers), one step of (batch, seq) tokens on a (1, 2, 1) mesh of two
#: processes on the card
QUANT_WIRE = (2, 1, 256)
#: loss and gradient (relative L2 per leaf) distances a quantized wire may
#: have from the bf16 wire's (an H100 80GB HBM3 at 700 W).  At these
#: widths int8's gradients stand 0.126 from the bf16 wire's, 0.125 of it
#: from the forward's quantization alone (heavy-tailed activations on one
#: shared scale), and the plain witness reads 0.129 and 0.128 on the same
#: weights; the planted own-amax fault reads 0.209 and a loss 1.2e-2 off,
#: the sound runs 4.6e-3 at most.  int8's bounds sit between the two:
#: 1.5e-1 (fp8's) and 8e-3
QUANT_TOL = {"int8": (8e-3, 1.5e-1), "fp8": (3e-2, 1.5e-1)}
#: the most the quantized backward (the cotangents on the wire: the
#: conjugates' and the carried boundaries' all-reduces) may take the
#: gradients' distance past the quantized forward's alone: an error of its
#: own no larger than the forward's, the two adding in quadrature
#: (measured on the H100: 1.007x int8, 1.15x fp8)
QUANT_BWD = 2 ** 0.5
#: one rank of that run (argv: the repo's root, the rank, a directory for
#: the file store and the results, the device, "1" to plant the own-amax
#: fault, ``QUANT_WIRE`` as JSON, the wires as JSON, the first bf16; a
#: wire "w/forward" quantizes the forward only)
QUANT_RANK = """import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import torch
import torch.distributed as dist
import chip_smoke as cs
from repro_torch.analysis import signature
from repro_torch.core import atp, overlap
from repro_torch.core.atp import make_context
from repro_torch.core.mesh import atp_topo
from repro_torch.core.plan import ParallelPlan
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.optim import adamw
rank, d, dev, fault = int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
layers, b, s = json.loads(sys.argv[6])
wires = json.loads(sys.argv[7])
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=2)
if fault == "1":   # each rank quantizes with its own amax: no pmax
    quantize = overlap.wire_quantize
    overlap.wire_quantize = lambda x, group, axes, w: quantize(x, None,
                                                               axes, w)
cfg, params, batch = cs.quant_wire_model(torch, rank, dev)
leaves = adamw.tree_leaves(params)
for t in leaves:
    t.requires_grad_(True)
out, ref_grads = {"h": cfg.d_model}, None
conjugate = atp.conjugate
for name in wires:
    wire, _, only = name.partition("/")
    if only:   # the gradients' all-reduces at full width
        atp.conjugate = lambda ctx, x, axis, wire=False: conjugate(ctx, x,
                                                                   axis)
    ctx = make_context(atp_topo(1, 2, 1), plan=ParallelPlan(
        d1=2, d2=1, wire_dtype=wire), device_type="cpu")
    ops.reset_launches()
    with signature.recording("fwd") as rec:
        loss = lm.train_loss(ctx, cfg, params, batch, remat=False)
    with signature.recording("bwd", rec):
        grads = torch.autograd.grad(loss, leaves)
    if dev == "cuda":
        torch.cuda.synchronize()
    atp.conjugate = conjugate
    if ref_grads is None:
        ref_grads = grads
    out[name] = dict(loss=float(loss), launches=dict(ops.LAUNCHES),
                     fwd=rec.by_key("fwd"), bwd=rec.by_key("bwd"),
                     rel=max(cs.rel_l2(g, w) for g, w in zip(grads,
                                                             ref_grads)))
torch.save(out, f"{d}/rank{rank}.pt")
dist.destroy_process_group()
"""


def quant_wire_model(torch, rank: int, dev: str):
    """``QUANT_WIRE``'s config, this rank's shard of seeded bf16 weights on
    the (1, 2, 1) mesh, and one seeded batch."""
    import numpy as np

    from repro_torch.core.mesh import atp_topo
    from repro_torch.models import lm

    layers, b, s = QUANT_WIRE
    cfg = _train_config("llama3-8b", layers)
    params = lm.shard_params(cfg, lm.init_params(cfg, seed=0, device=dev),
                             lm.layout_context(atp_topo(1, 2, 1), rank))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s + 1))
    batch = {"tokens": torch.tensor(toks[:, :-1], dtype=torch.int32,
                                    device=dev),
             "labels": torch.tensor(toks[:, 1:], dtype=torch.int32,
                                    device=dev)}
    return cfg, params, batch


def quant_wire_run(torch, dev: str, fault: bool, wires) -> list:
    """Both ranks' results of ``QUANT_RANK`` on ``wires`` (bf16 first)."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen([sys.executable, "-c", QUANT_RANK,
                                   str(ROOT), str(r), d, dev,
                                   "1" if fault else "0",
                                   json.dumps(QUANT_WIRE),
                                   json.dumps(wires)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:   # a rank that died leaves the other in a collective
            for p in procs:
                p.kill()
        for r, (p, out) in enumerate(zip(procs, logs)):
            if p.returncode:
                raise AssertionError(f"quant-wire rank {r} failed:\n{out}")
        return [torch.load(f"{d}/rank{r}.pt") for r in range(2)]


def quant_wire_faults(res) -> list:
    """What is wrong with a quant-wire run: a quantized wire's loss or
    gradients too far from the bf16 wire's, ranks that disagree on a loss,
    a forward record without one quantized pmax and one quantized f32
    all-reduce per row boundary (two a layer) or with a full-width
    all-reduce of a block's payload, a path that launched no matmul."""
    layers, b, s = QUANT_WIRE
    h = res[0]["h"]
    faults = []
    for wire in [w for w in res[0] if w != "h" and "/" not in w]:
        losses = {r[wire]["loss"] for r in res}
        if len(losses) != 1:
            faults.append(f"{wire}: the ranks' losses differ: {losses}")
        for i, r in enumerate(res):
            run = r[wire]
            if run["launches"]["matmul"] == 0:
                faults.append(f"{wire} rank {i}: no matmul launched")
            fwd = run["fwd"]
            plain = fwd.get(("seg0:dense", "psum", ("tp1",), False))
            if wire == "bf16":
                continue
            tl, tg = QUANT_TOL[wire]
            dl = abs(run["loss"] - res[0]["bf16"]["loss"])
            if dl > tl:
                faults.append(f"{wire} rank {i}: loss off by {dl:.3e}")
            if run["rel"] > tg:
                faults.append(f"{wire} rank {i}: gradients "
                              f"{run['rel']:.3e} rel L2")
            fwd_only = r.get(f"{wire}/forward")
            if fwd_only and run["rel"] > QUANT_BWD * fwd_only["rel"] + 1e-3:
                faults.append(f"{wire} rank {i}: the quantized backward "
                              f"takes the gradients from {fwd_only['rel']:.3e}"
                              f" to {run['rel']:.3e} rel L2")
            want = {("seg0:dense", "pmax", ("tp1",), True): (
                        2 * layers, 4 * 2 * layers),
                    ("seg0:dense", "psum", ("tp1",), True): (
                        2 * layers, 4 * 2 * layers * b * s * h)}
            got = {k: v for k, v in fwd.items() if k[3]}
            if got != want or plain is not None:
                faults.append(f"{wire} rank {i}: record {got}, full-width "
                              f"{plain}; expected {want}")
    return faults


def quant_wire_phase(torch, dev="cuda") -> dict:
    """The quantized wire on psum boundaries: two processes on the one card
    over gloo (its all-reduce takes CUDA tensors; this mesh issues nothing
    else), mesh (1, 2, 1), llama3-8b at its widths cut to
    ``QUANT_WIRE``'s depth, one step's forward and backward on the bf16,
    int8 and fp8 wires: the losses within ``QUANT_TOL`` of the bf16 wire's,
    each gradient within its relative L2, and within ``QUANT_BWD`` times
    the distance the same wire gives quantizing the forward only, equal
    losses on both ranks, one quantized pmax and one quantized f32
    all-reduce per row boundary in each forward record; the plain
    witness's distances within ``QUANT_TOL`` (the bound admits an
    implementation independent of the port); then a planted fault (each
    rank's own amax, no pmax) that must fail both the loss's bound and the
    gradients'.  Returns rank 0's launches on the int8 wire."""
    wires = ["bf16", "int8", "fp8", "int8/forward", "fp8/forward"]
    res = quant_wire_run(torch, dev, False, wires)
    for wire in wires:
        r = res[0][wire]
        log(f"quant-wire {wire}: losses {[x[wire]['loss'] for x in res]}, "
            f"gradients' largest rel L2 from the bf16 wire "
            f"{[x[wire]['rel'] for x in res]}; rank 0 forward record "
            f"{sorted(r['fwd'].items())}; launches {r['launches']}")
    faults = quant_wire_faults(res)
    wit = quant_wire_witness(torch, dev)
    for wire, r in wit.items():
        log(f"quant-wire witness {wire}: loss {r['loss']!r} (off by "
            f"{r['dl']!r}), gradients' largest rel L2 from its exact ones "
            f"{r['rel']!r} ({r['leaf']})")
        tl, tg = QUANT_TOL.get(wire.partition("/")[0], (0.0, 0.0))
        if r["dl"] > tl or r["rel"] > tg:
            faults.append(f"the witness's {wire} wire is outside the "
                          f"bound: {r}")
    if faults:
        raise AssertionError(f"the quantized wire on the card: {faults}")
    bad = quant_wire_faults(quant_wire_run(torch, dev, True,
                                           ["bf16", "int8"]))
    log(f"  planted fault (each rank's own amax, no pmax): {bad}")
    # the fault must fail the gradients' bound as well as the loss's
    for what in ("loss", "gradients"):
        if not any(f.startswith("int8 rank") and what in f for f in bad):
            raise AssertionError(f"the planted own-amax fault passed the "
                                 f"{what} check: {bad}")
    return res[0]["int8"]["launches"]


def quant_wire_witness(torch, dev="cuda") -> dict:
    """``wire_witness_loss`` on the quant-wire phase's weights and batch
    (global, one process, (1, 2, 1)): per wire its loss, the loss's
    distance from the exact sums' and its gradients' largest relative L2
    from theirs, with the leaf."""
    import numpy as np

    from repro_torch.models import lm
    from repro_torch.optim import adamw

    layers, b, s = QUANT_WIRE
    cfg = _train_config("llama3-8b", layers)
    params = lm.init_params(cfg, seed=0, device=dev)
    names = _leaf_names(params)
    leaves = [t.requires_grad_(True) for t in adamw.tree_leaves(params)]
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s + 1))
    tokens = torch.tensor(toks[:, :-1], dtype=torch.int32, device=dev)
    labels = torch.tensor(toks[:, 1:], dtype=torch.int32, device=dev)
    out, exact = {}, None
    for name in ("bf16", "int8", "fp8", "int8/forward", "fp8/forward"):
        wire, _, only = name.partition("/")
        loss = wire_witness_loss(torch, cfg, params, tokens, labels, 2, 1,
                                 wire, backward=not only)
        grads = torch.autograd.grad(loss, leaves)
        lv = float(loss.detach())
        if exact is None:
            exact = (lv, grads)
        rel, leaf = max((rel_l2(g, w), n) for g, w, n in
                        zip(grads, exact[1], names))
        out[name] = dict(loss=lv, dl=abs(lv - exact[0]), rel=rel, leaf=leaf)
        del grads
    del params, leaves, exact
    if dev == "cuda":
        torch.cuda.empty_cache()
    out.pop("bf16")
    return out


# ---------------------------------------------------------------------------
# A plain witness of the quantized wire: one process, no mesh, no kernel of
# the port.  It computes the (dp 1, d1, d2) mesh's llama forward and
# backward on global tensors and cuts each GEMM the mesh splits into the
# ranks' partial products, so that every boundary the port puts on the
# wire sums the very partials the ranks hold:
#   forward  the row boundaries (f2, f4) over tp1 and the MLP's column
#            boundary (f3) over tp2;
#   backward the column-first inputs' partial gradients (q|k|v's and
#            up|gate's) over tp1, and the cotangent of f3's output (the
#            down projection's input gradient) over tp2.
# Everything else is exact.  ``tests/test_torch_wire_mesh.py`` holds the
# port's gradients to it; the quant-wire phase reads its distances at
# full width beside the port's.
# ---------------------------------------------------------------------------


def witness_sum(torch, wire: str, parts, given=None, keep=None):
    """What a boundary gives for the partial sums ``parts`` (every rank of
    one group, in group order): their sum ("bf16"), or on the quantized
    wire their grid values on one shared scale (the largest ``amax`` times
    the f32 reciprocal of 127 or 448), summed in f32, times the scale, in
    the parts' dtype.  ``given``: (each part's grid values, the scale) in
    place of its own; ``keep(qs, quotients)``: called with its own grid
    values."""
    if wire == "bf16":
        out = parts[0]
        for t in parts[1:]:
            out = out + t
        return out
    xs = [t.float() for t in parts]
    amax = torch.stack([x.abs().amax() for x in xs]).amax()
    qmax = 448.0 if wire == "fp8" else 127.0
    scale = torch.clamp_min(amax * torch.tensor(
        1.0 / qmax, dtype=torch.float32, device=amax.device), 1e-12)
    if wire == "fp8":
        qs = [(x / scale).to(torch.float8_e4m3fn).float() for x in xs]
    else:
        qs = [torch.clamp(torch.round(x / scale), -qmax, qmax) for x in xs]
    if keep is not None:
        keep(qs, [x / scale for x in xs])
    if given is not None:
        qs, scale = given
    total = qs[0]
    for q in qs[1:]:
        total = total + q
    return (total * scale).to(parts[0].dtype)


def _witness_functions(torch):
    class Sum(torch.autograd.Function):
        """``reduce(parts)`` forward; each part's gradient is the sum's."""

        @staticmethod
        def forward(ctx, reduce, *parts):
            ctx.n = len(parts)
            return reduce(list(parts))

        @staticmethod
        def backward(ctx, g):
            return (None,) + (g,) * ctx.n

    class Fan(torch.autograd.Function):
        """``n`` copies of x forward; backward, ``reduce`` of their
        gradients (the ranks' partial gradients of a shared input)."""

        @staticmethod
        def forward(ctx, reduce, n, x):
            ctx.reduce = reduce
            return tuple(x.clone() for _ in range(n))

        @staticmethod
        def backward(ctx, *gs):
            return None, None, ctx.reduce(list(gs))

    return Sum, Fan


def wire_witness_loss(torch, cfg, p, tokens, labels, d1: int, d2: int,
                      wire: str = "bf16", backward: bool = True,
                      replay=None, bwd_replay=None, own=None):
    """The mean loss of a dense swiglu llama (RMSNorm, RoPE, grouped-query
    causal attention, an untied head) on the global JAX-layout tree ``p``
    as the (1, d1, d2) mesh computes it on ``wire`` (module comment);
    ``backward=False`` keeps the gradients' sums exact.  ``replay``: the
    forward boundaries' grid values and scales by call and rank
    (``q{CALL}_{RANK}``, ``s{CALL}_{RANK}``, rank = i1 * d2 + i2, calls in
    the forward's order: per layer f2, f3 where d2 > 1, f4);
    ``bwd_replay``: the same for the backward's sums (calls in the
    backward's order, the forward's fan-outs last to first); ``own``: a
    dict the backward's own grid values and quotients are written to
    (``q{CALL}_{RANK}``, ``r{CALL}_{RANK}``)."""
    Sum, Fan = _witness_functions(torch)
    dev = tokens.device
    b, s = tokens.shape
    H, KV = cfg.num_heads, cfg.num_kv_heads
    hd = cfg.head_dim or cfg.d_model // H
    calls = iter(range(1 << 30))
    fans = []   # the backward's calls, in the forward's order

    def given(tree, k, ranks):
        if tree is None:
            return None
        return ([torch.as_tensor(tree[f"q{k}_{r}"], device=dev)
                 for r in ranks],
                torch.as_tensor(tree[f"s{k}_{ranks[0]}"],
                                device=dev).reshape(()))

    def boundary(groups):
        """One forward boundary: per group (parts, their ranks)."""
        k = next(calls)
        return [Sum.apply(lambda ps, g=given(replay, k, ranks):
                          witness_sum(torch, wire, ps, g), *parts)
                for parts, ranks in groups]

    def fan(x, ranks, call):
        """``x`` to the ranks of one group; backward, their partial
        gradients summed as backward call ``len(fans) - 1 - call``."""
        def reduce(gs):
            k = len(fans) - 1 - call

            def keep(qs, rs):
                for r, q, quo in zip(ranks, qs, rs):
                    own[f"q{k}_{r}"] = q.cpu().numpy()
                    own[f"r{k}_{r}"] = quo.cpu().numpy()
            return witness_sum(torch, wire if backward else "bf16", gs,
                               given(bwd_replay, k, ranks),
                               keep=None if own is None else keep)
        return list(Fan.apply(reduce, len(ranks), x))

    def fan_out(xs, groups):
        """One backward call: ``xs[g]`` to the ranks ``groups[g]``."""
        if len(groups[0]) == 1:
            return [[x] for x in xs]
        fans.append(len(fans))
        return [fan(x, ranks, fans[-1]) for x, ranks in zip(xs, groups)]

    def col_groups():
        """Per tp2 block, its ranks over tp1."""
        return [[r1 * d2 + r2 for r1 in range(d1)] for r2 in range(d2)]

    def cut(w, r2, r1):
        """Rank (r1, r2)'s block of a column-first weight [K, N]."""
        return w.chunk(d2, 0)[r2].chunk(d1, -1)[r1]

    def rms(x, g):
        xf = x.float()
        return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True)
                                 + cfg.norm_eps) * g.float()).to(x.dtype)

    ang = torch.arange(s, device=dev).float()[:, None] / cfg.rope_theta ** (
        torch.arange(0, hd, 2, device=dev).float() / hd)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]

    def rope(t):
        t1, t2 = t.float().chunk(2, -1)
        return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin],
                         -1).to(t.dtype)

    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    x = p["embed"][tokens.long()]
    seg = p["seg0"]
    for layer in range(cfg.num_layers):
        a = {k: v[layer] for k, v in seg["attn"].items()}
        m = {k: v[layer] for k, v in seg["mlp"].items()}
        # f1: the fused q|k|v of each rank, summed over tp2 exactly
        hs = fan_out(rms(x, seg["ln_attn"]["scale"][layer]).chunk(d2, -1),
                     col_groups())
        qkv = [witness_sum(torch, "bf16", [
            hs[r2][r1] @ torch.cat([cut(a[n], r2, r1)
                                    for n in ("wq", "wk", "wv")], -1)
            for r2 in range(d2)]) for r1 in range(d1)]
        qd, kvd = H * hd // d1, KV * hd // d1
        q = rope(torch.cat([t[..., :qd] for t in qkv], -1).view(b, s, H, hd))
        k = rope(torch.cat([t[..., qd:qd + kvd] for t in qkv],
                           -1).view(b, s, KV, hd))
        v = torch.cat([t[..., qd + kvd:] for t in qkv],
                      -1).view(b, s, KV, hd)
        k, v = (t.repeat_interleave(H // KV, 2) for t in (k, v))
        sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / hd ** 0.5
        pr = sc.masked_fill(~causal, float("-inf")).softmax(-1).to(q.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", pr, v).reshape(b, s, H * hd)
        # f2 over tp1
        os_ = o.chunk(d1, -1)
        wo = [[t.chunk(d2, -1)[r2] for r2 in range(d2)]
              for t in a["wo"].chunk(d1, 0)]
        x = x + torch.cat(boundary([
            ([os_[r1] @ wo[r1][r2] for r1 in range(d1)],
             [r1 * d2 + r2 for r1 in range(d1)]) for r2 in range(d2)]), -1)
        # f3 over tp2, which carries the down projection's input conjugate
        hs = fan_out(rms(x, seg["ln_mlp"]["scale"][layer]).chunk(d2, -1),
                     col_groups())
        parts = [[hs[r2][r1] @ torch.cat([cut(m[n], r2, r1)
                                          for n in ("w_up", "w_gate")], -1)
                  for r2 in range(d2)] for r1 in range(d1)]
        ug = ([ps[0] for ps in parts] if d2 == 1 else boundary([
            (parts[r1], [r1 * d2 + r2 for r2 in range(d2)])
            for r1 in range(d1)]))
        acts = [[u * torch.nn.functional.silu(g)
                 for u, g in (t.chunk(2, -1) for t in row)]
                for row in (fan_out(ug, [[r1 * d2 + r2 for r2 in range(d2)]
                                         for r1 in range(d1)])
                            if d2 > 1 else [[t] for t in ug])]
        # f4 over tp1
        wd = [[t.chunk(d2, -1)[r2] for r2 in range(d2)]
              for t in m["w_down"].chunk(d1, 0)]
        x = x + torch.cat(boundary([
            ([acts[r1][r2] @ wd[r1][r2] for r1 in range(d1)],
             [r1 * d2 + r2 for r1 in range(d1)]) for r2 in range(d2)]), -1)
    logits = (rms(x, p["final_norm"]["scale"]) @ p["lm_head"]).float()
    logits, labels = logits.reshape(-1, logits.shape[-1]), labels.reshape(-1)
    # an ignored label (-1) counts in the mean with a loss of 0
    picked = logits.gather(-1, labels.long().clamp_min(0)[:, None])[:, 0]
    per_tok = torch.logsumexp(logits, -1) - picked
    return torch.where(labels == -1, torch.zeros_like(per_tok),
                       per_tok).mean()


#: zamba2-7b's training depth: two super-blocks of 6 and a 2-block tail
ZAMBA_TRAIN_LAYERS = 14
#: the zamba training path check: one super-block and a one-block tail,
#: and two SSD chunks of 64
ZAMBA_PATH = dict(layers=7, seq=128)


def ssd_bwd_cost(b, s, nh, hd, ds, chunk):
    """(bytes, flops) of one SSD scan backward from a zero state: x, dy
    and dx, dt and ddt, B, C, dB and dC, A_log, D, dA_log and dD each moved
    once; per head and chunk of length l, the causal halves of C.B^T, of
    dy.x^T and of the three products with the decayed (t, u) matrices
    (dx's, dC's and dB's), and the five full products with the chunk's
    state or its gradient (dS.B, dy^T.S, x^T.dS, the dS update and the
    recomputed state update)."""
    nbytes = (3 * 2 * b * s * nh * hd + 2 * 4 * b * s * nh
              + 4 * 2 * b * s * ds + 4 * 4 * nh)
    flops = 0
    for c0 in range(0, s, chunk):
        n = min(chunk, s - c0)
        flops += 5 * n * (n + 1) * hd + 5 * 2 * n * hd * ds
    return nbytes, b * nh * flops


def ssd_bwd_design_floor(plan, b, s, nh, hd, ds) -> tuple[float, float]:
    """(bytes, flops) that ``csrc/ssd_scan_bwd.cu`` moves and computes as
    designed, beyond what the function must: its fp32 increments, then
    states (Delta/S, Gamma/dS: each written by the chunk kernel, read and
    written by the passing kernel, read by the gradient kernel), x and dy
    read a second time, the head groups' partial rows of dB and dC written
    and read; and every product as run, in bf16 on tensor cores: full
    64 x 64 tiles (the causal ones on the diagonal blocks of 16), fp32
    operands split into two."""
    nbytes = (4 * 2 * 4 * b * nh * plan.nc * hd * ds
              + 2 * 2 * b * s * nh * hd + 2 * 4 * b * plan.groups * s * 2 * ds)
    full = 2 * 64 ** 3                 # one 64 x 64 x 64 product
    causal = 10 * 2 * 16 * 16 * 64     # its 10 blocks of 16 x 16 on and
    #                                    below the diagonal
    per_head = (2 * 2 * full           # Delta, Gamma (hi/lo)
                + causal + causal      # C.B^T (rows t, u <= t), dy.x^T
                + 2 * causal           # Z.B (hi/lo)
                + 2 * full             # dy.S (hi/lo)
                + 2 * causal + 2 * full   # W^T.dy, B.dS^T
                + 2 * causal + 2 * full)  # Z^T.C, x.dS
    return nbytes, b * plan.nc * nh * per_head


#: heads a block of the SSD backward timed beside the plan's choice
SSD_BWD_CANDIDATES = (1, 2, 4, 8)
#: token shares of the grouped backward timed beside the plan's choice
GROUP_BWD_CANDIDATES = (132, 264, 396)


def zamba_train_kernel_phase(torch, F, ops, ref, timer, floor, parent=None):
    """The two Mamba2 backward kernels at zamba2-7b's training shapes
    against their plain backward, timed (each also at the other grids its
    plan chooses among, and, with ``parent``, in turns with the older
    checkout's kernels: ``parent_mamba_backward``); then the step's other
    new shapes for correctness.  Returns the two KernelReports, with totals
    per training step of ``ZAMBA_TRAIN_LAYERS`` layers."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    T, nh, hd, ds, chunk = TRAIN_SHAPE["seq"], 112, 64, 64, 64
    if floor is None:
        floor = timer(lambda: torch.cuda._sleep(0))
        log(f"train-zamba-kernels: timer floor {floor:.4f} ms (an empty "
            f"kernel)")
    per_step = train_launches_per_step(
        _train_config("zamba2-7b", ZAMBA_TRAIN_LAYERS), remat=True)[1]
    prior = None if parent is None else parent_mamba_backward(torch, ops,
                                                              parent)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    failed = []
    ssd = KernelReport("ssd_scan_bwd", "cuda",
                       "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                       "src/repro/kernels/ssd_scan.py:74", floor)
    plan = ops.ssd_bwd_plan(1, T, nh, chunk)
    log(f"train-zamba-kernels: ssd_scan backward at b=1 s={T} nh={nh} "
        f"hd={hd} ds={ds} chunk={chunk} [{plan.name}]; dx, dB, dC within "
        f"{BWD_REL}, ddt, dA_log, dD within {DGAMMA_REL} relative L2")
    x, dy = randn(1, T, nh, hd), randn(1, T, nh, hd)
    dt = F.softplus(torch.randn(1, T, nh, generator=gen, device="cuda"))
    A_log = torch.randn(nh, generator=gen, device="cuda") * 0.5
    D = torch.randn(nh, generator=gen, device="cuda")
    bc = randn(1, T, 2 * ds)
    args = (x, dt, A_log, bc[..., :ds], bc[..., ds:], D, dy)
    got = ops.ssd_scan_backward(*args, chunk=chunk)
    want = ref.ssd_bwd_ref(*args, chunk)
    names = ("dx", "ddt", "dA_log", "dB", "dC", "dD")
    errs = {n: rel_l2(g, w) for n, g, w in zip(names, got, want)}
    ok = all(e <= (BWD_REL if g.dtype == torch.bfloat16 else DGAMMA_REL)
             for e, g in zip(errs.values(), got))
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    del got, want
    nbytes, flops = ssd_bwd_cost(1, T, nh, hd, ds, chunk)
    d_bytes, d_flops = ssd_bwd_design_floor(plan, 1, T, nh, hd, ds)
    log(f"  bounds: the function's bytes {nbytes / HBM_BYTES_S * 1e3:.4f} ms, "
        f"its operations {flops / BF16_TFLOPS * 1e3:.4f} ms at the bf16 "
        f"peak; as designed {(nbytes + d_bytes) / HBM_BYTES_S * 1e3:.4f} ms "
        f"of bytes (fp32 scratch and second reads {d_bytes / 1e6:.0f} MB) "
        f"and {d_flops / BF16_TFLOPS * 1e3:.4f} ms of tensor-core products "
        f"({d_flops / 1e9:.1f} GFLOP with the hi/lo splits)")
    log(f"  by kernel, µs a launch: " + by_kernel(
        torch, lambda: ops.ssd_scan_backward(*args, chunk=chunk)))
    for heads in SSD_BWD_CANDIDATES:
        cand = ops.SsdBwdPlan(1, plan.nc, nh, heads)
        with swapped(ops, ssd_bwd_plan=lambda *a, **k: cand):
            ms = timer(lambda: ops.ssd_scan_backward(*args, chunk=chunk))
        log(f"  [{cand.name}] {ms:.4f} ms a launch")
    if prior is not None:
        log(f"  against the parent's ssd_scan_bwd: " + interleaved(
            timer, lambda: prior[0](*args, chunk=chunk),
            lambda: ops.ssd_scan_backward(*args, chunk=chunk)))
    if not ssd.add(f"b=1 s={T} nh={nh}: rel L2 " + " ".join(
            f"{n} {e:.2e}" for n, e in errs.items()), ok, err,
            {"bf16": BWD_REL, "fp32": DGAMMA_REL}, TRAIN_ZAMBA, "train",
            per_step["ssd_scan_bwd"],
            ms=timer(lambda: ops.ssd_scan_backward(*args, chunk=chunk)),
            plain_ms=timer(lambda: ref.ssd_bwd_ref(*args, chunk)),
            library_ms=None, nbytes=nbytes, flops=flops, fp32_bound=True):
        failed.append("ssd_scan_bwd")
    del x, dy, bc, args

    grp = KernelReport("group_rmsnorm_bwd", "cuda",
                       "src/repro_torch/kernels/csrc/rmsnorm.cu",
                       "src/repro/kernels/rmsnorm.py:30", floor)
    gplan = ops.group_rmsnorm_bwd_plan(T, nh, hd)
    log(f"train-zamba-kernels: the grouped, gated norm's backward at {T} "
        f"tokens x {nh} groups of {hd}, the gate a slice of the z|x output "
        f"[{gplan.name}]; dy, dgate within {BWD_REL}, dgamma within "
        f"{DGAMMA_REL}")
    y, dout = randn(T, nh, hd, scale=2.0), randn(T, nh, hd)
    gamma = torch.rand(nh, hd, generator=gen, device="cuda") + 0.5
    z = randn(T, 2 * nh * hd)[:, :nh * hd].unflatten(-1, (nh, hd))
    got = ops.group_rmsnorm_backward(y, gamma, dout, gate=z)
    want = ref.group_rmsnorm_bwd_ref(y, gamma, dout, 1e-6, z)
    errs = {n: rel_l2(g, w) for n, g, w in zip(("dy", "dgamma", "dgate"),
                                               got, want)}
    ok = (errs["dy"] <= BWD_REL and errs["dgate"] <= BWD_REL
          and errs["dgamma"] <= DGAMMA_REL)
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    del got, want

    def grouped():
        return ops.group_rmsnorm_backward(y, gamma, dout, gate=z)

    log(f"  by kernel, µs a launch: " + by_kernel(torch, grouped))
    for shares in GROUP_BWD_CANDIDATES:
        cand = dataclasses.replace(gplan, shares=shares)
        with swapped(ops, group_rmsnorm_bwd_plan=lambda *a, **k: cand):
            ms = timer(grouped)
        log(f"  [{cand.name}] {ms:.4f} ms a launch")
    if prior is not None:
        log(f"  against the parent's grouped backward: " + interleaved(
            timer, lambda: prior[1](y, gamma, dout, gate=z), grouped))
    if not grp.add(f"{T}x{nh} rows of {hd}, gated: rel L2 " + " ".join(
            f"{n} {e:.2e}" for n, e in errs.items()), ok, err,
            {"dy, dgate": BWD_REL, "dgamma": DGAMMA_REL}, TRAIN_ZAMBA,
            "train", per_step["group_rmsnorm_bwd"], ms=timer(grouped),
            plain_ms=timer(lambda: ref.group_rmsnorm_bwd_ref(y, gamma, dout,
                                                             1e-6, z)),
            library_ms=None, nbytes=2 * 5 * y.numel() + 4 * 2 * gamma.numel(),
            flops=20 * y.numel(), peak=FP32_TFLOPS):
        failed.append("group_rmsnorm_bwd")
    del y, dout, z

    mmf = KernelReport("matmul", "cuda",
                       "src/repro_torch/kernels/csrc/matmul.cu",
                       "src/repro/kernels/matmul.py:102", floor)
    mmb = KernelReport("matmul_bwd", "cuda",
                       "src/repro_torch/kernels/csrc/matmul.cu",
                       "src/repro/kernels/matmul.py:102", floor)
    # per step: the training depth's share of each projection's launches
    # in the 81-layer model (68 Mamba2 blocks, 13 shared-block
    # applications), the forward twice under remat but the head's
    full = {label: w for label, _, _, w in ZAMBA_GEMMS}
    share = {"mamba": per_step["ssd_scan_bwd"] / full["mamba z|x"],
             "shared": per_step["flash_attention_bwd"] / full["fused_qkv"]}
    weights = {}
    for label, _, _, w in ZAMBA_GEMMS:
        calls = 1 if label == "lm_head" else round(
            w * share["mamba" if label.startswith("mamba") else "shared"])
        weights[label] = (calls if label == "lm_head" else 2 * calls, calls)
    log(f"train-zamba-kernels: matmul forward (tolerance |err| <= atol + "
        f"rtol*|plain|) and backward (limit {BWD_REL} relative L2) at the "
        f"zamba step's shapes, M = {T} tokens; launches a step {weights}")
    matmul_steps(timer, ops, ref, torch,
                 [(label, K, N) for label, K, N, _ in ZAMBA_GEMMS], T,
                 weights, None if prior is None else prior[2:], mmf, mmb,
                 failed, TRAIN_ZAMBA)
    fwd = (mmf, *zamba_train_forward_checks(torch, ops, ref, randn, gen,
                                            failed))

    log("train-zamba-kernels: the zamba step's other backward shapes "
        "(correctness)")
    x, dy = randn(T, 3584, scale=3.0), randn(T, 3584)
    g = torch.rand(3584, generator=gen, device="cuda") + 0.5
    e = [rel_l2(got, want) for got, want in zip(
        ops.rmsnorm_backward(x, g, dy, eps=1e-6),
        ref.rmsnorm_bwd_ref(x, g, dy, 1e-6))]
    log(f"  rmsnorm_bwd rows={T} h=3584: rel L2 dx {e[0]:.2e} (limit "
        f"{BWD_REL}) dgamma {e[1]:.2e} (limit {DGAMMA_REL})")
    if e[0] > BWD_REL or e[1] > DGAMMA_REL:
        failed.append("rmsnorm_bwd h=3584")
    del x, dy
    q, k, v, do = (randn(1, T, 32, 112) for _ in range(4))
    qo = torch.zeros(1, dtype=torch.int32, device="cuda")
    kl = torch.full((1,), T, dtype=torch.int32, device="cuda")
    out, lse = ops.flash_attention_lse(q, k, v, qo, kl)
    out_ref, lse_ref = ref.attention_lse_ref(q, k, v, qo, kl)
    ok, err = within(out, out_ref, **FA_TOL)
    lse_err = float((lse - lse_ref).abs().max())
    ok = ok and bool(lse.isfinite().all()) and lse_err <= LSE_ATOL
    fwd[1].add(f"zamba2-7b b=1 s={T} 32/32 heads d=112 causal, lse err "
               f"{lse_err:.2e}", ok, max(err, lse_err),
               {**FA_TOL, "lse_atol": LSE_ATOL})
    if not ok:
        failed.append("flash_attention forward d=112")
    e = [rel_l2(g, w) for g, w in zip(
        ops.flash_attention_backward(q, k, v, out, do, lse, qo, kl),
        ref.attention_bwd_ref(q, k, v, out_ref, do, lse_ref, qo, kl))]
    ms = timer(lambda: ops.flash_attention_backward(q, k, v, out, do, lse,
                                                    qo, kl))
    log(f"  flash_attention_bwd zamba2-7b b=1 s={T} 32/32 heads d=112: rel "
        f"L2 dq {e[0]:.2e} dk {e[1]:.2e} dv {e[2]:.2e} (limit {BWD_REL}); "
        f"{ms:.4f} ms a launch")
    if max(e) > BWD_REL:
        failed.append("flash_attention_bwd d=112")
    if failed:
        raise AssertionError(f"zamba training-shape kernels disagree with "
                             f"their plain versions: {failed}")
    return (ssd, grp), fwd, mmb


def zamba_train_forward_checks(torch, ops, ref, randn, gen, failed):
    """The forward kernels but the matmul (``matmul_steps``) at the shapes
    zamba2-7b's training step gives them (b = 1, s = 2048) against their
    plain versions, within the serving checks' limits: the block norm over
    rows of 3584, the grouped, gated norm over 2048 x 112 rows of 64, the
    SSD scan from a zero state over 32 chunks (y and the final state).
    Appends what disagrees to ``failed``; returns the KernelReports of
    flash_attention (the caller adds the attention), rmsnorm and
    ssd_scan."""
    T, nh, hd, ds, chunk = TRAIN_SHAPE["seq"], 112, 64, 64, 64
    fa = KernelReport("flash_attention_train", "cuda",
                      "src/repro_torch/kernels/csrc/flash_attention_train.cu",
                      "src/repro/kernels/flash_attention.py:102")
    rn = KernelReport("rmsnorm", "cuda",
                      "src/repro_torch/kernels/csrc/rmsnorm.cu",
                      "src/repro/kernels/rmsnorm.py:30")
    ssd = KernelReport("ssd_scan", "cuda",
                       "src/repro_torch/kernels/csrc/ssd_scan.cu",
                       "src/repro/kernels/ssd_scan.py:74")
    log(f"train-zamba-kernels: the zamba step's other forward kernels at "
        f"{T} tokens (correctness; tolerance |err| <= atol + rtol*|plain|)")
    x = randn(T, 3584)
    g = torch.randn(3584, generator=gen, device=gen.device)
    ok, err = within(ops.rmsnorm(x, g, eps=1e-6), ref.rmsnorm_ref(x, g, 1e-6),
                     **RN_TOL)
    if not rn.add(f"block norm rows={T} h=3584 "
                  f"[{ops.rmsnorm_plan(T, 3584).name}]", ok, err, RN_TOL):
        failed.append(f"rmsnorm rows={T} h=3584")
    y = randn(1, T, nh, hd)
    g = torch.randn(nh, hd, generator=gen, device=gen.device)
    z = randn(1, T, 2 * nh * hd)[..., :nh * hd].unflatten(-1, (nh, hd))
    ok, err = within(ops.group_rmsnorm(y, g, gate=z),
                     ref.group_rmsnorm_ref(y, g, 1e-6, z), **RN_TOL)
    if not rn.add(f"grouped+gate b=1 s={T} ({T * nh} rows of {hd}) "
                  f"[{ops.rmsnorm_plan(T * nh, hd).name}]", ok, err, RN_TOL):
        failed.append(f"rmsnorm grouped s={T}")
    del x, y, z
    x = randn(1, T, nh, hd)
    dt = torch.nn.functional.softplus(
        torch.randn(1, T, nh, generator=gen, device=gen.device))
    A_log = torch.randn(nh, generator=gen, device=gen.device) * 0.5
    D = torch.randn(nh, generator=gen, device=gen.device)
    bc = randn(1, T, 2 * ds)     # B and C are halves of one tensor
    args = (x, dt, A_log, bc[..., :ds], bc[..., ds:], D)
    y, st = ops.ssd_scan(*args, chunk=chunk)
    y_ref, st_ref = ref.ssd_ref(*args, chunk)
    label = f"b=1 s={T} from zeros [{ops.ssd_plan(1, T, nh).name}]"
    for what, got, want, tol in (("y", y, y_ref, SSD_TOL),
                                 ("state_out", st, st_ref, SSD_STATE_TOL)):
        ok, err = within(got, want, **tol)
        if not ssd.add(f"{label}: {what}", ok, err, tol):
            failed.append(f"ssd_scan s={T} {what}")
    return fa, rn, ssd


#: the paper's GPT training path (``gpt_paper_model``, Table 2): gpt-m2 at
#: its own 4 layers, the slice's model; gpt-m1 and gpt-m3 train after it
#: without a profile (gpt-m4's 8.5 B parameters need 102 GB at 12 bytes
#: each: more than one card)
GPT_ARCH, GPT_LAYERS = "gpt-m2", 4
GPT_OTHERS = ("gpt-m1", "gpt-m3")
GPT_GEMMS = (  # (name, K, N) of gpt-m2's five training GEMMs, 4 layers
    ("fused_qkv", 4096, 12288), ("wo", 4096, 4096), ("up (gelu)", 4096, 16384),
    ("down", 16384, 4096), ("lm_head", 4096, 51200),
)
#: the GPT training path check: 2 layers, and M = 512 >= ``ops.TRAIN_M``
#: so that the up projection's pre-activation comes from variant 2
GPT_PATH = dict(layers=2, seq=512)


def bf16_ulp(torch, x):
    """The spacing of bf16 values at ``x`` (8 significant bits)."""
    xf = x.float()
    return torch.ldexp(torch.ones_like(xf),
                       torch.frexp(xf)[1] - 8).clamp_min(2.0 ** -133)


def gpt_train_kernel_phase(torch, F, ops, ref, timer, floor,
                           dev="cuda"):
    """gpt-m2's training shapes (b = 1, s = 2048, d_model 4096, 32 heads of
    128, MHA): each of its five GEMMs forward and backward against the
    plain versions and ``torch.matmul`` (``matmul_steps``); the up
    projection also with its pre-activation output (``_matmul(...,
    z_out=True)``, checked bit for bit against the launches without z and
    without the activation, timed against the launch without z); the
    activation's derivative (``csrc/act_bwd.cu``) within one bf16 ulp of
    ``ref.epilogue_bwd`` for gelu and silu, timed against its bound, the
    plain version and ``aten.gelu_backward``; the attention forward with
    its log-sum-exp and its backward at MHA (a GQA group of 1).  Returns
    (forward KernelReports, backward ones, the derivative's), with totals
    per training step of ``GPT_LAYERS`` layers."""
    gen = torch.Generator(device=dev).manual_seed(13)
    T, L = TRAIN_SHAPE["batch"] * TRAIN_SHAPE["seq"], GPT_LAYERS
    if floor is None:
        floor = timer(lambda: torch.cuda._sleep(0))
        log(f"train-gpt-kernels: timer floor {floor:.4f} ms (an empty "
            f"kernel)")
    cfg = _train_config(GPT_ARCH, L)
    fwd_per_step, bwd_per_step = train_launches_per_step(cfg, remat=True)
    again = fwd_per_step["flash_attention"] // L

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    failed = []
    mmf = KernelReport("matmul", "cuda",
                       "src/repro_torch/kernels/csrc/matmul.cu",
                       "src/repro/kernels/matmul.py:102", floor)
    mmb = KernelReport("matmul_bwd", "cuda",
                       "src/repro_torch/kernels/csrc/matmul.cu",
                       "src/repro/kernels/matmul.py:102", floor)
    # every up projection runs with its pre-activation: its forward
    # launches count in the row below, not in this one
    weights = {label: ((L * again, L) if label != "lm_head" else (1, 1))
               for label, _, _ in GPT_GEMMS}
    weights["up (gelu)"] = (0, L)
    log(f"train-gpt-kernels: {cfg.name} ({GPT_ARCH}) matmul forward "
        f"(tolerance |err| <= atol + rtol*|plain|) and backward (limit "
        f"{BWD_REL} relative L2) at M = {T} tokens; launches a step "
        f"{weights}")
    matmul_steps(timer, ops, ref, torch, GPT_GEMMS, T, weights, None, mmf,
                 mmb, failed, TRAIN_GPT, dev)

    # the up projection under autograd: one launch writes y and z
    mmz = KernelReport("matmul (with pre-activation)", "cuda",
                       "src/repro_torch/kernels/csrc/matmul.cu",
                       "src/repro/kernels/matmul.py:102", floor)
    K, N = cfg.d_model, cfg.d_ff
    a, b = randn(T, K), randn(K, N, scale=K ** -0.5)
    y, z = ops._matmul(a, b, None, "gelu", z_out=True)
    same_z = torch.equal(z, ops._matmul(a, b, None, None))
    same_y = torch.equal(y, ops._matmul(a, b, None, "gelu"))
    want_y, want_z = ref.matmul_aux_ref(a, b, None, "gelu")
    ok_y, err_y = within(y, want_y, **MM_TOL)
    ok_z, err_z = within(z, want_z, **MM_TOL)
    plan = ops.matmul_plan(T, N, K)
    without_z = timer(lambda: ops._matmul(a, b, None, "gelu"))
    if not mmz.add(f"up (gelu) M={T} K={K} N={N} y and z [{plan.name} "
                   f"blocks={plan.blocks} whole={plan.whole}]: z bitwise "
                   f"the no-activation output {same_z}, y bitwise the "
                   f"output without z {same_y}; without z "
                   f"{without_z:.4f} ms", ok_y and ok_z and same_z and same_y,
                   max(err_y, err_z), MM_TOL, TRAIN_GPT, "train", L * again,
                   ms=timer(lambda: ops._matmul(a, b, None, "gelu",
                                                z_out=True)),
                   plain_ms=timer(lambda: ref.matmul_aux_ref(a, b, None,
                                                             "gelu")),
                   library_ms=timer(lambda: torch.matmul(a, b)),
                   nbytes=2 * (T * K + K * N + 2 * T * N),
                   flops=2 * T * K * N):
        failed.append("matmul with pre-activation")
    del a, b, y, want_y, want_z

    act = KernelReport("matmul_act_bwd", "cuda",
                       "src/repro_torch/kernels/csrc/act_bwd.cu",
                       "src/repro/kernels/matmul.py:102", floor)
    log(f"train-gpt-kernels: the activation's derivative dz = dy * "
        f"act'(z) (limit one bf16 ulp of the plain version) at the up "
        f"projection's {T} x {N}; {bwd_per_step['matmul_act_bwd']} launches "
        f"a step")
    dy = randn(T, N)
    for name in ("gelu", "silu"):
        got = ops.activation_backward(dy, z, name)
        want = ref.epilogue_bwd(z, dy, name)
        err = (got.float() - want.float()).abs()
        ulps = float((err / bf16_ulp(torch, want)).max())
        timing = {}
        if name == "gelu":
            timing = dict(
                ms=timer(lambda: ops.activation_backward(dy, z, "gelu")),
                plain_ms=timer(lambda: ref.epilogue_bwd(z, dy, "gelu")),
                library_ms=timer(lambda: torch.ops.aten.gelu_backward(
                    dy, z, approximate="tanh")),
                nbytes=6 * T * N, flops=30 * T * N, peak=FP32_TFLOPS)
        if not act.add(f"{name} {T}x{N}: {ulps:.2f} bf16 ulp at most",
                       ulps <= 1.0, float(err.max()), "1 bf16 ulp",
                       TRAIN_GPT if timing else None,
                       "train" if timing else None,
                       bwd_per_step["matmul_act_bwd"] if timing else 0,
                       **timing):
            failed.append(f"matmul_act_bwd {name}")
        del got, want, err
    del z, dy

    faf = KernelReport("flash_attention_train", "cuda",
                       "src/repro_torch/kernels/csrc/flash_attention_train.cu",
                       "src/repro/kernels/flash_attention.py:102", floor)
    fab = KernelReport("flash_attention_bwd", "cuda",
                       "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                       "src/repro/kernels/flash_attention.py:102", floor)
    hq, d = cfg.num_heads, cfg.hd
    q, k, v, do = (randn(1, T, hq, d) for _ in range(4))
    qo = torch.zeros(1, dtype=torch.int32, device=dev)
    kl = torch.full((1,), T, dtype=torch.int32, device=dev)
    out, lse = ops.flash_attention_lse(q, k, v, qo, kl)
    out_ref, lse_ref = ref.attention_lse_ref(q, k, v, qo, kl)
    ok, err = within(out, out_ref, **FA_TOL)
    lse_err = float((lse - lse_ref).abs().max())
    ok = ok and bool(lse.isfinite().all()) and lse_err <= LSE_ATOL
    visible = int(ref.attention_mask(T, T, qo, kl).sum()) * hq
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if not faf.add(
            f"{GPT_ARCH} b=1 s={T} {hq}/{hq} heads d={d} causal, lse err "
            f"{lse_err:.2e}", ok, max(err, lse_err),
            {**FA_TOL, "lse_atol": LSE_ATOL}, TRAIN_GPT, "train", L * again,
            ms=timer(lambda: ops.flash_attention_lse(q, k, v, qo, kl)),
            plain_ms=timer(lambda: ref.attention_lse_ref(q, k, v, qo, kl)),
            library_ms=timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)),
            nbytes=2 * 4 * q.numel() + 4 * lse.numel(),
            flops=4 * d * visible):
        failed.append("flash_attention forward MHA")
    plan = ops.attention_bwd_plan(1, T, hq, hq, T)
    lens = plan.lengths()
    log(f"  dK/dV plan at s={T}, {hq}/{hq} heads (group 1): {len(lens)} "
        f"items of at most {plan.max_len} (longest {max(lens)}, mean "
        f"{sum(lens) / len(lens):.2f}), {plan.slots} partial slots, "
        f"{plan.blocks} persistent blocks")
    got = ops.flash_attention_backward(q, k, v, out, do, lse, qo, kl)
    want = ref.attention_bwd_ref(q, k, v, out_ref, do, lse_ref, qo, kl)
    errs = [rel_l2(g, w) for g, w in zip(got, want)]
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    del got, want, out_ref, lse_ref
    leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    o_lib = F.scaled_dot_product_attention(*leaves, is_causal=True)
    do_lib = do.transpose(1, 2)
    if not fab.add(
            f"{GPT_ARCH} b=1 s={T} {hq}/{hq} heads d={d}: rel L2 dq "
            f"{errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e}",
            max(errs) <= BWD_REL, err, BWD_REL, TRAIN_GPT, "train", L,
            ms=timer(lambda: ops.flash_attention_backward(
                q, k, v, out, do, lse, qo, kl)),
            plain_ms=timer(lambda: ref.attention_bwd_ref(
                q, k, v, out, do, lse, qo, kl)),
            library_ms=timer(lambda: torch.autograd.grad(
                o_lib, leaves, do_lib, retain_graph=True)),
            nbytes=2 * 8 * q.numel() + 4 * lse.numel(),
            flops=5 * 2 * d * visible):
        failed.append("flash_attention_bwd MHA")
    del q, k, v, do, out, lse, qt, kt, vt, leaves, o_lib
    if failed:
        raise AssertionError(f"gpt training-shape kernels disagree with "
                             f"their plain versions: {failed}")
    return (mmf, mmz, faf), (mmb, fab), act


def _train_config(arch: str, layers: int):
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(arch), num_layers=layers)


def _train_model(torch, layers: int, seed: int, dev="cuda",
                 arch="llama3-8b"):
    """``arch`` at its published widths, depth cut to ``layers``: the
    config, this rank's (only) shard of seeded bf16 weights, and one
    seeded batch of ``TRAIN_SHAPE``'s rows."""
    import numpy as np

    from repro_torch.core.mesh import atp_topo
    from repro_torch.models import lm

    cfg = _train_config(arch, layers)
    params = lm.shard_params(cfg, lm.init_params(cfg, seed=seed, device=dev),
                             lm.layout_context(atp_topo(1, 1, 1), 0))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (TRAIN_SHAPE["batch"],
                                            TRAIN_SHAPE["seq"] + 1))
    batch = {"tokens": torch.tensor(toks[:, :-1], dtype=torch.int32,
                                    device=dev),
             "labels": torch.tensor(toks[:, 1:], dtype=torch.int32,
                                    device=dev)}
    return cfg, params, batch


def train_phase(torch, seed: int = 0, arch: str = "llama3-8b",
                layers: int = TRAIN_SHAPE["layers"], tag: str = "",
                profile: bool = True) -> dict:
    """``build_train_step`` on ``arch`` at ``layers`` (``TRAIN_SHAPE``'s
    batch and sequence), AdamW zero1 at dp = 1 (full-state, fp32 m/v),
    remat on: one warm-up step, then the counted steps on the same batch,
    then, with ``profile``, one profiled step and one
    more profiled with the host's ops and shapes
    (``profile_train{tag}.txt``, ``profile_train{tag}_ops.txt``).  Returns
    the launch counts of the counted steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profile_

    from repro_torch.core.mesh import atp_topo
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    L, steps = layers, TRAIN_SHAPE["steps"]
    cfg, params, batch = _train_model(torch, L, seed, arch=arch)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=1)
    step, info = build_train_step(cfg, atp_topo(1, 1, 1), opt_cfg)
    state = adamw.init_opt_state(params, info.ctx, opt_cfg.mode)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in adamw.tree_leaves(params))
    log(f"train {cfg.name}: {L} layers at full width ({n_params / 1e9:.3f} B "
        f"parameters, bf16; fp32 AdamW m/v, {opt_cfg.mode}), batch "
        f"{TRAIN_SHAPE['batch']} x seq {TRAIN_SHAPE['seq']}, remat; set-up "
        f"{time.perf_counter() - t0:.1f}s, device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    tokens = TRAIN_SHAPE["batch"] * TRAIN_SHAPE["seq"]
    t0 = time.perf_counter()
    params, state, m = step(params, state, batch)   # warm-up: builds, plans
    losses = [float(m["loss"])]
    log(f"  step 1 (warm-up): loss {losses[0]:.4f} grad norm "
        f"{float(m['grad_norm']):.4f} lr {m['lr']:.3g}, "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms")
    ops.reset_launches()
    walls = []
    for i in range(2, steps + 1):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))                # synchronises
        walls.append(time.perf_counter() - t0)
        log(f"  step {i}: loss {losses[-1]:.4f} grad norm "
            f"{float(m['grad_norm']):.4f} lr {m['lr']:.3g}, "
            f"{1e3 * walls[-1]:.1f} ms")
    launches = {**ops.LAUNCHES, **ops.BACKWARD_LAUNCHES}
    variants = list(ops.ATTENTION_VARIANT_LAUNCHES)
    med = statistics.median(walls)
    log(f"  {len(walls)} steps: {1e3 * med:.1f} ms per step (median), "
        f"{tokens / med:.0f} tokens/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    fwd, bwd = train_launches_per_step(cfg, remat=True)
    want = {k: v * len(walls) for k, v in {**fwd, **bwd}.items()}
    log(f"  launches over {len(walls)} steps: {launches} (= per step "
        f"{fwd} {bwd} x {len(walls)})")
    assert all(math.isfinite(x) for x in losses), f"losses {losses}"
    assert losses[-1] < losses[0], f"the loss did not fall: {losses}"
    assert launches == want, f"launches {launches}, expected {want}"
    # every attention of the step at s = 2048 runs the training kernel
    log(f"  flash_attention launches by kernel: {variants} (flash_attention"
        f".cu, flash_attention_train.cu)")
    assert variants == [0, launches["flash_attention"]], variants
    launches["flash_attention_train"] = variants[1]
    if not profile:
        del params, state, step
        gc.collect()
        torch.cuda.empty_cache()
        return launches
    with profile_(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        float(m["loss"])
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    (OUT_DIR / f"profile_train{tag}.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=30))
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"  profiled step: device busy {device_ms:.1f} ms of {wall_ms:.1f} "
        f"ms wall ({device_ms / wall_ms:.0%}), "
        f"{sum(e.count for e in kernels)} device launches; by kernel:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
            f"{e.key[:70]}")
    # one more step under the host-side profiler, with shapes: which torch
    # op launched the copies and casts (a transposing copy is an
    # aten::clone, a cast an aten::_to_copy; both run aten::copy_)
    with profile_(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  record_shapes=True) as prof:
        params, state, m = step(params, state, batch)
        float(m["loss"])
    by_op = prof.key_averages(group_by_input_shape=True)
    (OUT_DIR / f"profile_train{tag}_ops.txt").write_text(
        by_op.table(sort_by="device_time_total", row_limit=80))
    copies = sorted((e for e in by_op if e.key in (
        "aten::copy_", "aten::clone", "aten::_to_copy")),
        key=lambda e: -e.device_time_total)
    total = sum(e.device_time_total for e in copies if e.key == "aten::copy_")
    log(f"  copies and casts of one step (device ms by op and input shape; "
        f"aten::copy_ {total / 1e3:.2f} ms in all):")
    for e in copies[:16]:
        log(f"    {e.device_time_total / 1e3:9.3f} ms  {e.count:4d}x  "
            f"{e.key} {e.input_shapes}")
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def plain_backward(ref) -> dict:
    """The six backward wrappers of ``kernels.ops`` as their plain
    versions, with the wrappers' arguments: what each wrapper runs on the
    CPU, here run on any device."""
    def matmul_backward(a, b, dz, *, need_a=True, need_b=True):
        da, db = ref.matmul_bwd_ref(a, b, dz)
        return (da if need_a else None), (db if need_b else None)

    def flash_attention_backward(q, k, v, o, do, lse, q_offset, kv_len, *,
                                 causal=True, window=0, softcap=0.0):
        return ref.attention_bwd_ref(q, k, v, o, do, lse, q_offset, kv_len,
                                     causal=causal, window=window,
                                     softcap=softcap)

    def rmsnorm_backward(x, gamma, dy, *, eps=1e-6):
        return ref.rmsnorm_bwd_ref(x, gamma, dy, eps)

    def group_rmsnorm_backward(y, gamma, dout, eps=1e-6, *, gate=None):
        return ref.group_rmsnorm_bwd_ref(y, gamma, dout, eps, gate)

    def ssd_scan_backward(x, dt, A_log, B, C, D, dy, *, chunk):
        return ref.ssd_bwd_ref(x, dt, A_log, B, C, D, dy, chunk)

    def activation_backward(dy, z, activation):
        return ref.epilogue_bwd(z, dy, activation)

    return dict(matmul_backward=matmul_backward,
                flash_attention_backward=flash_attention_backward,
                rmsnorm_backward=rmsnorm_backward,
                group_rmsnorm_backward=group_rmsnorm_backward,
                ssd_scan_backward=ssd_scan_backward,
                activation_backward=activation_backward)


@contextlib.contextmanager
def swapped(ops, **impls):
    """``ops``' functions named in ``impls`` replaced by them inside the
    block: ``ops``' autograd Functions look their backward wrappers up by
    name when they run, and the wrappers their launch plans.  A caller that
    swaps a backward reads ``ops.BACKWARD_LAUNCHES`` afterwards, so a swap
    that did not take effect fails its check."""
    saved = {name: getattr(ops, name) for name in impls}
    for name, fn in impls.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def zero_db(torch, ssd_scan_backward):
    """``ssd_scan_backward`` with a planted fault: dB set to zero."""
    def faulty(*args, **kw):
        dx, ddt, dA_log, dB, dC, dD = ssd_scan_backward(*args, **kw)
        return dx, ddt, dA_log, torch.zeros_like(dB), dC, dD
    return faulty


def no_derivative(dy, z, activation):
    """``activation_backward`` with a planted fault: ``dy`` passed on as if
    the activation were the identity."""
    return dy


def train_path_check(torch, seed: int = 0, arch: str = "llama3-8b",
                     layers: int = 2, seq: int = PATH_SEQ,
                     dev: str = "cuda") -> None:
    """The loss and every parameter's gradient of ``arch`` at full width,
    depth cut to ``layers`` (b = 1, s = ``seq``), on the card (kernels,
    bf16) against the CPU (plain versions, fp32) from the same bf16
    weights, each gradient within ``PATH_TOL``.

    A recurrent model's bf16 gradients are far from fp32 whatever computes
    them (the Mamba2 grouped norm divides rows whose bf16 value is wrong
    by O(1) by their small RMS; the reference's own bf16 run shows it,
    ``tests/test_torch_train.py``), so there a gradient beyond
    ``PATH_TOL`` must be within ``RECURRENT_FACTOR`` times the plain
    versions' error in bf16 on the CPU, and the backward kernels are held
    on one forward: the card's gradients against the plain backward
    versions run on the card from the same forward through the kernels
    (the same loss, bit for bit), each within ``PATH_TOL``.  A planted
    fault (``ssd_scan_bwd``'s dB set to zero) must fail that rule.  A
    model with a gelu MLP holds the activation's derivative kernel on one
    forward the same way (``activation_backward`` swapped for its plain
    version), and ``activation_backward`` passing ``dy`` on unchanged is
    the fault that rule must catch."""
    from repro_torch.core.atp import make_context
    from repro_torch.core.mesh import atp_topo
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    cfg, params, batch = _train_model(torch, layers, seed, dev=dev, arch=arch)
    batch = {k: v[:, :seq] for k, v in batch.items()}

    def grads(params, batch, where):
        ctx = make_context(atp_topo(1, 1, 1), device_type=where)
        leaves = adamw.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss = lm.train_loss(ctx, cfg, params, batch, remat=False)
        return float(loss.detach()), [g.float().cpu() for g in
                                      torch.autograd.grad(loss, leaves)]

    def rel(a, b):
        return {n: rel_l2(g, w) for n, g, w in zip(names, a[1], b[1])}

    names = _leaf_names(params)
    on_card = dev != "cpu"
    ops.reset_launches()
    card = grads(params, batch, dev)
    launched = dict(ops.BACKWARD_LAUNCHES)
    # the attention at s >= 128 and head dim 112 or 128 runs the training
    # kernel (attention_plan's variant 1)
    variants = list(ops.ATTENTION_VARIANT_LAUNCHES)
    assert not on_card or (variants[0] == 0 and variants[1] > 0), variants
    host = {k: v.cpu() for k, v in batch.items()}
    cpu = grads(lm.tree_map(lambda t: t.detach().cpu().float(), params),
                host, "cpu")
    errs = rel(card, cpu)
    plain = same = fault = {}
    if lm.is_recurrent(cfg):
        plain = rel(grads(lm.tree_map(lambda t: t.detach().cpu(), params),
                          host, "cpu"), cpu)
        # every backward wrapper plain; the fault in the SSD backward
        held_by, planted = plain_backward(ref), dict(
            ssd_scan_backward=zero_db(torch, ops.ssd_scan_backward))
        what, kept = "ssd_scan_bwd's dB planted to zero", "ssd_scan_bwd"
    elif cfg.mlp_kind == "gelu":
        # the activation's derivative plain; the fault in it
        held_by = {"activation_backward":
                   plain_backward(ref)["activation_backward"]}
        planted = dict(activation_backward=no_derivative)
        what, kept = ("activation_backward passing dy on unchanged",
                      "matmul_bwd")
    if lm.is_recurrent(cfg) or cfg.mlp_kind == "gelu":
        ops.reset_launches()
        with swapped(ops, **held_by):
            held = grads(params, batch, dev)
        swapped_keys = [k for k, v in ops.BACKWARD_LAUNCHES.items() if v and (
            lm.is_recurrent(cfg) or k == "matmul_act_bwd")]
        assert not swapped_keys, \
            f"the plain backward launched {ops.BACKWARD_LAUNCHES}"
        assert held[0] == card[0], \
            f"two forwards through the kernels differ: {held[0]} {card[0]}"
        same = rel(card, held)
        ops.reset_launches()
        with swapped(ops, **planted):
            fault = rel(grads(params, batch, dev), held)
        assert ops.BACKWARD_LAUNCHES[kept] or not on_card
        if on_card:
            # every backward kernel of the model's launch model ran
            want = train_launches_per_step(cfg, remat=False)[1]
            missed = [k for k, v in want.items() if v and not launched[k]]
            assert not missed, \
                f"a backward kernel did not run on the path: {launched}"
    worst = max(errs, key=errs.get)
    log(f"path-check-train {cfg.name} at {layers} layers, d_model "
        f"{cfg.d_model}, s={seq}: attention launches by kernel {variants} "
        f"(flash_attention.cu, flash_attention_train.cu); loss card "
        f"{card[0]:.5f} CPU {cpu[0]:.5f}; "
        f"gradient relative L2 error per tensor, worst {errs[worst]:.3e} "
        f"({worst}), limit {PATH_TOL}"
        + (f" or {RECURRENT_FACTOR}x the plain bf16 path's error against "
           f"fp32 (beside it)" if plain else "")
        + (f"; then the card against {', '.join(held_by)} plain on the card "
           f"from the same forward (limit {PATH_TOL}), and the same with "
           f"{what} (must exceed {PATH_TOL})" if same else "") + ":")
    for n, e in errs.items():
        log(f"    {e:.3e}  {n}" + (f"  (plain bf16 {plain[n]:.3e})"
                                   if plain else "") + (
            f"  (same forward {same[n]:.3e}, planted fault {fault[n]:.3e})"
            if same else ""))
    assert abs(card[0] - cpu[0]) <= PATH_TOL * abs(cpu[0]), "loss differs"
    bad = [n for n, e in errs.items() if e > PATH_TOL and not (
        plain and e <= RECURRENT_FACTOR * plain[n])]
    bad += [f"{n} (same forward)" for n, e in same.items() if e > PATH_TOL]
    assert not bad, f"path-check-train: {bad} beyond the limit"
    if fault:
        caught = [n for n, e in fault.items() if e > PATH_TOL]
        log(f"  the planted fault fails the same-forward rule at "
            f"{len(caught)} of {len(fault)} tensors (worst "
            f"{max(fault.values()):.3e})")
        assert caught, "the same-forward rule passed a planted fault"


# ---------------------------------------------------------------------------
# The strategy stack on the card (phase 16).
# ---------------------------------------------------------------------------

#: the paper's GPT models and its table defaults, ranked on the card's own
#: fabric: the one-node and the two-node H100 presets at their TP degrees
PLAN_ARCHS = ("gpt-m1", "gpt-m2", "gpt-m3", "gpt-m4")
PLAN_RANKED = (("h100-sxm-8", 8), ("h100-sxm-2x8", 16))
PLAN_BATCH, PLAN_SEQ = 4, 2048
#: the training runs from a plan: gpt-m2 at its own 4 layers, b = 1,
#: s = 2048 (``TRAIN_SHAPE``), this many steps each
PLAN_STEPS = 3
#: the serving run from a plan with a decode sub-plan
PLAN_SERVE_ARCH, PLAN_SERVE_REQUESTS = "qwen1.5-0.5b", 4


def plan_train_run(torch, plan=None, record: bool = False):
    """``PLAN_STEPS`` AdamW zero1 steps of gpt-m2 at ``GPT_LAYERS`` from
    seeded weights, built from ``plan`` or, with none, from the loose
    topology (1, 1, 1) as the train-gpt phase builds it.  With ``record``
    every step runs inside ``analysis.signature.recording``.  Returns
    (the step's context, the losses, the record or None)."""
    from repro_torch.analysis import signature
    from repro_torch.core.mesh import atp_topo
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw

    cfg, params, batch = _train_model(torch, GPT_LAYERS, 0, arch=GPT_ARCH)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=1)
    if plan is None:
        step, info = build_train_step(cfg, atp_topo(1, 1, 1), opt_cfg)
    else:
        step, info = build_train_step(cfg, opt_cfg=opt_cfg, plan=plan)
    state = adamw.init_opt_state(params, info.ctx, opt_cfg.mode)
    rec = signature.Record() if record else None
    losses = []
    for _ in range(PLAN_STEPS):
        with (signature.recording("fwd", rec) if record
              else contextlib.nullcontext()):
            params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return info.ctx, losses, rec


def plan_serve_run(torch, plan=None):
    """``PLAN_SERVE_REQUESTS`` seeded prompts of qwen1.5-0.5b through
    ``make_paged_server`` (captured), built from ``plan`` or from the
    trivial topology; returns (the step's context, each request's greedy
    tokens by rid)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.runtime.server import Request

    cfg = get_config(PLAN_SERVE_ARCH)
    prompts = serve.sample_prompts(cfg, PLAN_SERVE_REQUESTS, PROMPT_LEN, 1)
    scfg = serve.paged_server_config([len(p) for p in prompts], **SERVE)
    server, info = serve.make_paged_server(
        cfg, scfg, lm.init_params(cfg, seed=1), plan=plan)
    for rid, p in enumerate(prompts):
        server.submit(Request(rid=rid, prompt=p, max_new=SERVE["max_new"]))
    server.run_until_drained()
    out = {r.rid: list(r.out) for r in server.completed}
    ctx = info.ctx
    del server, info
    gc.collect()
    torch.cuda.empty_cache()
    return ctx, out


def plan_phase(torch) -> None:
    """The strategy stack (``core.plan``) driving the port on one card:
    the paper's 21 plans against ``BENCH_paper_plans.json``; the ranking
    of gpt-m1..m4 on the H100 presets (model output); gpt-m2 trained from
    a searched plan, from that plan saved and loaded (each step under the
    collective record) and from the loose topology, with equal contexts
    and the same loss bits; qwen1.5-0.5b served from a plan with a decode
    sub-plan, every request's tokens equal to the server built from the
    topology's."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.plan import ParallelPlan, plan_search
    from repro_torch.launch import plan_smoke
    from repro_torch.launch.train import H100_PEAK_TFLOPS, pick_plan

    t0 = time.perf_counter()
    got, want = plan_smoke.paper_plans(), plan_smoke.stored_paper_plans()
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    differ = [k for k in want if got[k] != want[k]]
    assert not differ, f"paper plans differ: {differ}"
    log(f"plan: the {len(got)} paper plans equal BENCH_paper_plans.json key "
        f"for key, predicted costs included "
        f"({time.perf_counter() - t0:.2f}s)")

    log(f"plan: pick_plan's top four plans per model on the H100 presets, "
        f"batch {PLAN_BATCH} x seq {PLAN_SEQ}, GEMM time at "
        f"{H100_PEAK_TFLOPS} TFLOP/s -- cost-model output, not measurements "
        f"(ms per step):")
    for topology, tp in PLAN_RANKED:
        for arch in PLAN_ARCHS:
            res = pick_plan(get_config(arch), tp, PLAN_SEQ, PLAN_BATCH,
                            topology)
            for rank, (p, c) in enumerate(zip(res.ranked[:4], res.costs[:4])):
                log(f"  {topology} tp {tp} {arch} #{rank + 1}: "
                    f"{p.describe()}: t_comm {1e3 * c.t_comm:.4f} "
                    f"t_exposed {1e3 * c.t_exposed:.4f} "
                    f"t_gemm {1e3 * c.t_gemm:.4f}")

    t0 = time.perf_counter()
    cfg = _train_config(GPT_ARCH, GPT_LAYERS)
    plan = pick_plan(cfg, 1, TRAIN_SHAPE["seq"], TRAIN_SHAPE["batch"],
                     "h100-sxm-8").best
    loaded = ParallelPlan.load(plan.save(str(OUT_DIR / "plan_gpt-m2.json")))
    assert loaded == plan, "the plan changed through its JSON"
    log(f"plan: {GPT_ARCH} ({GPT_LAYERS} layers, b {TRAIN_SHAPE['batch']}, s "
        f"{TRAIN_SHAPE['seq']}) searched on h100-sxm-8 at tp 1: "
        f"{plan.describe()}")
    ctx_s, loss_s, _ = plan_train_run(torch, plan)
    ctx_l, loss_l, rec = plan_train_run(torch, loaded, record=True)
    ctx_t, loss_t, _ = plan_train_run(torch)
    log(f"  losses from the searched plan {loss_s}, the loaded plan "
        f"{loss_l} (recorded), the loose topology {loss_t} "
        f"({time.perf_counter() - t0:.1f}s)")
    assert ctx_s == ctx_l, (ctx_s, ctx_l)
    # the loose topology carries no segment entries: its view of each
    # segment, and its scalar knobs, are the plan's
    assert dataclasses.replace(ctx_s, segment_plans=()) == ctx_t, (ctx_s,
                                                                   ctx_t)
    for seg in plan.segments:
        assert ctx_s.for_segment(seg.kind) == ctx_t.for_segment(seg.kind), seg
    assert all(math.isfinite(x) for x in loss_s), loss_s
    assert loss_s == loss_l == loss_t, "the losses differ in their bits"
    outside = [e for e in rec.entries if not e.region.startswith("opt:")]
    assert not outside, f"collectives recorded at d1 = d2 = dp = 1: {outside}"
    log(f"  contexts equal, losses equal bit for bit; {len(rec.entries)} "
        f"collectives recorded in {PLAN_STEPS} steps at d1 = d2 = dp = 1")

    t0 = time.perf_counter()
    scfg = get_config(PLAN_SERVE_ARCH)
    splan = plan_search("h100-sxm-8", 1, model=scfg, batch=SERVE["slots"],
                        seq=PROMPT_LEN + SERVE["max_new"],
                        decode_batch=SERVE["slots"],
                        peak_tflops=H100_PEAK_TFLOPS).best
    assert splan.decode is not None, splan
    ctx_p, from_plan = plan_serve_run(torch, splan)
    ctx_t, from_topo = plan_serve_run(torch)
    log(f"plan: {PLAN_SERVE_ARCH} served from {splan.describe()}: "
        f"{len(from_plan)} requests, tokens equal to the topology's server "
        f"({time.perf_counter() - t0:.1f}s); request 0 -> {from_plan[0]}")
    assert dataclasses.replace(ctx_p, segment_plans=()) == ctx_t, (ctx_p,
                                                                   ctx_t)
    assert from_plan == from_topo, (from_plan, from_topo)


def _leaf_names(tree, prefix="") -> list:
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


# ---------------------------------------------------------------------------
# Entry point.
# ---------------------------------------------------------------------------


def kernel_name(line: str) -> str:
    """The kernel's name and template arguments in a ptxas report line
    ("... entry function '_ZN<n><namespace><n>dkdv_kernelILi2EEEv..'"),
    read by the names' length prefixes: ``dkdv_kernel<2>``."""
    mangled = line.split("'")[1] if "'" in line else line
    i = mangled.find("_ZN") + 3
    while 2 < i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
        if name.endswith("kernel"):
            args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[i:])
            if args is None:
                return name
            return f"{name}<{','.join(re.findall(r'L[ib](\d+)E', args[1]))}>"
    return mangled


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    ap.add_argument("--parent", default=None,
                    help="a checkout of an older tree: train-kernels builds "
                         "its matmul.cu, flash_attention_bwd.cu and "
                         "rmsnorm.cu into its own build directory and times "
                         "its matmul forward and backward and the other "
                         "backward kernels beside this tree's, "
                         "train-zamba-kernels does the same with its matmul "
                         "at the zamba shapes, its ssd_scan_bwd.cu and "
                         "grouped norm backward, and the train, "
                         "train-zamba and train-gpt phases run its training "
                         "step and this tree's in turns")
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
            kernel = ""
            for line in report.read_text().splitlines():
                if "Compiling entry function" in line:
                    kernel = kernel_name(line)
                if "registers" in line or "spill" in line or "C7520" in line:
                    log(f"  ptxas {name} {kernel}: {line.strip()}")

    from repro_torch.configs.registry import get_config

    t_run = time.perf_counter()

    def done(phase):
        log(f"[{phase} done at {time.perf_counter() - t_run:.1f}s]")

    reports = []
    floor_ms = None
    if "kernels" in phases:
        reports = list(kernel_phase(torch, F, ops, ref,
                                    chunk=SERVE["prefill_chunk"],
                                    slots=SERVE["slots"],
                                    skv=SERVE["max_seq"], timer=Timer(torch)))
        floor_ms = reports[0].floor_ms
        done("kernels")

    def kernel_ms(path):
        return {s: sum(r.step_ms(path, s) for r in reports)
                for s in ("prefill", "decode")} if reports else None

    launches = {}   # per path, from its serve phase
    llama = get_config("llama3-8b")
    if "serve-llama" in phases:
        launches["llama3-8b"] = serve_phase(
            torch, llama, requests=8, seed=0, kernel_ms=kernel_ms("llama3-8b"),
            profile=True, pairs=TIMED_PAIRS)
        done("serve-llama")
    if "path-check" in phases:
        # depth cut to 2 layers so that the fp32 CPU side stays small
        path_check(torch, dataclasses.replace(llama, num_layers=2), seed=0)
        done("path-check")
    if "serve-qwen" in phases:
        serve_phase(torch, get_config("qwen1.5-0.5b"), requests=4, seed=1)
        done("serve-qwen")
    zamba = get_config("zamba2-7b")
    kept = {}   # serve-zamba's weights, which serve-wave serves again
    if "serve-zamba" in phases:
        # the forward rows of the result line read their counts from this run
        launches[MAIN] = serve_phase(
            torch, zamba, requests=4, seed=2, kernel_ms=kernel_ms(MAIN),
            profile=True, pairs=ZAMBA_PAIRS,
            keep=kept if "serve-wave" in phases else None)
        done("serve-zamba")
    if "serve-wave" in phases:
        serve_wave_phase(torch, zamba_params=kept.pop("params", None),
                         pairs=TIMED_PAIRS)
        gc.collect()
        torch.cuda.empty_cache()
        done("serve-wave")
    if "path-check-zamba" in phases:
        # depth cut to 7 layers (one super-block of 6 and one tail Mamba2
        # block, so both segment kinds run) for the fp32 CPU side
        path_check(torch, dataclasses.replace(zamba, num_layers=7), seed=0)
        done("path-check-zamba")
    train_fwd = []   # the forward kernels at the training step's shapes
    if "train-kernels" in phases:
        train_fwd, train_bwd = train_kernel_phase(torch, F, ops, ref,
                                                  Timer(torch), floor_ms,
                                                  parent=args.parent)
        reports += [*train_bwd, train_fwd[1]]
        done("train-kernels")
    if SPLIT in phases:
        split_reports, launches[SPLIT] = split_norm_phase(
            torch, ops, ref, Timer(torch), floor_ms)
        reports += split_reports
        done(SPLIT)
    if INT8 in phases:
        int8_report, launches[INT8] = int8_matmul_phase(
            torch, ops, ref, Timer(torch), floor_ms)
        reports.append(int8_report)
        done(INT8)
    if "quant-wire" in phases:
        quant_wire_phase(torch)
        done("quant-wire")
    if "train" in phases:
        launches[TRAIN] = train_phase(torch)
        if args.parent is not None:
            parent_train_steps(args.parent)
        done("train")
    if "path-check-train" in phases:
        train_path_check(torch)
        done("path-check-train")
    train_zamba_fwd = []   # the forward kernels at the zamba step's shapes
    zamba_mm_bwd = []      # the matmul backward at the zamba step's shapes
    if "train-zamba-kernels" in phases:
        zamba_bwd, train_zamba_fwd, mmb = zamba_train_kernel_phase(
            torch, F, ops, ref, Timer(torch), floor_ms, parent=args.parent)
        zamba_mm_bwd = [mmb]
        reports += zamba_bwd
        done("train-zamba-kernels")
    if "train-zamba" in phases:
        launches[TRAIN_ZAMBA] = train_phase(
            torch, arch="zamba2-7b", layers=ZAMBA_TRAIN_LAYERS, tag="_zamba")
        if args.parent is not None:
            parent_train_steps(args.parent, "zamba2-7b", ZAMBA_TRAIN_LAYERS,
                               "train-zamba")
        done("train-zamba")
    if "path-check-train-zamba" in phases:
        train_path_check(torch, arch="zamba2-7b", **ZAMBA_PATH)
        done("path-check-train-zamba")
    gpt_fwd, gpt_bwd = [], []   # the other kernels at gpt-m2's shapes
    if "train-gpt-kernels" in phases:
        gpt_fwd, gpt_bwd, act = gpt_train_kernel_phase(
            torch, F, ops, ref, Timer(torch), floor_ms)
        reports.append(act)
        done("train-gpt-kernels")
    if "train-gpt" in phases:
        launches[TRAIN_GPT] = train_phase(torch, arch=GPT_ARCH,
                                          layers=GPT_LAYERS, tag="_gpt")
        if args.parent is not None:
            parent_train_steps(args.parent, GPT_ARCH, GPT_LAYERS, "train-gpt")
        # under remat's non-reentrant checkpoint grad mode is on in both of
        # a block's forward passes, so the up projection writes z in each
        # (the first pass's z is dropped unread); the derivative reads the
        # recomputed one
        launches[TRAIN_GPT]["matmul (with pre-activation)"] = \
            2 * launches[TRAIN_GPT]["matmul_act_bwd"]
        for arch in GPT_OTHERS:
            train_phase(torch, arch=arch, layers=GPT_LAYERS, profile=False)
        done("train-gpt")
    if "path-check-train-gpt" in phases:
        train_path_check(torch, arch=GPT_ARCH, **GPT_PATH)
        done("path-check-train-gpt")
    if "plan" in phases:
        plan_phase(torch)
        done("plan")
    if "calibrate" in phases:
        calibrate_phase(torch)
        done("calibrate")

    def path_rows(path, of):
        return [r.row(path, launches.get(path, {}).get(r.meta["name"], 0))
                for r in of if path in r.paths]

    rows = {path: path_rows(path, reports)
            for path in ("llama3-8b", MAIN, TRAIN, TRAIN_ZAMBA, TRAIN_GPT,
                         SPLIT, INT8)}
    rows["train forward"] = path_rows(TRAIN, train_fwd)
    rows["train-zamba forward"] = path_rows(TRAIN_ZAMBA, train_zamba_fwd)
    rows["train-zamba matmul backward"] = path_rows(TRAIN_ZAMBA, zamba_mm_bwd)
    rows["train-gpt forward"] = path_rows(TRAIN_GPT, gpt_fwd)
    rows["train-gpt backward"] = path_rows(TRAIN_GPT, gpt_bwd)
    (OUT_DIR / "kernel_checks.json").write_text(json.dumps(
        {"rows": rows, "checks": {r.meta["name"]: r.checks for r in reports},
         "train forward checks": {r.meta["name"]: r.checks
                                  for r in train_fwd},
         "train-zamba forward checks": {r.meta["name"]: r.checks
                                        for r in train_zamba_fwd},
         "train-zamba matmul backward checks": {
             r.meta["name"]: r.checks for r in zamba_mm_bwd},
         "train-gpt checks": {r.meta["name"]: r.checks
                              for r in [*gpt_fwd, *gpt_bwd]}},
        indent=1))
    for what, path in (("llama3-8b step pair", "llama3-8b"),
                       ("train step, forward", "train forward"),
                       ("train-zamba step, forward", "train-zamba forward"),
                       ("train-zamba step, backward",
                        "train-zamba matmul backward"),
                       ("train-gpt step, forward", "train-gpt forward"),
                       ("train-gpt step, backward", "train-gpt backward"),
                       ("train-gpt step, backward", TRAIN_GPT),
                       ("split rmsnorm, a launch", SPLIT),
                       ("int8 projections, one each", INT8)):
        for row in rows[path]:
            log(f"{what}: {row['name']} launches={row['launches']} "
                f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                f"library_ms={row['library_ms']}")
    kernels = (rows[MAIN] + rows[TRAIN] + rows[TRAIN_ZAMBA] + rows[TRAIN_GPT]
               + rows[SPLIT] + rows[INT8])
    log(f"card: {card_line()}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
