"""Fault-tolerant training loop: checkpoint/restart, failure recovery,
straggler watchdog, deterministic data replay (counterpart of
``repro.runtime.trainer``).

A failure surfaces as an exception raised out of the step: a
``RuntimeError`` (torch's CUDA errors and ``torch.distributed``'s
``DistBackendError`` are ones) or an ``OSError`` while checkpointing.
The loop's contract:

  - every step is a function of (params, opt_state, batch(step));
  - batches are functions of (seed, step), so a replay is exact;
  - on failure: restore the last committed checkpoint, rebuild the step
    (possibly on a new mesh: elastic), continue from the checkpoint's step;
  - stragglers: each step's wall time is tracked with an EMA; a step slower
    than ``straggler_factor`` x EMA fires the mitigation hook.

The port's step updates the parameters in place, so a step that fails
half way leaves them half updated; the restore overwrites every one of
them.  A sticky CUDA error (an illegal address, a device-side assert)
poisons the process's CUDA context and cannot be recovered inside it:
such a run dies, and resumes from its last checkpoint when it is started
again (``_restore_or_init`` at the start of ``run``).

A job of several ranks runs one Trainer per rank, each taking the same
path: each attempt gathers the checkpoint tree (``encode_ckpt``,
collective), the writer rank (``writer``) saves it, and every outcome is
agreed by all ranks (``agree``) before any counts it, so a torn save that
only the writer sees is retried by all and the budget runs out on all at
once.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time
from typing import Any, Callable

from repro_torch.checkpoint import manager as ckpt
from repro_torch.data.pipeline import TokenSource

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 50
    keep_ckpts: int = 3
    max_failures: int = 3
    straggler_factor: float = 3.0
    ema_beta: float = 0.9
    log_every: int = 10


@dataclasses.dataclass
class StragglerWatchdog:
    factor: float = 3.0
    beta: float = 0.9
    ema: float | None = None
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        if self.ema is None:
            self.ema = dt
            return False
        flagged = dt > self.factor * self.ema and self.ema > 0
        if flagged:
            self.events.append((step, dt, self.ema))
        else:
            # only fold non-outlier steps into the EMA
            self.ema = self.beta * self.ema + (1 - self.beta) * dt
        return flagged

    def reset(self):
        """Forget the EMA (keep the event log): the per-step cost changed
        legitimately (an elastic re-plan onto a smaller mesh), and the old
        mesh's EMA would flag every first step on the new one."""
        self.ema = None


class Trainer:
    def __init__(
        self,
        cfg: TrainerConfig,
        build_step: Callable[[], Callable],  # returns the train step
        source: TokenSource,
        init_state: Callable[[], tuple[Any, Any]],  # -> (params, opt_state)
        put_batch: Callable[[dict], Any],    # host batch -> device tensors
        mitigation_hook: Callable[[int], None] | None = None,
        time_fn: Callable[[], float] = time.monotonic,
        replan: Callable[[], Callable] | None = None,
        encode_ckpt: Callable[[Any, Any], Any] | None = None,
        decode_ckpt: Callable[[Any], tuple[Any, Any]] | None = None,
        ckpt_template: Callable[[], Any] | None = None,
        writer: Callable[[], bool] | None = None,
        agree: Callable[[bool], bool] | None = None,
    ):
        self.cfg = cfg
        self.build_step = build_step
        self.source = source
        self.init_state = init_state
        self.put_batch = put_batch
        self.watchdog = StragglerWatchdog(cfg.straggler_factor, cfg.ema_beta)
        self.mitigation_hook = mitigation_hook or (lambda step: None)
        self.time_fn = time_fn
        # elastic recovery: re-derive the plan on the surviving ranks and
        # return a fresh step built from it (launch.train wires
        # plan.replan_elastic here); None rebuilds the same plan
        self.replan = replan
        # state <-> checkpoint tree.  launch.train writes the JAX
        # package's tree (global arrays, the moments in plain's layout),
        # so a restart re-cuts it onto any surviving plan
        self.encode_ckpt = encode_ckpt or (lambda params, opt: (params, opt))
        self.decode_ckpt = decode_ckpt or (lambda tree: tree)
        # a shape/dtype-only view of the encoded tree (``ckpt.LeafSpec``
        # or meta tensors): restore reads nothing else from its template
        self.ckpt_template = ckpt_template
        # the one rank that writes, and the all-rank agreement on whether
        # any rank failed (both trivial in one process)
        self.writer = writer or (lambda: True)
        self.agree = agree or (lambda failed: failed)
        self.failures = 0        # consecutive: decays once recovery sticks
        self.total_failures = 0  # lifetime count (reporting only)
        self.replans: list[int] = []  # steps at which a re-plan happened
        self.history: list[dict] = []
        self._recovering = False

    def _restore_or_init(self):
        step = ckpt.latest_step(self.cfg.ckpt_dir)
        if step is None:
            params, opt_state = self.init_state()
            return params, opt_state, 0
        template = (self.ckpt_template() if self.ckpt_template is not None
                    else self.encode_ckpt(*self.init_state()))
        tree, meta = ckpt.restore(self.cfg.ckpt_dir, template)
        params, opt_state = self.decode_ckpt(tree)
        log.info("restored checkpoint at step %d", meta["step"])
        return params, opt_state, meta["step"]

    def _checkpoint(self, step: int, params, opt_state):
        """Save + prune under the same consecutive-failure budget as the
        train step.  ``save`` is atomic (tmp + rename), so a torn write, or
        a device error while the tree is gathered to the host, loses only
        the attempt: it is counted, its orphan tmp is swept, and the save
        retries at once (no committed checkpoint was touched).  Budget
        exhaustion raises, like a step that cannot recover."""
        while True:
            err = None
            try:
                # every rank encodes (the gather is collective); the writer
                # saves
                tree = self.encode_ckpt(params, opt_state)
                if self.writer():
                    ckpt.save(self.cfg.ckpt_dir, step, tree)
                    ckpt.prune(self.cfg.ckpt_dir, self.cfg.keep_ckpts)
            except (RuntimeError, OSError) as e:
                err = e
            # every rank learns the writer's outcome (and waits for the
            # commit) before it goes on
            if not self.agree(err is not None):
                return
            self.failures += 1
            self.total_failures += 1
            log.error("checkpoint at step %d failed (%s); retrying (%d/%d)",
                      step, err or "on the writer", self.failures,
                      self.cfg.max_failures)
            if self.failures > self.cfg.max_failures:
                if err is not None:
                    raise err
                raise OSError(f"checkpoint at step {step} failed on the "
                              f"writer rank")
            if self.writer():
                swept = ckpt.sweep_orphan_tmps(self.cfg.ckpt_dir)
                if swept:
                    log.info("swept %d torn checkpoint tmp(s)", swept)
            # like step recovery, the budget only decays once the next
            # train step commits: a flapping disk still trips max_failures
            self._recovering = True

    def run(self, fail_injector: Callable[[int], None] | None = None):
        train_step = self.build_step()
        params, opt_state, start = self._restore_or_init()
        step = start
        while step < self.cfg.total_steps:
            try:
                if fail_injector is not None:
                    fail_injector(step)
                batch = self.put_batch(self.source.global_batch(step))
                t0 = self.time_fn()
                params, opt_state, metrics = train_step(params, opt_state,
                                                        batch)
                loss = float(metrics["loss"])   # synchronises
                dt = self.time_fn() - t0
                if self.watchdog.observe(step, dt):
                    log.warning("straggler at step %d (%.3fs vs EMA %.3fs)",
                                step, dt, self.watchdog.ema)
                    self.mitigation_hook(step)
                self.history.append({"step": step, "loss": loss, "dt": dt})
                if self._recovering:
                    # a post-recovery step committed: the fault was
                    # transient, so the consecutive-failure budget resets
                    self._recovering = False
                    self.failures = 0
                if step % self.cfg.log_every == 0:
                    log.info("step %d loss %.4f (%.3fs)", step, loss, dt)
            except RuntimeError as e:
                self.failures += 1
                self.total_failures += 1
                log.error("step %d failed (%s); recovering (%d/%d)",
                          step, e, self.failures, self.cfg.max_failures)
                if self.failures > self.cfg.max_failures:
                    raise
                # rebuild the step (fresh groups, possibly a new mesh) and
                # restore the last committed state onto the plan it runs
                if self.replan is not None:
                    new_step = self.replan()
                    if new_step is not train_step:
                        # an actual re-plan (the hook hands back the live
                        # step for a transient fault on an intact mesh)
                        self.replans.append(step)
                        self.watchdog.reset()
                        log.info("elastic re-plan applied at step %d", step)
                    train_step = new_step
                else:
                    train_step = self.build_step()
                self._recovering = True
                params, opt_state, step = self._restore_or_init()
                continue
            step += 1
            if step % self.cfg.ckpt_every == 0 or step == self.cfg.total_steps:
                self._checkpoint(step, params, opt_state)
        return params, opt_state
