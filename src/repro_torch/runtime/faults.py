"""Scriptable, seeded fault injection for the fault-domain runtime (a
copy of ``repro.runtime.faults``, which the port may not import; its
torn writes patch the port's ``checkpoint.manager``).

A :class:`FaultPlan` is plain data — a seed plus a list of
:class:`FaultEvent`\\ s — that scripts *when* and *where* the cluster
misbehaves.  It deliberately owns no injection mechanism of its own:
every fault lands through a hook the runtime already exposes, so the
chaos path exercises exactly the production code paths:

  ===============  =====================================================
  kind             injected through
  ===============  =====================================================
  ``device_loss``  ``Trainer.run(fail_injector=)`` (+ ``MembershipFabric
                   .fail_host`` for the ranks named in ``hosts``)
  ``straggler``    ``Trainer(time_fn=)`` via :class:`VirtualStepClock`
  ``torn_ckpt``    ``checkpoint.manager.save`` via
                   :class:`TornCheckpointWrites` (orphan ``.tmp_`` +
                   OSError — a simulated hard kill mid-save)
  ``backpressure`` the server's ``PageAllocator`` via
                   :class:`BackpressureAllocator` (ensure() denied
                   inside the event window)
  ``lease_delay``  ``MembershipFabric(delivery=)`` via
                   :func:`delivery_schedule`
  ===============  =====================================================

Event coordinates are adapter-relative: trainer/server kinds read ``at``
/``duration`` as *steps*/*ticks*; ``lease_delay`` reads them as
simulated *seconds* on the membership clock.  Plans JSON round-trip so a
failing chaos scenario can be re-run byte-identically from its artifact,
and :meth:`FaultPlan.sample` draws a random-but-seeded plan for soak
runs (``random.Random(seed)`` — no global RNG state touched).
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import tempfile
from typing import Callable, Mapping, Sequence

KINDS = ("device_loss", "straggler", "torn_ckpt", "backpressure",
         "lease_delay")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault.

    ``at``: when it fires (step / tick / second — adapter-relative).
    ``hosts``: membership ranks it touches (``device_loss``: ranks to
    fail, empty = transient fault on an intact mesh; ``lease_delay``:
    senders whose heartbeats lag, empty = all).
    ``duration``: window length for windowed kinds (``straggler``,
    ``backpressure``, ``lease_delay``); 0 on one-shot kinds
    (``device_loss`` is persistent until a revive, ``torn_ckpt`` tears
    exactly one save).
    ``severity``: kind-specific magnitude — straggler slowdown factor,
    lease extra delay in seconds; unused otherwise.
    """

    kind: str
    at: float
    hosts: tuple[int, ...] = ()
    duration: float = 0.0
    severity: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.duration < 0 or self.at < 0:
            raise ValueError(f"negative fault coordinates: {self}")
        object.__setattr__(self, "hosts", tuple(self.hosts))

    def window(self, t: float) -> bool:
        """True when ``t`` falls inside this event's active window."""
        return self.at <= t < self.at + max(self.duration, 0.0)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "at": self.at,
                "hosts": list(self.hosts), "duration": self.duration,
                "severity": self.severity}

    @staticmethod
    def from_dict(d: Mapping) -> "FaultEvent":
        return FaultEvent(kind=d["kind"], at=d["at"],
                          hosts=tuple(d.get("hosts", ())),
                          duration=d.get("duration", 0.0),
                          severity=d.get("severity", 1.0))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    seed: int
    events: tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "events",
                           tuple(sorted(self.events,
                                        key=lambda e: (e.at, e.kind))))

    @classmethod
    def scripted(cls, *events: FaultEvent, seed: int = 0) -> "FaultPlan":
        """A hand-written plan (the smoke scenarios use this)."""
        return cls(seed=seed, events=tuple(events))

    @classmethod
    def sample(cls, seed: int, *, n_events: int = 4, n_hosts: int = 4,
               horizon: float = 20.0,
               kinds: Sequence[str] = KINDS) -> "FaultPlan":
        """Draw a seeded random plan: ``n_events`` faults over
        ``[0, horizon)``.  Host 0 is never killed — the simulation plays
        rank 0 (the process driving the loop cannot lose itself)."""
        rng = random.Random(seed)
        events = []
        for _ in range(n_events):
            kind = rng.choice(list(kinds))
            at = rng.uniform(0, horizon)
            if kind == "device_loss":
                k = rng.randint(1, max(1, n_hosts - 1))
                hosts = tuple(rng.sample(range(1, n_hosts),
                                         min(k, n_hosts - 1)))
                events.append(FaultEvent(kind, round(at), hosts=hosts))
            elif kind == "torn_ckpt":
                events.append(FaultEvent(kind, round(at)))
            elif kind == "straggler":
                events.append(FaultEvent(
                    kind, round(at), duration=rng.randint(1, 4),
                    severity=rng.uniform(3.0, 10.0)))
            elif kind == "backpressure":
                events.append(FaultEvent(
                    kind, round(at), duration=rng.randint(1, 6)))
            else:  # lease_delay
                hosts = tuple(rng.sample(range(n_hosts),
                                         rng.randint(1, n_hosts)))
                events.append(FaultEvent(
                    kind, at, hosts=hosts,
                    duration=rng.uniform(0.1, 1.0),
                    severity=rng.uniform(0.05, 0.4)))
        return cls(seed=seed, events=tuple(events))

    def by_kind(self, kind: str) -> tuple[FaultEvent, ...]:
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        return tuple(e for e in self.events if e.kind == kind)

    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "events": [e.to_dict() for e in self.events]}

    @staticmethod
    def from_dict(d: Mapping) -> "FaultPlan":
        return FaultPlan(seed=d.get("seed", 0),
                         events=tuple(FaultEvent.from_dict(e)
                                      for e in d.get("events", ())))

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    @staticmethod
    def load(path: str) -> "FaultPlan":
        with open(path) as f:
            return FaultPlan.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# Adapters: a FaultPlan -> the runtime's existing injection hooks.
# ---------------------------------------------------------------------------


def trainer_injector(plan: FaultPlan,
                     fabric=None) -> Callable[[int], None]:
    """``Trainer.run(fail_injector=)`` hook for the plan's device losses.

    At each event's step: the named hosts (if any) are failed on the
    membership fabric FIRST — peers must learn through lease expiry, the
    raise is only this process noticing its own step die — then a
    RuntimeError surfaces, driving the trainer's normal recovery path.
    ``hosts=()`` is a transient fault: the step dies but the pool is
    intact, so recovery must NOT re-plan.  Each event fires once (the
    replayed step after recovery must not re-die)."""
    fired: set[int] = set()

    def injector(step: int) -> None:
        for idx, ev in enumerate(plan.by_kind("device_loss")):
            if idx in fired or int(ev.at) != step:
                continue
            fired.add(idx)
            if fabric is not None:
                for r in ev.hosts:
                    fabric.fail_host(r)
            what = (f"hosts {list(ev.hosts)} lost"
                    if ev.hosts else "transient device fault")
            raise RuntimeError(
                f"injected device_loss at step {step}: {what}")

    return injector


def delivery_schedule(plan: FaultPlan, base_delay: float = 0.0,
                      ) -> Callable[[int, int, float], float]:
    """``MembershipFabric(delivery=)`` hook: heartbeat link delays.

    Each ``lease_delay`` event adds ``severity`` seconds to every
    heartbeat SENT by a host in ``hosts`` (empty = all hosts) during
    ``[at, at + duration)`` on the fabric clock — the knob that makes a
    healthy host look suspect and exercises the quorum's split-brain
    defenses."""
    events = plan.by_kind("lease_delay")

    def delivery(src: int, dst: int, t: float) -> float:
        delay = base_delay
        for ev in events:
            if ev.window(t) and (not ev.hosts or src in ev.hosts):
                delay += ev.severity
        return delay

    return delivery


class BackpressureAllocator:
    """Proxy over the server's ``PageAllocator`` denying ``ensure``
    inside the plan's backpressure windows (ticks, read from
    ``ticks_fn`` — pass ``lambda: server.ticks``).

    A denied ensure is indistinguishable from a genuinely exhausted pool,
    so the server walks its real degradation ladder: admission backoff,
    skipped decode beats, eventually deadline expiry.  Everything else
    delegates to the wrapped allocator (it IS the allocator — same page
    state before, during and after the window)."""

    def __init__(self, alloc, plan: FaultPlan,
                 ticks_fn: Callable[[], int]):
        self._alloc = alloc
        self._events = plan.by_kind("backpressure")
        self._ticks_fn = ticks_fn
        self.denied = 0

    def ensure(self, slot: int, n_tokens: int) -> bool:
        if any(ev.window(self._ticks_fn()) for ev in self._events):
            self.denied += 1
            return False
        return self._alloc.ensure(slot, n_tokens)

    def __getattr__(self, name):
        return getattr(self._alloc, name)


class TornCheckpointWrites:
    """Context manager tearing scripted checkpoint saves.

    Wraps ``checkpoint.manager.save``: when a save lands on a
    ``torn_ckpt`` event's step (each event tears once), a partial
    ``.tmp_`` staging dir is left in the ckpt_dir and an OSError raised
    WITHOUT running the real save — the on-disk signature of a hard kill
    mid-write (``manager.save`` cleans its own tmp on an exception it
    sees; a SIGKILL leaves one).  The trainer's ``_checkpoint`` retry
    must count the failure, sweep the orphan, and succeed on the next
    attempt."""

    def __init__(self, plan: FaultPlan):
        self._steps = {int(e.at) for e in plan.by_kind("torn_ckpt")}
        self.torn: list[int] = []
        self._orig = None

    def __enter__(self):
        from repro_torch.checkpoint import manager

        self._orig = manager.save

        def torn_save(ckpt_dir, step, tree, extra=None):
            if step in self._steps and step not in self.torn:
                self.torn.append(step)
                os.makedirs(ckpt_dir, exist_ok=True)
                tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
                with open(os.path.join(tmp, "arr_0.npy"), "wb") as f:
                    f.write(b"\x93NUMPY torn")   # a torn partial leaf
                raise OSError(
                    f"injected torn checkpoint write at step {step}")
            return self._orig(ckpt_dir, step, tree, extra)

        manager.save = torn_save
        return self

    def __exit__(self, *exc):
        from repro_torch.checkpoint import manager

        manager.save = self._orig
        return False


class VirtualStepClock:
    """``Trainer(time_fn=)`` stand-in that manufactures straggler steps.

    The trainer reads the clock twice per committed step (before/after
    the step's call).  This clock pairs those reads: every pair advances
    virtual time by ``base_dt``, scaled by the product of the severities
    of ``straggler`` events whose step window covers the pair's index —
    so a scripted straggler reliably trips the watchdog regardless of
    real host speed.  Limitation: a step that RAISES between the two
    reads skews the pairing by one; scenarios that mix stragglers with
    step failures should script the straggler window away from the
    failure step."""

    def __init__(self, plan: FaultPlan, base_dt: float = 0.01):
        self._events = plan.by_kind("straggler")
        self.base_dt = base_dt
        self._now = 0.0
        self._calls = 0

    def __call__(self) -> float:
        if self._calls % 2 == 1:      # closing read: charge the step
            step = self._calls // 2
            dt = self.base_dt
            for ev in self._events:
                if ev.window(step):
                    dt *= ev.severity
            self._now += dt
        self._calls += 1
        return self._now
