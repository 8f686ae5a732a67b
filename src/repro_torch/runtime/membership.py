"""Lease/heartbeat membership for elastic recovery (simulated hosts): a
copy of ``repro.runtime.membership``, which the port may not import.  In
the port a "device" is a rank of the job: any object with an ``id``
(``launch.train.Rank``).

A bare elastic loop has one omniscient observer: a ``devices_fn`` poll
that *is* the surviving pool.  Real fleets have no such oracle — each
host sees only its local devices and whatever its peers manage to tell
it, and the job must still agree on ONE surviving pool and ONE host that
runs the (expensive) re-search before any reshard commits.  This module
is that agreement layer, as a deterministic simulation:

  - every simulated host broadcasts a **heartbeat** every
    ``heartbeat_s`` carrying its current *proposed* surviving set and
    its latest *committed* view;
  - a peer silent for ``lease_s`` is **suspected** (dropped from the
    proposal); silent for ``dead_after_s`` it is **hard-expired**
    (dropped from the quorum denominator too — suspicion is fast,
    removal from the electorate is deliberately slow);
  - a host **commits** a new view only when (a) its proposal has been
    stable for ``quorum_views`` consecutive reviews (the *two-view
    quorum*: one glitched review can never reshard the job), and (b) a
    majority of the previous committed view's non-hard-expired members
    gossip the *same* proposal (so two healthy hosts that merely can't
    hear each other cannot both commit — one of them lacks the
    majority);
  - committed views are **epoch-numbered**; followers adopt any higher
    committed epoch they hear, and the **re-planner is the lowest rank
    of the committed view** — a pure function of the view, so the
    election needs no extra round-trips and "exactly one planner per
    epoch" reduces to "exactly one committed view per epoch".

Split-brain bound: with all links delayed below ``dead_after_s``, two
different views can never commit the same epoch (the majorities are
taken over the same electorate and would have to intersect in a host
proposing both sets at once).  A full partition longer than
``dead_after_s`` is indistinguishable from death on both sides — the
classic impossibility — and is exactly what the config knob trades
against recovery latency.

Everything is injectable for determinism: the clock (:class:`SimClock`),
the per-link delivery schedule (``delivery(src, dst, t) -> delay seconds
or None to drop``, the hook ``runtime.faults`` scripts), and the
host→device mapping.  :class:`MembershipRuntime` adapts a fabric to what
``launch.train.make_elastic_trainer`` consumes;
:class:`SingleObserverMembership` keeps the deprecated ``devices_fn``
path alive behind the same interface.
"""
from __future__ import annotations

import dataclasses
import heapq
import logging
import math
from typing import Callable, Sequence

log = logging.getLogger("repro_torch.membership")


class SimClock:
    """Injectable simulated clock (seconds).  The fabric advances it;
    fault scripts and tests read/advance it too — one shared notion of
    'now' keeps failure injection and lease expiry deterministic."""

    def __init__(self, now: float = 0.0):
        self.now = float(now)

    def time(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self.now += dt
        return self.now


@dataclasses.dataclass(frozen=True)
class MembershipConfig:
    #: heartbeat (and proposal-review) cadence per healthy host
    heartbeat_s: float = 0.05
    #: silence after which a peer is suspected (leaves the proposal)
    lease_s: float = 0.2
    #: silence after which a peer leaves the quorum *denominator* — the
    #: slow threshold that lets a shrunken survivor set reach majority
    dead_after_s: float = 0.6
    #: consecutive identical proposal reviews required before commit
    quorum_views: int = 2

    def __post_init__(self):
        if not (0 < self.heartbeat_s <= self.lease_s <= self.dead_after_s):
            raise ValueError(
                f"need heartbeat_s <= lease_s <= dead_after_s, got "
                f"{self.heartbeat_s}/{self.lease_s}/{self.dead_after_s}")
        if self.quorum_views < 1:
            raise ValueError("quorum_views must be >= 1")


@dataclasses.dataclass(frozen=True)
class View:
    """An epoch-numbered committed membership view."""

    epoch: int
    alive: tuple[int, ...]

    @property
    def planner(self) -> int:
        """The deterministically elected re-planner: lowest surviving
        rank.  A pure function of the view — agreeing on the view IS
        the election."""
        if not self.alive:
            raise ValueError("empty view has no planner")
        return min(self.alive)


@dataclasses.dataclass(frozen=True)
class CommitRecord:
    """One originating commit (adoptions via gossip are not recorded):
    who committed what, with how much evidence."""

    t: float
    rank: int
    view: View
    acks: int
    electorate: tuple[int, ...]
    stable: int


class _Host:
    def __init__(self, rank: int, peers: Sequence[int], t0: float,
                 initial: View):
        self.rank = rank
        self.healthy = True
        # start with a full lease grace for every peer (a fresh cluster
        # must not instantly suspect everyone before the first beats land)
        self.last_heard = {p: t0 for p in peers if p != rank}
        self.peer_proposed: dict[int, tuple[int, ...]] = {}
        self.committed = initial
        self.proposed: tuple[int, ...] | None = None
        self.stable = 0


class MembershipFabric:
    """The simulated cluster: hosts + in-flight heartbeats + the clock.

    ``delivery(src, dst, t)`` returns the link delay in seconds for a
    heartbeat sent at ``t`` (None drops it); default is instantaneous.
    ``host_devices`` maps each rank to the accelerator slice it owns —
    ``surviving_devices`` of a committed view is the concatenation over
    its ranks, which is what the elastic trainer rebuilds its mesh from.
    """

    def __init__(self, n_hosts: int, cfg: MembershipConfig | None = None,
                 *, clock: SimClock | None = None,
                 delivery: Callable[[int, int, float], float | None]
                 | None = None,
                 host_devices: dict[int, Sequence] | None = None):
        if n_hosts < 1:
            raise ValueError("need at least one host")
        self.cfg = cfg or MembershipConfig()
        self.clock = clock or SimClock()
        self.delivery = delivery or (lambda src, dst, t: 0.0)
        self.host_devices = dict(host_devices or {})
        t0 = self.clock.time()
        ranks = tuple(range(n_hosts))
        initial = View(epoch=0, alive=ranks)
        self.hosts = {r: _Host(r, ranks, t0, initial) for r in ranks}
        self.commits: list[CommitRecord] = []
        self._msgs: list[tuple[float, int, int, dict]] = []  # heap
        self._seq = 0
        self._next_beat = {r: t0 for r in ranks}

    # -- fault hooks (runtime.faults drives these) -------------------------

    def fail_host(self, rank: int) -> None:
        """Local device failure: the host stops heartbeating and stops
        receiving — its peers only ever learn through lease expiry (no
        oracle announces the death)."""
        self.hosts[rank].healthy = False

    def revive_host(self, rank: int) -> None:
        h = self.hosts[rank]
        h.healthy = True
        now = self.clock.time()
        # fresh lease grace: a revived host must re-learn the cluster,
        # not instantly suspect everyone it missed while down
        h.last_heard = {p: now for p in self.hosts if p != rank}
        h.proposed, h.stable = None, 0
        self._next_beat[rank] = now

    def healthy_ranks(self) -> tuple[int, ...]:
        return tuple(sorted(r for r, h in self.hosts.items() if h.healthy))

    # -- the event loop ----------------------------------------------------

    def step(self, dt: float) -> None:
        """Advance simulated time by ``dt``, delivering heartbeats and
        running proposal reviews in deterministic event order."""
        self.run_until(self.clock.time() + dt)

    def run_until(self, t_end: float) -> None:
        while True:
            t_msg = self._msgs[0][0] if self._msgs else math.inf
            beats = [self._next_beat[r] for r in sorted(self.hosts)
                     if self.hosts[r].healthy]
            t_beat = min(beats) if beats else math.inf
            t_next = min(t_msg, t_beat)
            if t_next > t_end:
                break
            self.clock.now = max(self.clock.now, t_next)
            now = self.clock.time()
            while self._msgs and self._msgs[0][0] <= now:
                deliver_t, _, dst, hb = heapq.heappop(self._msgs)
                self._receive(dst, hb, deliver_t)
            for r in sorted(self.hosts):
                h = self.hosts[r]
                if h.healthy and self._next_beat[r] <= now:
                    self._broadcast(h, now)
                    self._review(h, now)
                    self._next_beat[r] = now + self.cfg.heartbeat_s
        self.clock.now = max(self.clock.now, t_end)

    def _broadcast(self, h: _Host, now: float) -> None:
        hb = {"src": h.rank,
              # before the first review the honest proposal is "nobody
              # suspected yet" — the committed view, not a self-singleton
              "proposed": h.proposed or h.committed.alive,
              "committed": h.committed}
        for dst in self.hosts:
            if dst == h.rank:
                continue
            delay = self.delivery(h.rank, dst, now)
            if delay is None:
                continue
            self._seq += 1
            heapq.heappush(self._msgs,
                           (now + max(0.0, delay), self._seq, dst, hb))

    def _receive(self, dst: int, hb: dict, t: float) -> None:
        h = self.hosts[dst]
        if not h.healthy:
            return  # a dead host's NIC hears nothing
        src = hb["src"]
        h.last_heard[src] = t
        h.peer_proposed[src] = hb["proposed"]
        other: View = hb["committed"]
        if other.epoch > h.committed.epoch:
            # follower catch-up: adopt the newer committed view (its
            # committer had the quorum evidence); restart local stability
            h.committed = other
            h.proposed, h.stable = None, 0

    def _review(self, h: _Host, now: float) -> None:
        cfg = self.cfg
        cand = tuple(sorted(
            {h.rank} | {p for p, t in h.last_heard.items()
                        if now - t <= cfg.lease_s}))
        if cand == h.proposed:
            h.stable += 1
        else:
            h.proposed, h.stable = cand, 1
        if cand == h.committed.alive or h.stable < cfg.quorum_views:
            return
        # the electorate: the previous committed view minus hard-expired
        # members (suspicion alone never shrinks the denominator — that
        # asymmetry is what blocks a transiently-deaf host from
        # committing a minority view with itself as the whole majority)
        electorate = tuple(sorted(
            r for r in h.committed.alive
            if r == h.rank or now - h.last_heard.get(r, now) <= cfg.dead_after_s))
        acks = sum(1 for r in electorate
                   if r == h.rank or h.peer_proposed.get(r) == cand)
        if acks < len(electorate) // 2 + 1:
            return
        view = View(epoch=h.committed.epoch + 1, alive=cand)
        h.committed = view
        self.commits.append(CommitRecord(
            t=now, rank=h.rank, view=view, acks=acks,
            electorate=electorate, stable=h.stable))
        log.info("host %d committed epoch %d view %s (%d/%d acks)",
                 h.rank, view.epoch, cand, acks, len(electorate))

    # -- convergence -------------------------------------------------------

    def converge(self, timeout_s: float = 60.0) -> View:
        """Drive the protocol until every healthy host's committed view
        equals the healthy set, and return it (the shared surviving-pool
        view the re-planner acts on).  Raises TimeoutError after
        ``timeout_s`` simulated seconds — an unreachable agreement (e.g.
        a majority died at once) must fail loudly, not spin."""
        target = self.healthy_ranks()
        if not target:
            raise TimeoutError("no healthy hosts left to converge")
        deadline = self.clock.time() + timeout_s
        while True:
            views = {self.hosts[r].committed for r in target}
            if len(views) == 1 and next(iter(views)).alive == target:
                return next(iter(views))
            if self.clock.time() >= deadline:
                raise TimeoutError(
                    f"membership did not converge on {target} within "
                    f"{timeout_s}s (views: "
                    f"{ {r: self.hosts[r].committed for r in target} })")
            self.run_until(min(deadline,
                               self.clock.time() + self.cfg.heartbeat_s))

    def surviving_devices(self, view: View | None = None) -> list:
        """The accelerator pool of a committed view (host order)."""
        view = view if view is not None else self.converge()
        out: list = []
        for r in view.alive:
            out.extend(self.host_devices.get(r, ()))
        return out

    def epochs(self) -> dict[int, set[tuple[int, ...]]]:
        """{epoch: set of committed alive-sets} — the split-brain probe
        (every value must be a singleton)."""
        out: dict[int, set[tuple[int, ...]]] = {}
        for c in self.commits:
            out.setdefault(c.view.epoch, set()).add(c.view.alive)
        return out


class MembershipRuntime:
    """What ``make_elastic_trainer`` consumes, answered by the protocol:
    *what is the agreed surviving pool, and is this host the elected
    re-planner?*  This process plays host ``local_rank``: in the port each
    rank's process plays the host that holds it, and a rank whose host is
    lost leaves the run (``launch.train.Departed``)."""

    def __init__(self, fabric: MembershipFabric, local_rank: int = 0,
                 *, converge_timeout_s: float = 60.0):
        self.fabric = fabric
        self.local_rank = local_rank
        self.converge_timeout_s = converge_timeout_s

    def converged_view(self) -> View:
        return self.fabric.converge(self.converge_timeout_s)

    def devices(self, view: View | None = None) -> list:
        view = view if view is not None else self.converged_view()
        return self.fabric.surviving_devices(view)

    def is_planner(self, view: View | None = None) -> bool:
        view = view if view is not None else self.converged_view()
        return view.planner == self.local_rank


class SingleObserverMembership:
    """Deprecation shim for the ``devices_fn`` poll: one omniscient
    observer, no leases, no quorum, no election — every answer is "the
    pool is whatever my poll says and I am the planner".  Kept so old
    callers keep working (behind a loud warning in ``make_elastic_
    trainer``); new code should drive a :class:`MembershipFabric`."""

    def __init__(self, devices_fn: Callable[[], Sequence]):
        self._devices_fn = devices_fn
        self._epoch = 0
        self._last_ids: tuple | None = None

    def converged_view(self) -> View:
        ids = tuple(sorted(getattr(d, "id", i)
                           for i, d in enumerate(self._devices_fn())))
        if self._last_ids is not None and ids != self._last_ids:
            self._epoch += 1  # the poll changed: call it a new epoch
        self._last_ids = ids
        return View(epoch=self._epoch, alive=(0,))

    def devices(self, view: View | None = None) -> list:
        return list(self._devices_fn())

    def is_planner(self, view: View | None = None) -> bool:
        return True


def fabric_over_devices(n_hosts: int, devices: Sequence,
                        cfg: MembershipConfig | None = None,
                        *, clock: SimClock | None = None,
                        delivery=None) -> MembershipFabric:
    """Partition an attached device pool evenly over ``n_hosts``
    simulated hosts (rank r owns the r-th contiguous slice) — the
    standard smoke/test wiring for a single-process multi-device run."""
    devices = list(devices)
    if n_hosts < 1 or len(devices) % n_hosts:
        raise ValueError(
            f"{len(devices)} devices do not split over {n_hosts} hosts")
    per = len(devices) // n_hosts
    return MembershipFabric(
        n_hosts, cfg, clock=clock, delivery=delivery,
        host_devices={r: devices[r * per:(r + 1) * per]
                      for r in range(n_hosts)})
