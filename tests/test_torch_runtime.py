"""The port's copies of the fault-domain runtime
(``repro_torch.runtime.membership`` and ``runtime.faults``) against the
reference's, and the chaos smoke's decode-mesh shrink (S4) against the
reference's tokens.

The membership protocol is a deterministic simulation: on seeded
scenarios (failures simultaneous or staggered, heartbeat delays) the
port's fabric must commit the reference's views, at the same simulated
times, epochs and quorum evidence; the reference's protocol invariants
(``tests/test_membership.py``) hold on the port.  A ``FaultPlan`` drawn
from a seed, its JSON and every adapter's schedule equal the reference's.
S4 runs on four gloo ranks (``launch.chaos_smoke.spawn``, the reference's
weights handed over as an ``.npz``): the server on (1, 2, 2), stepped 7
ticks, remeshed onto (1, 2, 1) (two ranks leave) and drained; its tokens,
and the uninterrupted server's, equal the reference's S4 on host devices.
"""
import dataclasses

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.runtime import faults as ref_faults  # noqa: E402
from repro.runtime import membership as ref_membership  # noqa: E402
from repro_torch.runtime import faults, membership  # noqa: E402

#: (hosts, killed, seconds between kills, delayed sender, its delay, until)
SCENARIOS = [(4, (2,), 0.0, 0, 0.0, 0.0),
             (4, (1, 2, 3), 0.0, 0, 0.0, 0.0),
             (5, (1, 3), 0.3, 2, 0.2, 1.0),
             (4, (2, 3), 0.0, 1, 0.25, 1.0),
             (3, (), 0.0, 1, 0.35, 1.2),
             (5, (4, 2, 1), 0.1, 0, 0.3, 0.5)]


def _script(mod, hosts, killed, stagger, src, delay, until):
    """Run one scenario on ``mod``'s fabric; returns what it committed."""
    def delivery(s, d, t):
        return delay if s == src and t < until else 0.0

    fabric = mod.MembershipFabric(hosts, delivery=delivery)
    t = 0.0
    for r in killed:
        fabric.run_until(t)
        fabric.fail_host(r)
        t += stagger
    view = fabric.converge(timeout_s=30.0)
    return {"view": dataclasses.asdict(view),
            "commits": [dataclasses.asdict(c) for c in fabric.commits],
            "epochs": {e: sorted(v) for e, v in fabric.epochs().items()},
            "hosts": {r: dataclasses.asdict(h.committed)
                      for r, h in fabric.hosts.items()},
            "now": fabric.clock.time()}


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_membership_commits_the_references_views(scenario):
    assert _script(membership, *scenario) == \
        _script(ref_membership, *scenario)


@settings(max_examples=20)
@given(n_hosts=st.integers(3, 5), kill_mask=st.integers(0, 15),
       stagger_ds=st.integers(0, 3), delay_cs=st.integers(0, 35),
       delayed_src=st.integers(0, 4), delay_until_ds=st.integers(0, 12))
def test_property_membership_invariants(n_hosts, kill_mask, stagger_ds,
                                        delay_cs, delayed_src,
                                        delay_until_ds):
    """The reference's property test on the port: a single planner per
    epoch, convergence on the healthy set, no commit without quorum."""
    kills = [r for r in range(1, n_hosts) if (kill_mask >> (r - 1)) & 1]

    def delivery(src, dst, t):
        if src == delayed_src % n_hosts and t < delay_until_ds / 10.0:
            return delay_cs / 100.0
        return 0.0

    fabric = membership.MembershipFabric(n_hosts, delivery=delivery)
    t = 0.0
    for r in kills:
        fabric.run_until(t)
        fabric.fail_host(r)
        t += stagger_ds / 10.0
    view = fabric.converge(timeout_s=30.0)
    healthy = tuple(r for r in range(n_hosts) if r not in kills)
    assert view.alive == healthy and view.planner == min(healthy)
    for epoch, views in fabric.epochs().items():
        assert len(views) == 1, f"epoch {epoch} split-brain: {views}"
    for c in fabric.commits:
        assert c.acks >= len(c.electorate) // 2 + 1, c
        assert c.stable >= fabric.cfg.quorum_views, c


def test_revive_rejoins_and_no_survivors_fails_loudly():
    fabric = membership.MembershipFabric(3)
    fabric.fail_host(1)
    assert fabric.converge().alive == (0, 2)
    fabric.revive_host(1)
    v = fabric.converge()
    assert v.alive == (0, 1, 2) and v.epoch == 2
    dead = membership.MembershipFabric(2)
    dead.fail_host(0)
    dead.fail_host(1)
    with pytest.raises(TimeoutError):
        dead.converge(timeout_s=1.0)


def test_ranks_as_devices_and_the_shim():
    """A rank (any object with an ``id``) is the port's device: the pool
    slices and concatenates as the reference's devices do, and the
    deprecated single-observer shim answers as the reference's."""
    from repro_torch.launch.train import Rank

    ranks = [Rank(i) for i in range(8)]
    fabric = membership.fabric_over_devices(4, ranks)
    assert fabric.host_devices[1] == [Rank(2), Rank(3)]
    fabric.fail_host(1)
    fabric.fail_host(3)
    runtime = membership.MembershipRuntime(fabric, local_rank=0)
    view = runtime.converged_view()
    assert [r.id for r in runtime.devices(view)] == [0, 1, 4, 5]
    assert runtime.is_planner(view)
    with pytest.raises(ValueError):
        membership.fabric_over_devices(3, ranks)
    pool = ranks[:2]
    shims = [mod.SingleObserverMembership(lambda: pool)
             for mod in (membership, ref_membership)]
    views = [(s.converged_view(), s.is_planner()) for s in shims]
    pool.pop()
    views += [(s.converged_view(), s.is_planner()) for s in shims]
    assert [(v.epoch, v.alive, p) for v, p in views[::2]] == \
        [(v.epoch, v.alive, p) for v, p in views[1::2]]


@pytest.mark.parametrize("seed", range(12))
def test_sampled_fault_plans_equal_the_references(seed):
    kw = dict(n_events=6, n_hosts=4 + seed % 3, horizon=15.0 + seed)
    mine = faults.FaultPlan.sample(seed, **kw)
    theirs = ref_faults.FaultPlan.sample(seed, **kw)
    assert mine.to_dict() == theirs.to_dict()
    assert faults.FaultPlan.from_dict(theirs.to_dict()) == mine
    # every adapter's schedule
    d_mine, d_ref = (mod.delivery_schedule(p, base_delay=0.01)
                     for mod, p in ((faults, mine), (ref_faults, theirs)))
    grid = [(s, d, t / 4) for s in range(4) for d in range(2)
            for t in range(80)]
    assert [d_mine(*g) for g in grid] == [d_ref(*g) for g in grid]
    c_mine, c_ref = faults.VirtualStepClock(mine), \
        ref_faults.VirtualStepClock(theirs)
    assert [c_mine() for _ in range(60)] == [c_ref() for _ in range(60)]


def test_fault_events_validate_and_round_trip_as_the_references(tmp_path):
    for mod in (faults, ref_faults):
        with pytest.raises(ValueError):
            mod.FaultEvent("meteor", at=1)
        with pytest.raises(ValueError):
            mod.FaultEvent("straggler", at=-1)
    events = [("device_loss", 5, (2, 3), 0.0, 1.0),
              ("lease_delay", 0.0, (1,), 1.0, 0.25),
              ("torn_ckpt", 4, (), 0.0, 1.0),
              ("straggler", 2, (), 1.0, 20.0),
              ("backpressure", 2, (), 12.0, 1.0)]
    mine = faults.FaultPlan.scripted(
        *(faults.FaultEvent(*e) for e in events), seed=9)
    theirs = ref_faults.FaultPlan.scripted(
        *(ref_faults.FaultEvent(*e) for e in events), seed=9)
    assert mine.to_dict() == theirs.to_dict()
    mine.dump(str(tmp_path / "plan.json"))
    assert ref_faults.FaultPlan.load(str(tmp_path / "plan.json")) == theirs
    assert [e.to_dict() for e in mine.by_kind("straggler")] == \
        [e.to_dict() for e in theirs.by_kind("straggler")]


def test_trainer_injector_and_backpressure_as_the_references():
    plan = [mod.FaultPlan.scripted(
        mod.FaultEvent("device_loss", at=3, hosts=(1,)),
        mod.FaultEvent("device_loss", at=5),
        mod.FaultEvent("backpressure", at=2, duration=3))
        for mod in (faults, ref_faults)]
    seen = []
    for mod, p, fmod in ((faults, plan[0], membership),
                         (ref_faults, plan[1], ref_membership)):
        fabric = fmod.MembershipFabric(3)
        inject = mod.trainer_injector(p, fabric)
        out = []
        for step in (0, 3, 3, 5, 5, 6):
            try:
                inject(step)
                out.append(None)
            except RuntimeError as e:
                out.append(str(e))
        out.append(fabric.healthy_ranks())

        class Alloc:
            def ensure(self, slot, n):
                return True
            held_pages = 0

        tick = [0]
        bp = mod.BackpressureAllocator(Alloc(), p, lambda: tick[0])
        for tick[0] in range(7):
            out.append(bp.ensure(0, 1))
        out.append((bp.denied, bp.held_pages))
        seen.append(out)
    assert seen[0] == seen[1]


# ---------------------------------------------------------------------------
# Chaos S4 on four gloo ranks against the reference's.
# ---------------------------------------------------------------------------


def _reference_s4(params):
    """The reference's S4 on host devices: the uninterrupted server's tokens
    and the remeshed one's."""
    from repro.core.mesh import atp_topo
    from repro.launch import chaos_smoke as ref_chaos
    from repro.launch.serve import remesh_paged_server
    from repro.runtime.server import Request

    cfg = ref_chaos.tiny_cfg(num_kv_heads=4)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in (5, 9, 7, 12)]
    base = ref_chaos._make_server(cfg, params, atp_topo(1, 2, 2),
                                  num_pages=40)
    for rid, p in enumerate(prompts):
        base.submit(Request(rid=rid, prompt=p.copy(), max_new=6))
    base.run_until_drained()
    srv = ref_chaos._make_server(cfg, params, atp_topo(1, 2, 2),
                                 num_pages=40)
    for rid, p in enumerate(prompts):
        srv.submit(Request(rid=rid, prompt=p.copy(), max_new=6))
    for _ in range(7):
        srv.step()
    remesh_paged_server(srv, cfg, params, topo=atp_topo(1, 2, 1),
                        devices=jax.devices()[:2])
    srv.run_until_drained()
    return ({r.rid: [int(t) for t in r.out] for r in base.completed},
            {r.rid: [int(t) for t in r.out] for r in srv.completed},
            srv.stats()["reshapes"])


def test_chaos_s4_tokens_equal_the_references(tmp_path):
    from repro.launch import chaos_smoke as ref_chaos
    from repro.models import lm as ref_lm
    from repro_torch.launch import chaos_smoke

    cfg = ref_chaos.tiny_cfg(num_kv_heads=4)
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(0))
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / "params.npz", **flat)
    res = chaos_smoke.spawn("s4", 4, tmp_path / "s4",
                            {"params": str(tmp_path / "params.npz")})
    assert ["departed" in r for r in res] == [False, False, True, True]
    base, out, reshapes = _reference_s4(params)
    for r in res[:2]:
        assert {int(k): v for k, v in r["base"].items()} == base
        assert {int(k): v for k, v in r["out"].items()} == out
        assert r["reshapes"] == reshapes == 1 and r["held"] == 0
    assert out == base
