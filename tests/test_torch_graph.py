"""The captured serving step's host-side parts on the CPU: the fixed-shape
state write-back that lets the paged step be captured as a CUDA graph,
the host check of the slot ids, and ``launch.steps.CapturedStep``'s
static-buffer wrapper, which on the CPU calls the step's body on its
buffers instead of replaying a graph.

The write-back is held against the host-synced form it replaced
(``lm.slot_map`` + ``lm._state_put``) and against the JAX package's
scatter (``repro.models.lm._state_put``, ids past the pool dropped) on
slot arrays made from a seed with numpy.  The wrapper is held against the
uncaptured body (``info.plain``) over whole server runs at reduced width,
fp32 weights, where the two must give the same greedy tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import (build_paged_step,  # noqa: E402
                                     check_slot_ids)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.paging import GARBAGE_PAGE, PagedConfig  # noqa: E402
from repro_torch.runtime.server import Request, ServerConfig  # noqa: E402

GEOM = dict(page_size=4, num_pages=40, pages_per_slot=8)
ZAMBA_LAYERS = 5


def _slot_cases():
    """(slots, slot ids [b], start [b]) from a seed: live ids distinct, the
    sentinel ``slots`` repeated, a live slot recycled (start 0)."""
    rng = np.random.default_rng(11)
    cases = [(3, np.array([3, 1]), np.array([5, 0])),      # one sentinel row
             (4, np.array([4, 4, 4, 4]), np.zeros(4, int)),  # all sentinel
             (2, np.array([1]), np.array([0]))]            # prefill, b = 1
    for _ in range(5):
        slots = int(rng.integers(2, 6))
        b = int(rng.integers(1, slots + 3))
        ids = rng.permutation(slots)[:b]
        ids = np.concatenate([ids, np.full(b - len(ids), slots)])
        rng.shuffle(ids)
        cases.append((slots, ids, rng.integers(0, 3, b) * 4))
    return cases


@pytest.mark.parametrize("slots,slot,start", _slot_cases())
def test_fixed_slot_map_writes_back_as_slot_map_and_jax(slots, slot, start):
    rng = np.random.default_rng(int(slot.sum()) + slots)
    pool = rng.standard_normal((slots, 3, 5)).astype(np.float32)
    rows = rng.standard_normal((len(slot), 3, 5)).astype(np.float32)
    t_slot, t_start = torch.from_numpy(slot), torch.from_numpy(start)

    fixed = lm.fixed_slot_map(t_slot, t_start, slots)
    old = lm.slot_map(t_slot, t_start, slots)
    got = {"a": torch.from_numpy(pool.copy())}
    want = {"a": torch.from_numpy(pool.copy())}
    lm._state_put(got, {"a": torch.from_numpy(rows)}, fixed)
    lm._state_put(want, {"a": torch.from_numpy(rows)}, old)
    np.testing.assert_array_equal(got["a"].numpy(), want["a"].numpy())
    ref = jax_lm._state_put({"a": jnp.asarray(pool)}, {"a": jnp.asarray(rows)},
                            jnp.asarray(slot))
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(ref["a"]))

    # and both forms read the same rows, zeros where a window starts at 0
    pools = {"a": torch.from_numpy(pool)}
    took = lm._state_take(pools, fixed)["a"].numpy()
    np.testing.assert_array_equal(took,
                                  lm._state_take(pools, old)["a"].numpy())
    ref = jax_lm._state_take({"a": jnp.asarray(pool)}, jnp.asarray(slot),
                             jnp.asarray(start == 0))["a"]
    live = slot < slots   # a sentinel row reads a clamped row either way
    np.testing.assert_array_equal(took[live], np.asarray(ref)[live])


def test_fixed_slot_map_shapes_do_not_depend_on_the_ids():
    """What a captured graph needs: every tensor's shape follows b and
    slots alone, whatever the ids."""
    shapes = set()
    for ids in ([0, 1, 2], [3, 3, 3], [2, 3, 0]):
        sm = lm.fixed_slot_map(torch.tensor(ids), torch.tensor([0, 4, 8]), 3)
        shapes.add(tuple(tuple(t.shape) for t in
                         (sm.slot, sm.take, sm.fresh, sm.src, sm.hit)))
        assert sm.put is None and sm.rows is None
    assert shapes == {((3,), (3,), (3,), (3,), (3,))}


def test_host_check_refuses_a_live_slot_twice():
    with pytest.raises(ValueError, match="appears twice"):
        check_slot_ids(np.array([1, 3, 1], np.int32), 3)
    check_slot_ids(np.array([3, 3, 0], np.int32), 3)   # sentinels may repeat
    check_slot_ids(np.array([2], np.int32), 3)


def _server(arch, seed=0, **scfg):
    cfg = get_config(arch).reduced()
    if arch == "zamba2-7b":
        cfg = dataclasses.replace(cfg, num_layers=ZAMBA_LAYERS)
    params = lm.init_params(cfg, seed=seed, dtype=torch.float32, device="cpu")
    server, info = serve.make_paged_server(
        cfg, ServerConfig(batch_slots=2, prefill_chunk=4,
                          paged=PagedConfig(**GEOM), **scfg),
        params, topo=atp_topo(1, 1, 1), device="cpu")
    return cfg, server, info


def test_serve_step_refuses_a_live_slot_twice_before_the_step_runs():
    """Through the Server's step, captured or not, before any input is
    copied: nothing is captured and the caches stay as they were."""
    cfg, server, _ = _server("zamba2-7b")
    step = server.step_fn
    tokens = np.zeros((2, 1), np.int32)
    table = np.zeros((2, GEOM["pages_per_slot"]), np.int32)
    before = [t.clone() for t in _tree(server.caches)]
    for fn in (step, step.uncaptured()):
        with pytest.raises(ValueError, match="appears twice"):
            fn(tokens, np.array([3, 4], np.int32), table,
               np.array([1, 1], np.int32), server.caches)
    assert step.step.captures == 0 and step.step.warmups == 0
    for a, b in zip(before, _tree(server.caches)):
        assert torch.equal(a, b)


def _tree(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree(v)
    else:
        yield tree


def _serve(server, prompts, max_new=5):
    for rid, p in enumerate(prompts):
        server.submit(Request(rid=rid, prompt=p, max_new=max_new))
    ticks = server.run_until_drained()
    return ticks, {r.rid: r.out for r in server.completed}


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-7b"])
def test_wrapper_gives_the_plain_steps_tokens_over_a_server_run(arch):
    """Prompts of 5, 11, 3 and 9 tokens, prefill chunk 4, 2 slots (so both
    are recycled); zamba2 in the recurrent mode feeds its prompt tails one
    token at a time through the decode-shaped step.  The wrapper serves
    with exactly two shapes, each warmed up once; the uncaptured body from
    ``info`` gives the same tokens in the same ticks."""
    rng = np.random.default_rng(5)
    cfg, server, info = _server(arch)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in (5, 11, 3, 9)]
    assert server.cfg.recurrent == (arch == "zamba2-7b")
    ticks, got = _serve(server, prompts)
    step = server.step_fn.step
    assert sorted(step.shapes) == sorted(
        [((1, 4), (1,), (1, 8)) + (((1,),) if server.cfg.recurrent else ()),
         ((2, 1), (2,), (2, 8)) + (((2,),) if server.cfg.recurrent else ())])
    assert step.captures == 2 and step.warmups == 2

    _, plain, _ = _server(arch)
    plain.step_fn = plain.step_fn.uncaptured()
    plain_ticks, want = _serve(plain, prompts)
    assert plain.step_fn.step.captures == 0
    assert len(got) == len(prompts) and got == want
    assert ticks == plain_ticks
    assert server.alloc.free_pages == GEOM["num_pages"] - 1


def test_wrapper_rebinds_when_handed_new_caches():
    """New caches (a new ``init_caches()``, as ``Server.reshape`` makes)
    drop the shapes bound to the old ones: the next call warms up and
    captures again, on the new tensors, and gives the plain body's
    tokens."""
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), num_layers=2)
    step, info = build_paged_step(cfg, atp_topo(1, 1, 1), device="cpu")
    params = lm.shard_params(cfg, lm.init_params(cfg, dtype=torch.float32,
                                                 device="cpu"), info.ctx)
    pcfg = PagedConfig(**GEOM)

    def caches():
        return lm.init_paged_caches(cfg, info.ctx, pcfg, device="cpu")

    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (1, 4), dtype=np.int32)
    table = np.zeros((1, GEOM["pages_per_slot"]), np.int32)
    table[0, :2] = [1, 2]
    start = np.array([0], np.int32)
    first = caches()
    got, _ = step(params, tokens, start, table, first)
    got_again, _ = step(params, tokens, start, table, first)
    assert step.captures == 1
    second = caches()
    got_new, _ = step(params, tokens, start, table, second)
    assert step.captures == 2 and step.warmups == 2
    assert step.binding == [(t.data_ptr(), tuple(t.shape)) for t in
                            _tree({"params": params, "caches": second})]
    want, _ = info.plain(params, *(torch.from_numpy(a) for a in
                                   (tokens, start, table)), caches())
    for g in (got, got_again, got_new):
        np.testing.assert_array_equal(g, want.numpy())
    # each call wrote its own caches: the first pair the first, the third
    # the second
    for a, b in zip(_tree(first), _tree(second)):
        assert b[:, 1:3].abs().sum() > 0
        assert torch.equal(a[:, 1:3], b[:, 1:3])


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-7b"])
def test_warm_up_leaves_every_pool_row_but_the_garbage_page(arch):
    """Serve two requests, so that pages and slot states hold live values,
    then hand the step a shape it has not seen: its warm-up writes nothing
    but the garbage page."""
    rng = np.random.default_rng(8)
    cfg, server, _ = _server(arch)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in (9, 6)]
    _serve(server, prompts, max_new=3)
    before = {k: t.clone() for k, t in _named(server.caches)}
    assert any(t.abs().sum() > 0 for t in before.values())
    step = server.step_fn
    key = ((3, 1), (3,), (3, GEOM["pages_per_slot"]))
    if server.cfg.recurrent:
        key += ((3,),)
    shapes = step.step.captures
    step.step._capture(key, step.params, server.caches)
    assert step.step.captures == shapes + 1
    for k, t in _named(server.caches):
        if k.endswith("/k") or k.endswith("/v"):
            # [layers, pages, page, heads, hd]: page 0 is the garbage page
            keep = [p for p in range(t.shape[1]) if p != GARBAGE_PAGE]
            assert torch.equal(t[:, keep], before[k][:, keep]), k
        else:
            assert torch.equal(t, before[k]), k


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v
