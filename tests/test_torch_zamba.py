"""The port's zamba2 path (Mamba2 blocks, the shared attention block and
the per-slot recurrent state pools) against the JAX package on the same
weights.

zamba2-7b ``.reduced()`` with 5 layers: two super-blocks (shared attention
+ one Mamba2 block each) and a tail segment of one Mamba2 block, so both
recurrent segment kinds run.  Weights come from the JAX ``lm.init_params``
and cross as numpy through ``repro_torch.convert.params_from_jax``; tokens
are made from a seed with numpy.  fp32 on the CPU, where the port's
kernels take their plain versions; tolerance 1e-4 (relative and absolute):
the two sides sum in different orders, nothing else differs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.core.atp import make_context as jax_make_context  # noqa: E402
from repro.core.compat import shard_map  # noqa: E402
from repro.core.mesh import MeshTopo as JaxMeshTopo  # noqa: E402
from repro.core.mesh import atp_topo as jax_atp_topo  # noqa: E402
from repro.launch.serve import make_paged_server as jax_server  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models.paging import PagedConfig  # noqa: E402
from repro.runtime.server import Request, ServerConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import segments  # noqa: E402
from repro_torch.configs.registry import get_config as port_config  # noqa: E402
from repro_torch.core.atp import make_context  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.paging import PageAllocator  # noqa: E402
from repro_torch.models.paging import PagedConfig as PortPagedConfig  # noqa: E402
from repro_torch.runtime.server import Request as PortRequest  # noqa: E402
from repro_torch.runtime.server import ServerConfig as PortServerConfig  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "zamba2-7b"
LAYERS = 5
SLOTS = 3
GEOM = dict(page_size=4, num_pages=32, pages_per_slot=10)
JAX_TOPO = JaxMeshTopo((("data", 1),))


def _cfgs():
    return (dataclasses.replace(get_config(ARCH).reduced(), num_layers=LAYERS),
            dataclasses.replace(port_config(ARCH).reduced(), num_layers=LAYERS))


def test_reduced_zamba_runs_both_recurrent_segment_kinds():
    _, pcfg = _cfgs()
    assert [(s.kind, s.count, s.inner) for s in segments(pcfg)] == \
        [("zamba", 2, 2), ("mamba", 1, 1)]


def test_unported_kinds_raise_naming_the_roadmap_item():
    cfg = port_config("xlstm-1.3b").reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        lm.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="slots="):
        lm.init_paged_caches(_cfgs()[1], make_context(atp_topo(1, 1, 1),
                                                      device_type="cpu"),
                             PortPagedConfig(**GEOM), device="cpu")


def test_init_params_matches_jax_tree_for_zamba():
    """Same keys, shapes and per-leaf dtypes as the JAX tree in a bf16
    model: the Mamba2 ``conv``, ``A_log``, ``D``, ``dt_bias``, ``ln`` and
    ``gn`` stay fp32; a zamba segment stacks ``[count, inner-1, ...]``."""
    cfg, pcfg = _cfgs()
    want = jax.tree.map(lambda x: (x.shape, str(x.dtype)),
                        jax_lm.abstract_params(cfg))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]),
                       lm.init_params(pcfg, seed=0, device="cpu"))
    assert got == want


def _jax_step(cfg):
    ctx = jax_make_context(JAX_TOPO)

    def step(p, tok, start, table, slot, caches):
        return jax_lm.paged_step(ctx, cfg, p, tok, start, table, caches,
                                 slot=slot)

    return jax.jit(shard_map(step, mesh=JAX_TOPO.build(jax.devices()[:1]),
                             in_specs=(P(),) * 6, out_specs=(P(), P()),
                             check_vma=True))


def _schedule(vocab):
    """(tokens, start, table, slot, live rows) of each step: chunked
    prefill that carries the state (slot 0 at 0 and 4; a 32-token chunk,
    two SSD chunks, for slot 2), a mixed decode tick (slot 1 fed, slot 0
    at 8, row 2 a sentinel), a tick with two sentinel rows, then slot 0
    recycled for a new request whose state must read as zeros."""
    rng = np.random.default_rng(4)
    toks = rng.integers(0, vocab, (SLOTS, 40), dtype=np.int32)
    alloc = PageAllocator(PortPagedConfig(**GEOM), SLOTS)
    alloc.ensure(0, 10)
    alloc.ensure(1, 5)
    alloc.ensure(2, 32)
    steps = []

    def add(tok, start, rows, slot, live):
        table = alloc.table()[rows]
        table[[i for i, s in enumerate(slot) if s == SLOTS]] = 0
        steps.append((np.asarray(tok, np.int32), np.asarray(start, np.int32),
                      table, np.asarray(slot, np.int32), live))

    add(toks[0:1, 0:4], [0], [0], [0], [0])
    add(toks[0:1, 4:8], [4], [0], [0], [0])
    add(toks[1:2, 0:4], [0], [1], [1], [0])
    add(toks[2:3, 0:32], [0], [2], [2], [0])
    add(toks[[0, 1, 2], 8:9], [8, 4, 0], [0, 1, 2], [0, 1, SLOTS], [0, 1])
    add(toks[[0, 1, 2], 9:10], [9, 0, 0], [0, 1, 2], [0, SLOTS, SLOTS], [0])
    alloc.release(0)
    alloc.ensure(0, 4)
    add(toks[2:3, 0:4], [0], [0], [0], [0])     # recycled slot 0
    return steps


def test_paged_step_matches_jax_with_slot_pools():
    cfg, pcfg = _cfgs()
    params = jax_lm.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    steps = _schedule(cfg.vocab_size)
    g = _jax_step(cfg)
    jcaches, _ = jax_lm.init_paged_caches(cfg, jax_make_context(JAX_TOPO),
                                          PagedConfig(**GEOM),
                                          dtype=jnp.float32, slots=SLOTS)
    ctx = make_context(atp_topo(1, 1, 1), device_type="cpu")
    tparams = convert.params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                      atp_topo(1, 1, 1), 0)
    caches = lm.init_paged_caches(pcfg, ctx, PortPagedConfig(**GEOM),
                                  dtype=torch.float32, device="cpu",
                                  slots=SLOTS)
    got_all = []
    for i, (tok, start, table, slot, live) in enumerate(steps):
        want, jcaches = g(params, tok, start, table, slot, jcaches)
        with torch.no_grad():
            got, caches = lm.paged_step(
                ctx, pcfg, tparams, torch.from_numpy(tok),
                torch.from_numpy(start), torch.from_numpy(table), caches,
                slot=torch.from_numpy(slot))
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   **TOL, err_msg=f"step {i}")
        got_all.append(got.numpy())
    # the recycled slot's first chunk equals slot 2's first 4 tokens, fed
    # at the same positions from zero state
    np.testing.assert_allclose(got_all[-1][0], got_all[3][0, :4], **TOL)
    # and the state pools agree (the sentinel rows wrote nothing)
    for seg in ("seg0", "seg1"):
        want_pool = jcaches[seg]["mamba"] if seg == "seg0" else jcaches[seg]
        got_pool = caches[seg]["mamba"] if seg == "seg0" else caches[seg]
        for k in ("conv_x", "conv_bc", "ssd"):
            np.testing.assert_allclose(got_pool[k].numpy(),
                                       np.asarray(want_pool[k]), **TOL,
                                       err_msg=f"{seg}/{k}")


def test_state_put_drops_the_sentinel_rows():
    """A row whose slot id is the sentinel leaves every pool row as it was;
    a live row with start 0 reads zeros whatever its pool row holds."""
    pool = {"ssd": torch.arange(3 * 2, dtype=torch.float32).reshape(3, 2)}
    sm = lm.slot_map(torch.tensor([3, 1]), torch.tensor([5, 0]), 3)
    rows = lm._state_take(pool, sm)
    np.testing.assert_array_equal(rows["ssd"].numpy(), [[4, 5], [0, 0]])
    lm._state_put(pool, {"ssd": torch.full((2, 2), -1.0)}, sm)
    np.testing.assert_array_equal(pool["ssd"].numpy(),
                                  [[0, 1], [-1, -1], [4, 5]])


def test_slot_map_refuses_a_live_slot_twice():
    """Two live rows on one slot would both write its pool rows; sentinel
    rows may repeat."""
    with pytest.raises(ValueError, match="appears twice"):
        lm.slot_map(torch.tensor([1, 3, 1]), torch.tensor([5, 0, 2]), 3)
    sm = lm.slot_map(torch.tensor([3, 3, 0]), torch.tensor([5, 0, 2]), 3)
    assert sm.slot.dtype == torch.int32
    np.testing.assert_array_equal(sm.rows.numpy(), [2])
    np.testing.assert_array_equal(sm.put.numpy(), [0])


def test_port_server_greedy_tokens_match_jax_server_recurrent():
    """Recurrent mode on both sides: prompts of 5, 11, 3 and 9 tokens with
    prefill chunk 4 leave tails of 1, 3, 3 and 1 tokens, fed one at a time
    through the decode-shaped step; 2 slots, so slots are recycled.
    fp32 weights, each server's default bf16 pools."""
    cfg, pcfg = _cfgs()
    params = jax_lm.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    np_params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in (5, 11, 3, 9)]
    max_new = 5
    geom = dict(page_size=4, num_pages=40, pages_per_slot=8)
    jserver, _ = jax_server(
        cfg, ServerConfig(batch_slots=2, prefill_chunk=4,
                          paged=PagedConfig(**geom)),
        params, topo=jax_atp_topo(1, 1, 1))
    pserver, _ = port_serve.make_paged_server(
        pcfg, PortServerConfig(batch_slots=2, prefill_chunk=4,
                               paged=PortPagedConfig(**geom),
                               prefix_cache=True),
        convert.tree_to_torch(np_params), topo=atp_topo(1, 1, 1),
        device="cpu")
    assert jserver.cfg.recurrent and pserver.cfg.recurrent
    assert not pserver.cfg.prefix_cache   # switched off, as in JAX
    for rid, p in enumerate(prompts):
        jserver.submit(Request(rid=rid, prompt=p, max_new=max_new))
        pserver.submit(PortRequest(rid=rid, prompt=p, max_new=max_new))
    jticks = jserver.run_until_drained()
    pticks = pserver.run_until_drained()

    want = {r.rid: r.out for r in jserver.completed}
    got = {r.rid: r.out for r in pserver.completed}
    assert len(got) == len(prompts)
    assert all(len(o) == max_new for o in got.values())
    assert got == want
    assert pticks == jticks
    assert pserver.alloc.free_pages == geom["num_pages"] - 1
