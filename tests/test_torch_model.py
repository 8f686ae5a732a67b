"""The port's paged model against the JAX package on the same weights.

Weights come from the JAX ``lm.init_params`` and cross as numpy through
``repro_torch.convert.params_from_jax``; tokens are made from a seed with
numpy.  Everything runs in fp32 on the CPU, where the port's kernels take
their plain versions.  Tolerance 1e-4 (relative and absolute): the two
sides sum in different orders, nothing else differs.
"""
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
from repro.models import lm as jax_lm  # noqa: E402
from repro.models.paging import PageAllocator, PagedConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.atp import make_context  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.configs.registry import get_config as port_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.paging import PagedConfig as PortPagedConfig  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["llama3-8b", "qwen1.5-0.5b", "gemma2-2b", "qwen3-8b"]
JAX_TOPO = JaxMeshTopo((("data", 1),))
PCFG = dict(page_size=4, num_pages=16, pages_per_slot=4)


def jax_params(arch):
    cfg = get_config(arch).reduced()
    params = jax_lm.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    if cfg.qkv_bias:  # zero at init: give the bias path something to add
        rng = np.random.default_rng(1)
        seg = params["seg0"]["attn"]
        for k in ("bq", "bk", "bv"):
            seg[k] = jnp.asarray(rng.normal(size=seg[k].shape) * 0.1,
                                 jnp.float32)
    return cfg, params


def jax_step(cfg):
    mesh = JAX_TOPO.build(jax.devices()[:1])
    ctx = jax_make_context(JAX_TOPO)

    def step(p, tok, start, table, caches):
        return jax_lm.paged_step(ctx, cfg, p, tok, start, table, caches)

    return jax.jit(shard_map(step, mesh=mesh, in_specs=(P(),) * 5,
                             out_specs=(P(), P()), check_vma=True))


def port_setup(arch, params):
    pcfg = port_config(arch).reduced()
    ctx = make_context(atp_topo(1, 1, 1), device_type="cpu")
    tparams = convert.params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                      atp_topo(1, 1, 1), 0)
    caches = lm.init_paged_caches(pcfg, ctx, PortPagedConfig(**PCFG),
                                  dtype=torch.float32, device="cpu")
    return pcfg, ctx, tparams, caches


def port_step(pcfg, ctx, tparams, tok, start, table, caches):
    with torch.no_grad():
        return lm.paged_step(ctx, pcfg, tparams, torch.as_tensor(tok),
                             torch.as_tensor(start), torch.as_tensor(table),
                             caches)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_chunks_match_jax(arch):
    """b=1 chunked prefill through the page pool, chunk by chunk."""
    cfg, params = jax_params(arch)
    S, C = 12, 4
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, S),
                                               dtype=np.int32)
    pcfg_j = PagedConfig(**PCFG)
    alloc = PageAllocator(pcfg_j, slots=1)
    alloc.ensure(0, S)
    table = alloc.table()
    caches_j, _ = jax_lm.init_paged_caches(cfg, jax_make_context(JAX_TOPO),
                                           pcfg_j, dtype=jnp.float32)
    g = jax_step(cfg)
    pcfg, ctx, tparams, caches = port_setup(arch, params)
    for c0 in range(0, S, C):
        start = np.array([c0], np.int32)
        want, caches_j = g(params, tokens[:, c0:c0 + C], start, table, caches_j)
        got, caches = port_step(pcfg, ctx, tparams, tokens[:, c0:c0 + C],
                                start, table, caches)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_mixed_lengths_match_jax(arch):
    """Two slots at independent lengths decode one token per tick; slot 1
    stops early and its rows route to the garbage page (the JAX package's
    test_decode mixed-length schedule)."""
    cfg, params = jax_params(arch)
    B, S = 2, 10
    S1 = S - 4
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S),
                                               dtype=np.int32)
    pcfg_j = PagedConfig(**PCFG)
    alloc = PageAllocator(pcfg_j, slots=B)
    caches_j, _ = jax_lm.init_paged_caches(cfg, jax_make_context(JAX_TOPO),
                                           pcfg_j, dtype=jnp.float32)
    g = jax_step(cfg)
    pcfg, ctx, tparams, caches = port_setup(arch, params)
    for t in range(S):
        live1 = t < S1
        alloc.ensure(0, t + 1)
        if live1:
            alloc.ensure(1, t + 1)
        tok = np.zeros((B, 1), np.int32)
        tok[0, 0] = tokens[0, t]
        tok[1, 0] = tokens[1, t] if live1 else 0
        start = np.array([t, t if live1 else 0], np.int32)
        table = alloc.table()
        if not live1:
            table[1, :] = 0
        want, caches_j = g(params, tok, start, table, caches_j)
        got, caches = port_step(pcfg, ctx, tparams, tok, start, table, caches)
        rows = slice(None) if live1 else slice(0, 1)
        np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                                   **TOL)


def test_params_from_jax_fuses_per_rank_shards():
    """On a (1, 2, 2) mesh each rank's fused q/k/v weight is its wq, wk, wv
    shards side by side, cut by P(tp2, tp1); the row weight by P(tp1, tp2)."""
    cfg, params = jax_params("qwen1.5-0.5b")
    np_params = jax.tree.map(np.asarray, params)
    topo = atp_topo(1, 2, 2)
    a = np_params["seg0"]["attn"]
    h, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    for rank in range(4):
        i1, i2 = rank // 2, rank % 2
        got = convert.params_from_jax(port_config("qwen1.5-0.5b").reduced(),
                                      np_params, topo, rank)
        rows = slice(i2 * h // 2, (i2 + 1) * h // 2)
        want = np.concatenate(
            [a[k][:, rows, i1 * n // 2:(i1 + 1) * n // 2]
             for k, n in (("wq", qd), ("wk", kvd), ("wv", kvd))], axis=-1)
        np.testing.assert_array_equal(got["seg0"]["attn"]["w_qkv"].numpy(), want)
        np.testing.assert_array_equal(
            got["seg0"]["attn"]["wo"].numpy(),
            a["wo"][:, i1 * qd // 2:(i1 + 1) * qd // 2, rows])
        np.testing.assert_array_equal(
            got["seg0"]["attn"]["b_qkv"].numpy(),
            np.concatenate([a[k][:, i1 * n // 2:(i1 + 1) * n // 2]
                            for k, n in (("bq", qd), ("bk", kvd), ("bv", kvd))],
                           axis=-1))
        np.testing.assert_array_equal(
            got["embed"].numpy(),
            np_params["embed"][i1 * cfg.vocab_size // 2:(i1 + 1) * cfg.vocab_size // 2,
                               rows])


def test_init_params_matches_jax_tree_and_scales():
    """The port's own initializer makes the JAX tree (same keys, shapes)
    with the same distributions: check keys, shapes and each weight's
    standard deviation against its scale."""
    cfg = get_config("llama3-8b").reduced()
    want = jax.tree.map(lambda x: (x.shape, str(x.dtype)),
                        jax_lm.abstract_params(cfg, jnp.float32))
    got_t = lm.init_params(port_config("llama3-8b").reduced(), seed=0,
                           dtype=torch.float32, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), "float32"), got_t)
    assert got == want
    attn = got_t["seg0"]["attn"]
    assert abs(float(attn["wq"].std()) * cfg.d_model ** 0.5 - 1) < 0.05
    assert abs(float(got_t["embed"].std()) / 0.02 - 1) < 0.05
    assert float(got_t["final_norm"]["scale"].min()) == 1.0
