"""The port's quantized page pools (int8 and fp8 with fp16 per-position
scales) against the reference's, on the CPU.

  - ``paging.quantize_tokens``, ``append_tokens_q`` and ``gather_pages_q``
    give the reference's pools and dequantized reads bit for bit on the
    same seeded inputs (every row's amax element lands on the grid's
    largest value, a zero row on a zero scale);
  - the teacher-forced trace of the reference's
    ``test_paged_decode_quant_greedy_parity`` (reduced llama3-8b, fp32
    weights, fp32 model dtype): the port's logits through int8 and fp8
    pools within 1e-4 of the reference's through the same pools;
  - ``lm.init_paged_caches`` makes the reference's leaves, and so its
    bytes ratio against a bf16 pool;
  - reduced zamba2-7b serves the reference's tokens through int8 pools
    (its shared block's pools are quantized, its state pools are not);
  - a captured step's warm-up writes only the garbage page of every pool,
    the scale pools included.
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
from repro.core.mesh import atp_topo as jax_atp_topo  # noqa: E402
from repro.launch.serve import make_paged_server as jax_server  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import paging as jax_paging  # noqa: E402
from repro.runtime.server import Request as JaxRequest  # noqa: E402
from repro.runtime.server import ServerConfig as JaxServerConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_config as port_config  # noqa: E402
from repro_torch.core.atp import make_context  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import lm, paging  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.runtime.server import Request, ServerConfig  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
QUANT = ["int8", "fp8"]
TOPO1 = JaxMeshTopo((("data", 1),))


def _bits(a) -> np.ndarray:
    """The bytes of a pool (numpy from either side) as unsigned ints."""
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _port_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.float8_e4m3fn:
        t = t.view(torch.uint8)
    elif t.dtype == torch.float16:
        t = t.view(torch.int16)
    return _bits(t.numpy())


@pytest.mark.parametrize("page_dtype", QUANT)
def test_quantized_pools_are_the_references_bit_for_bit(page_dtype):
    rng = np.random.default_rng(3)
    b, s, kv, hd, pg, mp = 2, 7, 2, 32, 4, 4
    # rows over many magnitudes, and a zero row (its scale underflows to 0)
    vals = (rng.standard_normal((b, s, kv, hd))
            * 10.0 ** rng.uniform(-3, 3, (b, s, kv, 1))).astype(np.float32)
    vals[1, 2, 0] = 0.0
    table = np.array([[3, 1, 6, 0], [2, 5, 4, 0]], np.int32)
    start = np.array([1, 5], np.int32)
    npages = 8

    jp = jnp.zeros((npages, pg, kv, hd),
                   jax_paging.page_store_dtype(page_dtype))
    js = jnp.zeros((npages, pg, kv), jnp.float16)
    jp, js = jax_paging.append_tokens_q(jp, js, jnp.asarray(table),
                                        jnp.asarray(start),
                                        jnp.asarray(vals), page_dtype)
    tp = torch.zeros((npages, pg, kv, hd),
                     dtype=paging.page_store_dtype(page_dtype))
    ts = torch.zeros((npages, pg, kv), dtype=torch.float16)
    paging.append_tokens_q(tp, ts, torch.from_numpy(table),
                           torch.from_numpy(start), torch.from_numpy(vals),
                           page_dtype)
    assert paging.pool_page_dtype(tp) == page_dtype
    np.testing.assert_array_equal(_port_bits(tp), _bits(jp))
    np.testing.assert_array_equal(_port_bits(ts), _bits(js))
    # every row's amax element sits on the grid's largest value
    q, _ = paging.quantize_tokens(torch.from_numpy(vals), page_dtype)
    top = q.float().abs().amax(-1)
    assert bool((top[np.abs(vals).max(-1) > 0] ==
                 (127.0 if page_dtype == "int8" else 448.0)).all())
    for out in (jnp.float32, jnp.bfloat16):
        want = jax_paging.gather_pages_q(jp, js, jnp.asarray(table),
                                         out_dtype=out)
        got = paging.gather_pages_q(
            tp, ts, torch.from_numpy(table),
            out_dtype=torch.float32 if out == jnp.float32 else torch.bfloat16)
        np.testing.assert_array_equal(
            _port_bits(got.float()), _bits(np.asarray(want, np.float32)))


def _jax_teacher_forced(cfg, params, tokens, pcfg):
    """The reference's teacher-forced trace of
    ``test_paged_decode_quant_greedy_parity``: every position fed through
    its paged step.  Returns the logits [B, S, V] and the caches (numpy)
    before each step and after the last."""
    B, S = tokens.shape
    mesh = TOPO1.build(jax.devices()[:1])
    ctx = jax_make_context(TOPO1)
    alloc = jax_paging.PageAllocator(pcfg, slots=B)
    caches, _ = jax_lm.init_paged_caches(cfg, ctx, pcfg, dtype=jnp.float32)

    def step(p, tok, start, table, caches):
        return jax_lm.paged_step(ctx, cfg, p, tok, start, table, caches)

    g = jax.jit(shard_map(step, mesh=mesh,
                          in_specs=(P(), P(), P(), P(), P()),
                          out_specs=(P(), P()), check_vma=True))
    outs, pools = [], [jax.tree.map(np.asarray, caches)]
    for t in range(S):
        for s in range(B):
            alloc.ensure(s, t + 1)
        start = jnp.full((B,), t, jnp.int32)
        logits, caches = g(params, jnp.asarray(tokens[:, t:t + 1]), start,
                           jnp.asarray(alloc.table()), caches)
        outs.append(np.asarray(logits[:, 0]))
        pools.append(jax.tree.map(np.asarray, caches))
    return np.stack(outs, axis=1), pools


def _to_port(a: np.ndarray) -> torch.Tensor:
    if a.dtype.itemsize == 1 and a.dtype != np.int8:       # fp8
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix: tree}


@pytest.mark.parametrize("page_dtype", QUANT)
def test_teacher_forced_logits_through_quantized_pools(page_dtype):
    """Each step of the port starts from the reference's pools before that
    step (a one-level rounding flip of one element, from fp32 sums taken
    in another order, would otherwise reach every later position) and
    must give the reference's logits within 1e-4 and write the reference's
    pools, but where an element of this step's k/v lies on a rounding
    boundary: there the two differ by one quantization level, and that
    step's logits are not compared."""
    cfg = get_config("llama3-8b").reduced()
    params = jax_lm.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    B, S = 2, 112
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                         cfg.vocab_size), np.int32)
    geom = dict(page_size=8, num_pages=2 * (S // 8 + 1) + 2,
                pages_per_slot=S // 8 + 1)
    want, pools = _jax_teacher_forced(
        cfg, params, tokens,
        jax_paging.PagedConfig(page_dtype=page_dtype, **geom))
    pcfg_port = port_config("llama3-8b").reduced()
    tparams = convert.params_from_jax(cfg, jax.tree.map(np.asarray, params),
                                      atp_topo(1, 1, 1), 0)
    pcfg = paging.PagedConfig(page_dtype=page_dtype, **geom)
    ctx = make_context(atp_topo(1, 1, 1), device_type="cpu")
    alloc = paging.PageAllocator(pcfg, B)
    caches = lm.init_paged_caches(pcfg_port, ctx, pcfg, dtype=torch.float32,
                                  device="cpu")
    port = _flat(caches)
    flips, compared = 0, 0
    with torch.no_grad():
        for t in range(S):
            for key, a in _flat(pools[t]).items():
                port[key].copy_(_to_port(a))
            for s in range(B):
                alloc.ensure(s, t + 1)
            logits, _ = lm.paged_step(
                ctx, pcfg_port, tparams, torch.from_numpy(tokens[:, t:t + 1]),
                torch.full((B,), t, dtype=torch.int32),
                torch.from_numpy(alloc.table()), caches)
            step_flips = 0
            for key, a in _flat(pools[t + 1]).items():
                got, ref = _port_bits(port[key]), _bits(a)
                diff = got != ref
                step_flips += int(diff.sum())
                # where they differ, by one level: adjacent codes (int8
                # values, fp8 or fp16 magnitudes) of one sign
                if page_dtype == "int8" and not key.endswith("_scale/"):
                    got, ref = got.view(np.int8), ref.view(np.int8)
                else:
                    sign = 0x80 if got.itemsize == 1 else 0x8000
                    assert not ((got ^ ref) & sign)[diff].any(), (t, key)
                assert (np.abs(got.astype(np.int32) - ref.astype(np.int32))
                        [diff] == 1).all(), (t, key)
            if step_flips:
                flips += step_flips
                continue
            compared += 1
            np.testing.assert_allclose(logits[:, 0].numpy(), want[:, t],
                                       **TOL, err_msg=f"step {t}")
    print(f"{compared} of {S} steps compared, {flips} elements one level "
          f"apart")
    assert compared >= 0.9 * S, (compared, flips)


def _nbytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-7b"])
def test_quantized_caches_are_the_references_leaves(arch):
    """The same leaves, shapes and bytes as the reference's caches, so the
    bytes ratio against a bf16 pool is the reference's (at least 1.8x for
    llama3-8b's pools, the reference's ``test_quant_pool_bytes_ratio``)."""
    cfg = get_config(arch).reduced()
    jctx = jax_make_context(jax_atp_topo(1, 1, 1))
    ctx = make_context(atp_topo(1, 1, 1), device_type="cpu")
    geom = dict(page_size=8, num_pages=32, pages_per_slot=8)
    slots = 2 if lm.is_recurrent(cfg) else None
    nbytes = {}
    for pd in paging.PAGE_DTYPES:
        want = jax.eval_shape(lambda: jax_lm.init_paged_caches(
            cfg, jctx, jax_paging.PagedConfig(page_dtype=pd, **geom),
            dtype=jnp.bfloat16, slots=slots)[0])
        got = lm.init_paged_caches(port_config(arch).reduced(), ctx,
                                   paging.PagedConfig(page_dtype=pd, **geom),
                                   dtype=torch.bfloat16, device="cpu",
                                   slots=slots)
        flat_want = {jax.tree_util.keystr(k): v for k, v in
                     jax.tree_util.tree_leaves_with_path(want)}
        flat_got = {jax.tree_util.keystr(k): v for k, v in
                    jax.tree_util.tree_leaves_with_path(got)}
        assert sorted(flat_got) == sorted(flat_want)
        for k, v in flat_want.items():
            t = flat_got[k]
            assert tuple(t.shape) == tuple(v.shape), k
            assert t.element_size() == np.dtype(v.dtype).itemsize, k
        assert sum(t.numel() * t.element_size() for t in
                   flat_got.values()) == _nbytes(want)
        nbytes[pd] = _nbytes(want)
    for pd in QUANT:
        ratio = nbytes["bf16"] / nbytes[pd]
        assert ratio >= (1.8 if arch == "llama3-8b" else 1.0), ratio


def test_zamba_serves_the_references_tokens_through_int8_pools():
    cfg = get_config("zamba2-7b").reduced()
    params = jax_lm.init_params(cfg, jax.random.PRNGKey(2), jnp.float32)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in (9, 4, 11, 6)]
    geom = dict(page_size=4, num_pages=24, pages_per_slot=8,
                page_dtype="int8")
    js, _ = jax_server(cfg, JaxServerConfig(
        batch_slots=2, prefill_chunk=4,
        paged=jax_paging.PagedConfig(**geom)), params,
        topo=jax_atp_topo(1, 1, 1))
    ps, _ = serve.make_paged_server(
        port_config("zamba2-7b").reduced(),
        ServerConfig(batch_slots=2, prefill_chunk=4,
                     paged=paging.PagedConfig(**geom)),
        convert.tree_to_torch(jax.tree.map(np.asarray, params)),
        topo=atp_topo(1, 1, 1), device="cpu")
    assert ps.cfg.recurrent
    for rid, p in enumerate(prompts):
        js.submit(JaxRequest(rid=rid, prompt=p, max_new=5))
        ps.submit(Request(rid=rid, prompt=p, max_new=5))
    assert ps.run_until_drained() == js.run_until_drained()
    assert ({r.rid: r.out for r in ps.completed}
            == {r.rid: r.out for r in js.completed})
    int8 = [t for t in tree_leaves(ps.caches)
            if t.dtype == torch.int8]
    assert len(int8) == 2      # the shared block's k and v pools
    assert ps.stats()["cache_bytes"] == js.stats()["cache_bytes"]


@pytest.mark.parametrize("page_dtype", paging.PAGE_DTYPES)
def test_a_warm_up_writes_only_the_garbage_page(page_dtype):
    """The captured step's warm-up (every table entry the garbage page)
    and a call fed the same leave every other page of the k/v pools and
    the scale pools as they were: there is nothing for a guard to save."""
    cfg = port_config("llama3-8b").reduced()
    ctx = make_context(atp_topo(1, 1, 1), device_type="cpu")
    params = lm.shard_params(cfg, lm.init_params(cfg, seed=1, device="cpu"),
                             ctx)
    pcfg = paging.PagedConfig(page_size=4, num_pages=6, pages_per_slot=4,
                              page_dtype=page_dtype)
    caches = lm.init_paged_caches(cfg, ctx, pcfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for t in tree_leaves(caches):
        t.copy_((torch.randn(t.shape, generator=gen) * 3).to(t.dtype))
    before = [t.clone() for t in tree_leaves(caches)]
    step, _ = steps.build_paged_step(cfg, atp_topo(1, 1, 1), device="cpu")
    toks = np.arange(8, dtype=np.int32).reshape(1, 8)
    step(params, toks, np.zeros(1, np.int32), np.zeros((1, 4), np.int32),
         caches)
    assert step.warmups == 1
    for old, new in zip(before, tree_leaves(caches)):
        assert torch.equal(old[:, 1:].view(torch.uint8)
                           if old.dtype == torch.float8_e4m3fn else
                           old[:, 1:],
                           new[:, 1:].view(torch.uint8)
                           if new.dtype == torch.float8_e4m3fn else
                           new[:, 1:])
