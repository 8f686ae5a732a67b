"""The port's prefix-cached paged server against the reference's, on the
CPU, on the reference's own serve-smoke workload
(``repro.launch.serve_smoke``, step 6: four prompts behind a shared
8-token system prompt, 3 slots, chunks and pages of 4): the same greedy
tokens, ticks and ``prefix_hit_rate``, and at every tick the same
``pages_shared`` and free pages (the copy-on-write pages each side maps).
fp32 weights from the reference's ``init_params``; each server's default
(bf16) pools.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.core.mesh import atp_topo as jax_atp_topo  # noqa: E402
from repro.launch.serve import make_paged_server as jax_server  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models.paging import PagedConfig as JaxPagedConfig  # noqa: E402
from repro.runtime.server import Request as JaxRequest  # noqa: E402
from repro.runtime.server import ServerConfig as JaxServerConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_config as port_config  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.paging import PagedConfig  # noqa: E402
from repro_torch.runtime.server import Request, ServerConfig  # noqa: E402

MAX_NEW = 6


def smoke_workload(vocab: int, n: int = 4):
    """``serve_smoke``'s prefix prompts and pool: its rng (seed 0) draws
    the mixed-length prompts, then the zamba prompts of its step 4, then
    the system prompt, which the first ``n`` prompts follow (the smoke's
    own: 4)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, size=k, dtype=np.int32)
               for k in (10, 7, 3, 12, 5, 9)]
    zvocab = get_config("zamba2-7b").reduced().vocab_size
    for k in (9, 4, 11, 6):
        rng.integers(0, zvocab, size=k, dtype=np.int32)
    system = rng.integers(0, vocab, size=8, dtype=np.int32)
    pprompts = [np.concatenate([system, p]) for p in prompts[:n]]
    pool = 1 + sum(-(-(len(p) + MAX_NEW) // 4) for p in pprompts)
    return pprompts, dict(page_size=4, num_pages=pool, pages_per_slot=8)


def lockstep(servers, prompts, max_new=MAX_NEW):
    """Submit ``prompts`` to every server, then tick them together until
    all drain.  Returns, per server, (tokens by rid, ticks, the stats after
    each tick)."""
    for s, req in servers:
        for rid, p in enumerate(prompts):
            s.submit(req(rid=rid, prompt=p, max_new=max_new))
    trace = [[] for _ in servers]
    for _ in range(500):
        if not any(s.busy for s, _ in servers):
            break
        for (s, _), t in zip(servers, trace):
            if s.busy:
                s.step()
            st = s.stats()
            t.append((st["pages_shared"], st["free_pages"], st["live_tokens"]))
    assert not any(s.busy for s, _ in servers), "the servers did not drain"
    return [({r.rid: r.out for r in s.completed}, s.ticks, t)
            for (s, _), t in zip(servers, trace)]


@pytest.mark.parametrize("arch,n", [("qwen1.5-0.5b", 4), ("llama3-8b", 6),
                                    ("gemma2-2b", 6)])
def test_prefix_server_matches_the_reference_tick_by_tick(arch, n):
    """The smoke's own 4 requests, and 6 behind the system prompt, so that
    the last 3, admitted together after the first 3 registered it, map
    its pages at once."""
    cfg = get_config(arch).reduced()
    params = jax_lm.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    prompts, geom = smoke_workload(cfg.vocab_size, n)
    js, _ = jax_server(cfg, JaxServerConfig(
        batch_slots=3, prefill_chunk=4, paged=JaxPagedConfig(**geom),
        prefix_cache=True), params, topo=jax_atp_topo(1, 1, 1))
    ps, _ = serve.make_paged_server(
        port_config(arch).reduced(),
        ServerConfig(batch_slots=3, prefill_chunk=4,
                     paged=PagedConfig(**geom), prefix_cache=True),
        convert.tree_to_torch(jax.tree.map(np.asarray, params)),
        topo=atp_topo(1, 1, 1), device="cpu")
    assert ps.cfg.prefix_cache
    (want, jticks, jtrace), (got, pticks, ptrace) = lockstep(
        [(js, JaxRequest), (ps, Request)], prompts)
    assert got == want and len(got) == len(prompts)
    assert pticks == jticks
    assert ptrace == jtrace
    if n == 6:     # pages were mapped by more than one slot at once
        assert max(shared for shared, _, _ in ptrace) > 0
    pst, jst = ps.stats(), js.stats()
    assert pst["prefix_hit_rate"] == jst["prefix_hit_rate"] > 0
    assert pst["used_cache_bytes"] == jst["used_cache_bytes"]
    assert ps.alloc.pinned_pages == js.alloc.pinned_pages > 0


def test_prefix_cached_tokens_equal_the_uncached_ones():
    """Copy-on-write is exact: the port's server with the cache on gives
    the tokens of the same server with it off, in fewer prefill steps."""
    cfg = port_config("llama3-8b").reduced()
    params = convert.tree_to_torch(jax.tree.map(np.asarray, jax_lm.init_params(
        get_config("llama3-8b").reduced(), jax.random.PRNGKey(3),
        jnp.float32)))
    prompts, geom = smoke_workload(cfg.vocab_size)
    runs = []
    for cached in (False, True):
        server, info = serve.make_paged_server(
            cfg, ServerConfig(batch_slots=3, prefill_chunk=4,
                              paged=PagedConfig(**geom), prefix_cache=cached),
            params, topo=atp_topo(1, 1, 1), device="cpu", sharded=cached)
        params = server.step_fn.params
        calls = []
        step = server.step_fn
        server.step_fn = lambda *a: calls.append(a[0].shape) or step(*a)
        for rid, p in enumerate(prompts):
            server.submit(Request(rid=rid, prompt=p, max_new=MAX_NEW))
        server.run_until_drained()
        chunks = sum(1 for shape in calls if shape == (1, 4))
        runs.append(({r.rid: r.out for r in server.completed}, chunks,
                     server.stats()))
    (off, off_chunks, _), (on, on_chunks, st) = runs
    assert on == off
    hit = round(st["prefix_hit_rate"] * sum(len(p) for p in prompts))
    assert hit > 0 and off_chunks - on_chunks == hit // 4


def test_the_cli_serves_the_three_modes(caplog):
    """``launch.serve`` on the CPU with a reduced model: the prefix cache
    and int8 pages together, ``--speculate`` on a config without an MTP
    head switched off and logged (as the reference's), and the stats
    logged."""
    caplog.set_level("INFO", logger="repro_torch.serve")
    serve.main(["--arch", "llama3-8b", "--reduced", "--device", "cpu",
                "--requests", "3", "--prompt-len", "12", "--max-new", "4",
                "--max-seq", "32", "--prefill-chunk", "4", "--page-size", "4",
                "--prefix-cache", "--page-dtype", "int8", "--speculate"])
    msgs = [r.getMessage() for r in caplog.records]
    assert "speculative decode off: no MTP head" in msgs
    done = [m for m in msgs if "served" in m]
    assert len(done) == 1 and "spec_accept_rate=0.000" in done[0]
    assert "prefix_hit_rate" in done[0] and "pages_shared" in done[0]
