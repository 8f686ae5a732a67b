"""The port's paged server against the JAX package's on the same weights:
greedy tokens must be identical, token for token, and every page must
return to the pool.  fp32 weights, bf16 page pools on both sides (each
server's default), CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.core.mesh import atp_topo as jax_atp_topo  # noqa: E402
from repro.launch.serve import make_paged_server as jax_server  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models.paging import PagedConfig  # noqa: E402
from repro.runtime.server import Request, ServerConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_config as port_config  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models.paging import PagedConfig as PortPagedConfig  # noqa: E402
from repro_torch.runtime.server import Request as PortRequest  # noqa: E402
from repro_torch.runtime.server import ServerConfig as PortServerConfig  # noqa: E402

GEOM = dict(page_size=4, num_pages=40, pages_per_slot=8)


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, size=n, dtype=np.int32)
            for n in (5, 11, 3, 9)]


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-0.5b"])
def test_port_server_greedy_tokens_match_jax_server(arch):
    cfg = get_config(arch).reduced()
    params = jax_lm.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    np_params = jax.tree.map(np.asarray, params)
    prompts = _prompts(cfg.vocab_size)
    max_new = 5

    jserver, _ = jax_server(
        cfg, ServerConfig(batch_slots=2, prefill_chunk=4,
                          paged=PagedConfig(**GEOM)),
        params, topo=jax_atp_topo(1, 1, 1))
    pserver, _ = port_serve.make_paged_server(
        port_config(arch).reduced(),
        PortServerConfig(batch_slots=2, prefill_chunk=4,
                         paged=PortPagedConfig(**GEOM)),
        convert.tree_to_torch(np_params), topo=atp_topo(1, 1, 1),
        device="cpu")
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
    assert pserver.alloc.free_pages == GEOM["num_pages"] - 1
    assert pserver.stats()["cache_bytes"] > 0


def test_server_refuses_modes_the_port_lacks():
    cfg = port_config("llama3-8b").reduced()
    for flag in ("prefix_cache", "speculate"):
        scfg = PortServerConfig(**{flag: True})
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            port_serve.make_paged_server(cfg, scfg, {}, device="cpu")
