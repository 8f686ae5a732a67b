"""deepseek-v3's MTP self-speculative decode in the port against the
reference's, on the CPU.

deepseek-v3 is the one config with an MTP head of its own: its draft block
is an ``mla_dense`` layer run cache-free over the fed window, whose
attention takes q/k 192 with a V of 128 (on the card variant 0's
``flash_kernel<192>``; here the plain version).  Reduced deepseek-v3 (3
layers, MLA q/k 32 + 16, v 32, two ``mla_moe`` layers of 4 experts, top-2)
with fp32 weights from the reference's ``init_params``, crossing as numpy:
  - the speculative server's tokens, ticks, ``spec_drafts`` and
    ``spec_accepted`` equal to the reference's
    (``repro.launch.serve.make_paged_server``, ``speculate=True``), on
    seeds where the reference accepts drafts, so that both branches of the
    tick run;
  - its tokens equal to the plain server's where no route is dropped.  A
    capacity-bounded MoE layer gives each expert ``capacity_factor x
    tokens x top_k / experts`` slots a step, so a (slots, 2) tick drops
    other routes than a (slots, 1) tick, and the greedy tokens may differ
    (in the reference too).  DeepSeek-V3 drops no token at inference: at a
    capacity factor of experts / top_k every route has its slot, and
    speculation changes latency only.
"""
import dataclasses

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

from test_torch_speculate import GEOM, _serve  # noqa: E402

ARCH = "deepseek-v3-671b"
#: seeds where the reference's speculative server accepts a draft, at the
#: config's capacity factor and where no route is dropped
ACCEPTING = {False: [1, 5], True: [5, 7]}


def _no_drop(cfg):
    """``cfg`` with a capacity that holds every route of a step."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def _case(seed, no_drop=False):
    """The reduced config (with its MTP head), its fp32 reference weights
    from ``seed`` and four seeded prompts of 3-11 tokens."""
    cfg = get_config(ARCH).reduced()
    assert cfg.mtp
    cfg = _no_drop(cfg) if no_drop else cfg
    params = jax_lm.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(k), dtype=np.int32)
               for k in rng.integers(3, 12, 4)]
    return cfg, params, prompts


def _port_server(np_params, speculate=True, no_drop=False):
    cfg = port_config(ARCH).reduced()
    return serve.make_paged_server(
        _no_drop(cfg) if no_drop else cfg,
        ServerConfig(batch_slots=2, prefill_chunk=4,
                     paged=PagedConfig(**GEOM), speculate=speculate),
        convert.tree_to_torch(np_params), topo=atp_topo(1, 1, 1),
        device="cpu")[0]


@pytest.mark.parametrize("no_drop,seed", [
    (no_drop, seed) for no_drop, seeds in ACCEPTING.items()
    for seed in seeds])
def test_speculative_mla_server_matches_the_reference(no_drop, seed):
    cfg, params, prompts = _case(seed, no_drop)
    js, _ = jax_server(cfg, JaxServerConfig(
        batch_slots=2, prefill_chunk=4, paged=JaxPagedConfig(**GEOM),
        speculate=True), params, topo=jax_atp_topo(1, 1, 1))
    assert js.cfg.speculate
    ps = _port_server(jax.tree.map(np.asarray, params), no_drop=no_drop)
    assert ps.cfg.speculate
    want, jticks, jst = _serve(js, JaxRequest, prompts)
    got, pticks, pst = _serve(ps, Request, prompts)
    assert got == want and len(got) == len(prompts)
    assert pticks == jticks
    assert (pst["spec_drafts"], pst["spec_accepted"]) == \
        (jst["spec_drafts"], jst["spec_accepted"])
    assert pst["spec_accepted"] >= 1 and pst["spec_drafts"] > 0
    assert ps.alloc.free_pages == GEOM["num_pages"] - 1


@pytest.mark.parametrize("seed", ACCEPTING[True])
def test_speculative_mla_tokens_equal_the_plain_servers(seed):
    """Where no route is dropped, the speculative server's greedy tokens
    are the plain server's, in no more ticks."""
    _, params, prompts = _case(seed, no_drop=True)
    np_params = jax.tree.map(np.asarray, params)
    got, spec_ticks, st = _serve(_port_server(np_params, no_drop=True),
                                 Request, prompts)
    want, plain_ticks, _ = _serve(
        _port_server(np_params, speculate=False, no_drop=True), Request,
        prompts)
    assert got == want
    assert st["spec_accepted"] >= 1 and spec_ticks <= plain_ticks
