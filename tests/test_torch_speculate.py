"""The port's MTP self-speculative decode against the reference's, on the
CPU.

The dense configs carry no MTP head of their own; ``mtp=True`` gives
reduced qwen1.5-0.5b and llama3-8b one (two [h, h] projections, a dense
block, a norm), as the reference's serving smoke does.  fp32 weights from
the reference's ``init_params`` cross as numpy:
  - ``lm.mtp_draft_logits`` within 1e-4 of the reference's;
  - the speculative server's tokens, ticks, ``spec_drafts`` and
    ``spec_accepted`` equal to the reference's, on seeds where the
    reference accepts drafts, so that both branches of the tick run;
  - its tokens equal to the plain server's (speculation changes latency,
    never the greedy tokens);
  - the MTP leaves cut and reassembled by the reference's specs;
  - what the reference refuses or switches off, the port does too;
  - one spawn of four gloo ranks (``_torch_serve_modes_worker.py``): the
    speculative and the prefix-cached servers on (1, 2, 2), against the
    reference's on a host mesh of the same shape.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

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
from repro.models.paging import PagedConfig as JaxPagedConfig  # noqa: E402
from repro.runtime.server import Request as JaxRequest  # noqa: E402
from repro.runtime.server import ServerConfig as JaxServerConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_config as port_config  # noqa: E402
from repro_torch.core.atp import make_context  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.paging import PagedConfig  # noqa: E402
from repro_torch.runtime.server import Request, ServerConfig  # noqa: E402

from test_torch_prefix import smoke_workload  # noqa: E402
from test_torch_train import jax_loss_and_grads  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
GEOM = dict(page_size=4, num_pages=60, pages_per_slot=8)
MAX_NEW = 12
#: (arch, seed) pairs where the reference's speculative server accepts at
#: least one draft on random weights (vocab 512)
ACCEPTING = [("qwen1.5-0.5b", 1), ("llama3-8b", 16)]
ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_serve_modes_worker.py"


def _mtp(cfg):
    return dataclasses.replace(cfg, mtp=True)


def _case(arch, seed):
    """The reduced config with an MTP head, its fp32 reference weights
    from ``seed`` and four seeded prompts of 3-11 tokens."""
    cfg = _mtp(get_config(arch).reduced())
    params = jax_lm.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(k), dtype=np.int32)
               for k in rng.integers(3, 12, 4)]
    return cfg, params, prompts


def _serve(server, req, prompts, max_new=MAX_NEW):
    for rid, p in enumerate(prompts):
        server.submit(req(rid=rid, prompt=p, max_new=max_new))
    ticks = server.run_until_drained()
    return {r.rid: list(r.out) for r in server.completed}, ticks, \
        server.stats()


def _port_server(arch, np_params, speculate=True, topo=None):
    return serve.make_paged_server(
        _mtp(port_config(arch).reduced()),
        ServerConfig(batch_slots=2, prefill_chunk=4,
                     paged=PagedConfig(**GEOM), speculate=speculate),
        convert.tree_to_torch(np_params), topo=topo or atp_topo(1, 1, 1),
        device="cpu")[0]


@pytest.mark.parametrize("arch,seed", ACCEPTING)
def test_speculative_server_matches_the_reference(arch, seed):
    cfg, params, prompts = _case(arch, seed)
    js, _ = jax_server(cfg, JaxServerConfig(
        batch_slots=2, prefill_chunk=4, paged=JaxPagedConfig(**GEOM),
        speculate=True), params, topo=jax_atp_topo(1, 1, 1))
    assert js.cfg.speculate
    ps = _port_server(arch, jax.tree.map(np.asarray, params))
    assert ps.cfg.speculate
    want, jticks, jst = _serve(js, JaxRequest, prompts)
    got, pticks, pst = _serve(ps, Request, prompts)
    assert got == want and len(got) == len(prompts)
    assert pticks == jticks
    assert (pst["spec_drafts"], pst["spec_accepted"]) == \
        (jst["spec_drafts"], jst["spec_accepted"])
    assert pst["spec_accepted"] >= 1 and pst["spec_drafts"] > 0
    assert ps.alloc.free_pages == GEOM["num_pages"] - 1


def test_speculative_tokens_equal_the_plain_servers():
    arch, seed = ACCEPTING[1]
    _, params, prompts = _case(arch, seed)
    np_params = jax.tree.map(np.asarray, params)
    got, spec_ticks, st = _serve(_port_server(arch, np_params), Request,
                                 prompts)
    want, plain_ticks, _ = _serve(
        _port_server(arch, np_params, speculate=False), Request, prompts)
    assert got == want
    assert st["spec_accepted"] >= 1 and spec_ticks <= plain_ticks


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3-8b"])
def test_mtp_draft_logits_match_the_reference(arch):
    cfg = _mtp(get_config(arch).reduced())
    params = jax_lm.init_params(cfg, jax.random.PRNGKey(5), jnp.float32)
    rng = np.random.default_rng(5)
    b, s = 2, 3
    h = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    positions = (np.array([[5], [9]]) + np.arange(s)[None]).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    topo = JaxMeshTopo((("data", 1),))
    jctx = jax_make_context(topo)
    fn = jax.jit(shard_map(
        lambda p, h, pos, t: jax_lm.mtp_draft_logits(jctx, cfg, p, h, pos, t),
        mesh=topo.build(jax.devices()[:1]), in_specs=(P(), P(), P(), P()),
        out_specs=P(), check_vma=True))
    want = np.asarray(fn(params, h, positions, nxt))
    ctx = make_context(atp_topo(1, 1, 1), device_type="cpu")
    tparams = convert.params_from_jax(cfg, jax.tree.map(np.asarray, params),
                                      atp_topo(1, 1, 1), 0)
    with torch.no_grad():
        got = lm.mtp_draft_logits(ctx, _mtp(port_config(arch).reduced()),
                                  tparams, torch.from_numpy(h),
                                  torch.from_numpy(positions).long(),
                                  torch.from_numpy(nxt))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mtp_leaves_cross_by_the_references_specs():
    """Each rank of (1, 2, 2) cuts its shard of the MTP head by the
    reference's specs (``proj_h``/``proj_e`` column weights, the block's
    fused leaves through ``FUSED_LEAVES``); the four shards reassemble to
    the global leaves exactly."""
    cfg = _mtp(get_config("llama3-8b").reduced())
    params = jax.tree.map(np.asarray, jax_lm.init_params(
        cfg, jax.random.PRNGKey(0), jnp.float32))
    topo = atp_topo(1, 2, 2)
    pcfg = _mtp(port_config("llama3-8b").reduced())
    shards = [convert.params_from_jax(pcfg, params, topo, r)
              for r in range(topo.size)]
    h = cfg.d_model
    assert tuple(shards[0]["mtp"]["proj_h"].shape) == (h // 2, h // 2)
    back = convert.params_to_numpy(pcfg, shards, topo)
    for (path, want) in jax.tree_util.tree_leaves_with_path(params["mtp"]):
        node = back["mtp"]
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, want, err_msg=str(path))


def test_modes_resolve_as_the_references():
    """``speculate`` without an MTP head, or on a recurrent model, is
    switched off and served plainly; ``build_paged_step`` refuses both; the
    training loss with the MTP head's term equals the reference's."""
    llama = port_config("llama3-8b").reduced()
    zamba = _mtp(port_config("zamba2-7b").reduced())
    with pytest.raises(ValueError, match="MTP head"):
        steps.build_paged_step(llama, atp_topo(1, 1, 1), device="cpu",
                               speculate=True)
    with pytest.raises(NotImplementedError, match="recurrent"):
        steps.build_paged_step(zamba, atp_topo(1, 1, 1), device="cpu",
                               slots=2, speculate=True)
    for cfg in (llama, zamba):
        server, _ = serve.make_paged_server(
            cfg, ServerConfig(batch_slots=2, speculate=True),
            lm.init_params(cfg, seed=0, device="cpu"), device="cpu")
        assert not server.cfg.speculate
    mtp = _mtp(llama)
    ctx = make_context(atp_topo(1, 1, 1), device_type="cpu")
    jcfg, jparams, _ = _case("llama3-8b", 0)
    np_params = jax.tree.map(np.asarray, jparams)
    toks = np.arange(8, dtype=np.int32).reshape(2, 4) % mtp.vocab_size
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    want, _ = jax_loss_and_grads(jcfg, np_params, batch)
    got = lm.train_loss(ctx, mtp, convert.params_from_jax(
        mtp, np_params, atp_topo(1, 1, 1), 0),
        {k: torch.from_numpy(v) for k, v in batch.items()}, remat=False)
    np.testing.assert_allclose(float(got), want, **TOL)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_gloo_mesh_serves_the_references_tokens(tmp_path):
    """The speculative server (llama3-8b with an MTP head) and the
    prefix-cached one (serve-smoke's prompts, 6 behind the system prompt)
    on a (1, 2, 2) gloo mesh: every rank's tokens, ticks and stats equal
    to the reference's same servers on a (1, 2, 2) host mesh."""
    mesh = (1, 2, 2)
    arch, seed = ACCEPTING[1]
    cfg, params, prompts = _case(arch, seed)
    pcfg = get_config(arch).reduced()
    pparams = jax_lm.init_params(pcfg, jax.random.PRNGKey(0), jnp.float32)
    pprompts, pgeom = smoke_workload(pcfg.vocab_size, 6)
    cases = [
        dict(name="speculate", arch=arch, mtp=True, mesh=mesh, slots=2,
             chunk=4, geom=GEOM, modes=dict(speculate=True),
             max_new=MAX_NEW),
        dict(name="prefix", arch=arch, mtp=False, mesh=mesh, slots=3,
             chunk=4, geom=pgeom, modes=dict(prefix_cache=True), max_new=6)]
    want = {}
    for c, c_cfg, c_params, c_prompts in ((cases[0], cfg, params, prompts),
                                          (cases[1], pcfg, pparams,
                                           pprompts)):
        np.savez(tmp_path / f"{c['name']}.npz", **_flatten(c_params))
        np.savez(tmp_path / f"{c['name']}_prompts.npz",
                 **{f"p{i}": p for i, p in enumerate(c_prompts)})
        js, _ = jax_server(c_cfg, JaxServerConfig(
            batch_slots=c["slots"], prefill_chunk=c["chunk"],
            paged=JaxPagedConfig(**c["geom"]), **c["modes"]), c_params,
            topo=jax_atp_topo(*mesh))
        toks, ticks, st = _serve(js, JaxRequest, c_prompts, c["max_new"])
        want[c["name"]] = dict(
            tokens={str(r): t for r, t in toks.items()}, ticks=ticks,
            **{k: st[k] for k in ("spec_drafts", "spec_accepted",
                                  "prefix_hit_rate")})
    assert want["speculate"]["spec_accepted"] >= 1
    assert want["prefix"]["prefix_hit_rate"] > 0
    world = 4
    (tmp_path / "case.json").write_text(json.dumps(dict(world=world,
                                                        cases=cases)))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r),
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:  # a rank that died leaves the others waiting in a collective
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    for r in range(world):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got == want, f"rank {r}"
