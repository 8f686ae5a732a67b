"""The port's wave baseline over contiguous decode caches against the
reference's, on the same weights.

Weights come from the JAX ``lm.init_params`` in fp32 and cross as numpy
(``repro_torch.convert``); prompts are made from a seed with numpy.
Everything runs on the CPU, where the port's kernels take their plain
versions.  Per reduced config (llama3-8b, qwen3-8b's qk-norm,
qwen1.5-0.5b's qkv bias, gemma2-2b's windows and softcaps, zamba2-7b cut
to 5 layers for both recurrent segment kinds):
  - ``lm.decode_step``'s logits within 1e-4 (relative and absolute: the
    sides sum in other orders) of the reference's over a prefill into the
    caches and 3 ticks, fp32 caches;
  - ``launch.serve.serve``'s greedy tokens equal to the reference's
    ``serve`` (each side's default caches: bf16);
  - the port's paged server on the same prompts gives the port's wave
    tokens, and ``launch.steps.build_prefill`` the reference's first
    token;
  - ``lm.init_decode_caches`` gives each rank the shape of its shard of
    the reference's global caches, on several meshes, with the batch
    replicated where dp does not divide it.
One spawn of four gloo ranks (``_torch_wave_worker.py``) serves llama3-8b
waves on (1, 2, 2) and on (2, 2, 1) with a batch of 1 (replicated: B < dp)
and of 2 (split over dp), and a zamba2-7b wave on (1, 2, 2), each held
against the reference's ``serve`` on a host mesh of the same shape.
"""
import dataclasses
import functools
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
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_config as port_config  # noqa: E402
from repro_torch.core.atp import make_context  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime.server import Request, ServerConfig  # noqa: E402
from repro_torch.models.paging import PagedConfig  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["llama3-8b", "qwen3-8b", "qwen1.5-0.5b", "gemma2-2b", "zamba2-7b"]
#: layers of each arch's reduced config (None: the reduced default)
LAYERS = {"zamba2-7b": 5}
B, PROMPT, MAX_NEW, MAX_SEQ = 2, 6, 4, 12
ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_wave_worker.py"


def _configs(arch):
    cfg, pcfg = get_config(arch).reduced(), port_config(arch).reduced()
    if LAYERS.get(arch):
        cfg = dataclasses.replace(cfg, num_layers=LAYERS[arch])
        pcfg = dataclasses.replace(pcfg, num_layers=LAYERS[arch])
    return cfg, pcfg


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The JAX global weights (numpy) of ``arch``, qkv biases made
    non-zero so that the bias path adds something."""
    cfg, _ = _configs(arch)
    params = jax_lm.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    if cfg.qkv_bias:
        rng = np.random.default_rng(1)
        attn = params["seg0"]["attn"]
        for k in ("bq", "bk", "bv"):
            attn[k] = jnp.asarray(rng.normal(size=attn[k].shape) * 0.1,
                                  jnp.float32)
    return jax.tree.map(np.asarray, params)


def _prompts(vocab, n=B, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=PROMPT, dtype=np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_match_the_reference(arch):
    cfg, pcfg = _configs(arch)
    weights = _weights(arch)
    topo = JaxMeshTopo((("data", 1),))
    jctx = jax_make_context(topo)
    step = jax.jit(shard_map(
        lambda p, t, pos, c: jax_lm.decode_step(jctx, cfg, p, t, pos, c),
        mesh=topo.build(jax.devices()[:1]), in_specs=(P(),) * 4,
        out_specs=(P(), P()), check_vma=False))
    jcaches, _ = jax_lm.init_decode_caches(cfg, jctx, B, MAX_SEQ,
                                           dtype=jnp.float32)
    ctx = make_context(atp_topo(1, 1, 1), device_type="cpu")
    params = convert.params_from_jax(pcfg, weights, atp_topo(1, 1, 1), 0)
    caches = lm.init_decode_caches(pcfg, ctx, B, MAX_SEQ,
                                   dtype=torch.float32, device="cpu")
    toks = np.stack(_prompts(cfg.vocab_size))
    pos = 0
    for i in range(4):
        want, jcaches = step(weights, toks, jnp.int32(pos), jcaches)
        with torch.no_grad():
            got, caches = lm.decode_step(ctx, pcfg, params,
                                         torch.as_tensor(toks),
                                         torch.tensor(pos, dtype=torch.int32),
                                         caches)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {i}")
        pos += toks.shape[1]
        toks = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    for i, seg in enumerate(jcaches):
        lens = (jcaches[seg]["attn"]["len"] if "attn" in jcaches[seg]
                else jcaches[seg].get("len"))
        plens = (caches[seg]["attn"]["len"] if "attn" in caches[seg]
                 else caches[seg].get("len"))
        if lens is not None:
            np.testing.assert_array_equal(plens.numpy(), np.asarray(lens))


@functools.lru_cache(maxsize=None)
def _wave_tokens(arch):
    """(the port's wave tokens, the reference's) on the trivial mesh."""
    cfg, pcfg = _configs(arch)
    weights = _weights(arch)
    prompts = _prompts(cfg.vocab_size)
    want = ref_serve.serve(cfg, jax_atp_topo(1, 1, 1), weights, prompts,
                           MAX_NEW, MAX_SEQ)
    got = serve.serve(pcfg, atp_topo(1, 1, 1),
                      convert.tree_to_torch(weights), prompts, MAX_NEW,
                      MAX_SEQ, device="cpu")
    return got, np.asarray(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_equal_the_references(arch):
    got, want = _wave_tokens(arch)
    assert got.shape == (B, MAX_NEW)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_server_tokens_equal_the_wave_tokens(arch):
    """The paged server (prefill chunks of 4, so a prompt takes two, and
    continuous decode) on the wave's prompts gives the wave's tokens."""
    _, pcfg = _configs(arch)
    wave, _ = _wave_tokens(arch)
    prompts = _prompts(pcfg.vocab_size)
    scfg = ServerConfig(batch_slots=B, prefill_chunk=4,
                        paged=PagedConfig(page_size=4, num_pages=16,
                                          pages_per_slot=3))
    server, _ = serve.make_paged_server(
        pcfg, scfg, convert.tree_to_torch(_weights(arch)), device="cpu")
    for rid, p in enumerate(prompts):
        server.submit(Request(rid=rid, prompt=p, max_new=MAX_NEW))
    server.run_until_drained()
    got = {r.rid: r.out for r in server.completed}
    assert [got[i] for i in range(B)] == wave.tolist()


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-7b"])
def test_build_prefill_picks_the_references_tokens(arch):
    """The cache-free serving step: the greedy next token of each prompt
    equals the reference's ``build_prefill``'s, and the wave's first
    token."""
    from repro.launch.steps import build_prefill as ref_prefill
    from repro_torch.launch.steps import build_prefill

    cfg, pcfg = _configs(arch)
    weights = _weights(arch)
    toks = np.stack(_prompts(cfg.vocab_size))
    fn, _ = ref_prefill(cfg, jax_atp_topo(1, 1, 1))
    want = np.asarray(fn(weights, {"tokens": toks}))
    step, info = build_prefill(pcfg, atp_topo(1, 1, 1), device="cpu")
    params = convert.params_from_jax(pcfg, weights, atp_topo(1, 1, 1), 0)
    got = step(params, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _wave_tokens(arch)[0][:, 0])


def _shard_shape(shape, spec, topo: JaxMeshTopo):
    out = []
    for n, axes in zip(shape, tuple(spec) + (None,) * len(shape)):
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            if a is not None:
                n //= topo.axis_size(a)
        out.append(n)
    return tuple(out)


@pytest.mark.parametrize("mesh", [(1, 1, 1), (1, 2, 2), (1, 4, 1), (2, 2, 1),
                                  (4, 1, 1)])
@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-7b"])
def test_init_decode_caches_shapes_are_the_reference_shards(arch, mesh):
    """Each rank's caches have the shape of its shard of the reference's
    global caches under their PartitionSpecs (B = 2: split over dp = 2,
    replicated over dp = 4)."""
    cfg, pcfg = _configs(arch)
    jtopo = jax_atp_topo(*mesh)
    want, specs = jax_lm.init_decode_caches(cfg, jax_make_context(jtopo), B,
                                            MAX_SEQ, abstract=True)
    want = jax.tree.map(
        lambda a, sp: (_shard_shape(a.shape, sp, jtopo), str(a.dtype)), want,
        specs, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    topo = atp_topo(*mesh)
    for rank in range(topo.size):
        got = lm.tree_map(lambda t: (tuple(t.shape), str(t.dtype).replace(
            "torch.", "")), lm.init_decode_caches(
                pcfg, lm.layout_context(topo, rank), B, MAX_SEQ,
                dtype=torch.bfloat16, device="cpu"))
        assert got == want, f"rank {rank}"


def test_the_wave_refuses_what_it_cannot_hold():
    _, pcfg = _configs("llama3-8b")
    server = serve.make_wave_server(
        pcfg, B, MAX_SEQ, convert.tree_to_torch(_weights("llama3-8b")),
        device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        server.serve(_prompts(pcfg.vocab_size), MAX_SEQ)
    with pytest.raises(ValueError, match="a wave of 3"):
        server.serve(_prompts(pcfg.vocab_size, n=3), MAX_NEW)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        lm.init_decode_caches(port_config("xlstm-1.3b").reduced(),
                              make_context(atp_topo(1, 1, 1),
                                           device_type="cpu"), B, MAX_SEQ,
                              device="cpu")


def test_a_second_wave_in_the_same_caches_serves_afresh():
    """``WaveServer`` reuses its caches: a wave after another gives the
    tokens of a new server, uncaptured and through the captured step's CPU
    plumbing alike, which warms up once per shape."""
    _, pcfg = _configs("zamba2-7b")
    server = serve.make_wave_server(
        pcfg, B, MAX_SEQ, convert.tree_to_torch(_weights("zamba2-7b")),
        device="cpu")
    other = _prompts(pcfg.vocab_size, seed=4)
    server.serve(other, MAX_NEW)
    wave, _ = _wave_tokens("zamba2-7b")
    np.testing.assert_array_equal(server.serve(_prompts(pcfg.vocab_size),
                                               MAX_NEW), wave)
    np.testing.assert_array_equal(
        server.uncaptured().serve(_prompts(pcfg.vocab_size), MAX_NEW), wave)
    assert server.step.warmups == 2 and len(server.step.shapes) == 2


# ---------------------------------------------------------------------------
# Gloo meshes.
# ---------------------------------------------------------------------------

#: (arch, mesh (dp, d1, d2), wave batch): tp over (1, 2, 2); over (2, 2,
#: 1) a batch of 1 replicated on both dp ranks and one of 2 split between
#: them; zamba2-7b's batch-row state over (1, 2, 2)
GLOO_CASES = [("llama3-8b", (1, 2, 2), 2), ("llama3-8b", (2, 2, 1), 1),
              ("llama3-8b", (2, 2, 1), 2), ("zamba2-7b", (1, 2, 2), 2)]


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_gloo_mesh_waves_give_the_references_tokens(tmp_path):
    want = []
    for arch in {a for a, _, _ in GLOO_CASES}:
        np.savez(tmp_path / f"{arch}.npz", **_flatten(_weights(arch)))
    for i, (arch, mesh, b) in enumerate(GLOO_CASES):
        cfg, _ = _configs(arch)
        prompts = _prompts(cfg.vocab_size, n=b, seed=10 + i)
        np.save(tmp_path / f"prompts{i}.npy", np.stack(prompts))
        want.append(np.asarray(ref_serve.serve(
            cfg, jax_atp_topo(*mesh), _weights(arch), prompts, MAX_NEW,
            MAX_SEQ)))
    world = 4
    (tmp_path / "case.json").write_text(json.dumps(dict(
        world=world, max_new=MAX_NEW, max_seq=MAX_SEQ,
        waves=[(a, LAYERS.get(a), m) for a, m, _ in GLOO_CASES])))
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
        got = np.load(tmp_path / f"rank{r}.npz")
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got[f"tokens{i}"], w,
                                          err_msg=f"case {i} rank {r}")
