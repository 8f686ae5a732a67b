"""The port's ATP mesh against the JAX package on one device.

Four gloo ranks on the CPU (one process each, joined through a file store
under ``tmp_path``: the suite runs under xdist, so no fixed TCP port) run
the port's ``lm.paged_step`` on their shards of the same JAX weights: two
prefill chunks of one slot, one of another, then two decode ticks of both.
ATP is dense math, so the logits gathered over tp1 must match the JAX
single-device logits within 1e-4 (fp32; summation order differs), and the
vocab-parallel greedy pick must be their argmax.

(1, 2, 2) exercises the tp2 boundaries, the sharded norms and, with
chunks=2, the chunked boundary GEMMs; (1, 4, 1) the k/v all-gather over
tp1 (two kv heads on four ranks: ``kv_regroup``); qwen1.5 the qkv bias
added after the boundary.  zamba2-7b (reduced, 5 layers: two super-blocks
and a tail Mamba2 block) adds the Mamba2 sharding: SSD heads over the flat
ranks, the B/C/dt projection all-reduced over tp2, the heads all-gathered
over tp2 before the out projection, the shared block's in-projections
gathered over tp1, and the per-slot state pools addressed by slot id.

Under a plan whose decode sub-plan runs ring boundaries or the int8 wire,
the same calls on (1, 2, 2) give the greedy tokens of the reference's
``build_paged_step(plan=...)`` on a host mesh of four devices.
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
from repro.core.atp import make_context  # noqa: E402
from repro.core.compat import shard_map  # noqa: E402
from repro.core.mesh import MeshTopo  # noqa: E402
from repro.core.plan import DecodePlan as RefDecodePlan  # noqa: E402
from repro.core.plan import ParallelPlan as RefPlan  # noqa: E402
from repro.launch.steps import build_paged_step  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.models.paging import PagedConfig as JaxPagedConfig  # noqa: E402
from repro_torch.models.paging import PageAllocator, PagedConfig  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_atp_worker.py"
PAGED = dict(page_size=4, num_pages=16, pages_per_slot=4)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


#: layers of each arch's reduced config (None: the reduced default)
LAYERS = {"zamba2-7b": 5}


def _config(arch):
    cfg = get_config(arch).reduced()
    if LAYERS.get(arch):
        cfg = dataclasses.replace(cfg, num_layers=LAYERS[arch])
    return cfg


def _calls(vocab):
    """(tokens, start, table, slot) of each step: slot 0 prefills 8 tokens
    in two chunks, slot 1 prefills 4, then both decode two ticks."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, vocab, (2, 10), dtype=np.int32)
    alloc = PageAllocator(PagedConfig(**PAGED), slots=2)
    alloc.ensure(0, 10)
    alloc.ensure(1, 6)
    table = alloc.table()
    calls = [(toks[0:1, 0:4], [0], table[0:1], [0]),
             (toks[0:1, 4:8], [4], table[0:1], [0]),
             (toks[1:2, 0:4], [0], table[1:2], [1]),
             (toks[:, [8]], [8, 4], table, [0, 1]),
             (toks[:, [9]], [9, 5], table, [0, 1])]
    return [(t, np.asarray(s, np.int32), tb, np.asarray(sl, np.int32))
            for t, s, tb, sl in calls]


def _jax_logits(cfg, params, calls, slots):
    topo = MeshTopo((("data", 1),))
    ctx = make_context(topo)

    def step(p, tok, start, table, slot, caches):
        return lm.paged_step(ctx, cfg, p, tok, start, table, caches,
                             slot=slot if slots else None)

    g = jax.jit(shard_map(step, mesh=topo.build(jax.devices()[:1]),
                          in_specs=(P(),) * 6, out_specs=(P(), P()),
                          check_vma=True))
    caches, _ = lm.init_paged_caches(cfg, ctx, JaxPagedConfig(**PAGED),
                                     dtype=jnp.float32, slots=slots)
    out = []
    for tok, start, table, slot in calls:
        logits, caches = g(params, tok, start, table, slot, caches)
        out.append(np.asarray(logits))
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The JAX weights, the step inputs, the state pools' slot count (None
    for a dense model) and the JAX single-device logits of ``arch``: the
    same for each of its mesh cases."""
    cfg = _config(arch)
    params = lm.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    if cfg.qkv_bias:  # zero at init: give the bias path something to add
        rng = np.random.default_rng(1)
        attn = params["seg0"]["attn"]
        for k in ("bq", "bk", "bv"):
            attn[k] = jnp.asarray(rng.normal(size=attn[k].shape) * 0.1,
                                  jnp.float32)
    calls = _calls(cfg.vocab_size)
    slots = 2 if cfg.ssm is not None else None
    return cfg, params, calls, slots, _jax_logits(cfg, params, calls, slots)


def _spawn(tmp_path, arch, mesh, **case):
    """Run the calls of ``arch`` on ``mesh``'s gloo ranks; each rank's
    results."""
    cfg, params, calls, slots, _ = _reference(arch)
    np.savez(tmp_path / "params.npz", **_flatten(params))
    np.savez(tmp_path / "calls.npz", **{
        f"{name}{i}": arr for i, c in enumerate(calls)
        for name, arr in zip(("tokens", "start", "table", "slot"), c)})
    (tmp_path / "case.json").write_text(json.dumps(dict(
        arch=arch, layers=LAYERS.get(arch), mesh=mesh, paged=PAGED,
        slots=slots, calls=len(calls), **case)))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    world = int(np.prod(mesh))
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
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]


@pytest.mark.parametrize("knobs", [dict(boundary_mode="ring"),
                                   dict(wire_dtype="int8")],
                         ids=["ring", "int8"])
def test_gloo_mesh_paged_step_under_a_decode_plan_gives_the_references_tokens(
        tmp_path, knobs):
    """llama3-8b on (1, 2, 2) under a plan whose decode sub-plan runs ring
    boundaries or the int8 wire: every rank's greedy picks of every call
    equal the reference's serving step's under the same plan."""
    cfg, params, calls, _, _ = _reference("llama3-8b")
    plan = RefPlan(d1=2, d2=2, decode=RefDecodePlan(d1=2, d2=2, **knobs))
    step, info = build_paged_step(cfg, paged_cfg=JaxPagedConfig(**PAGED),
                                  plan=plan)
    caches, _ = lm.init_paged_caches(cfg, info.ctx, JaxPagedConfig(**PAGED),
                                     dtype=jnp.float32)
    want = []
    for tok, start, table, _ in calls:
        picks, caches = step(params, tok, start, table, caches)
        want.append(np.asarray(picks))
    ranks = _spawn(tmp_path, "llama3-8b", (1, 2, 2), plan=plan.to_dict())
    for i, w in enumerate(want):
        for r, got in enumerate(ranks):
            np.testing.assert_array_equal(got[f"pick{i}"], w,
                                          err_msg=f"call {i} rank {r}")


@pytest.mark.parametrize("arch,mesh,chunks", [
    ("llama3-8b", (1, 2, 2), 2),
    ("llama3-8b", (1, 4, 1), 1),
    ("qwen1.5-0.5b", (1, 2, 2), 1),
    ("zamba2-7b", (1, 2, 2), 1),
    ("zamba2-7b", (1, 4, 1), 1),
])
def test_gloo_mesh_paged_step_matches_jax_single_device(tmp_path, arch, mesh,
                                                        chunks):
    want = _reference(arch)[4]
    ranks = _spawn(tmp_path, arch, mesh, chunks=chunks)
    world = len(ranks)
    _, d1, d2 = mesh
    for i, ref in enumerate(want):
        # local logits [b, s, V/d1]: vocab over tp1, replicated over tp2
        for i2 in range(d2):
            got = np.concatenate([ranks[i1 * d2 + i2][f"logits{i}"]
                                  for i1 in range(d1)], axis=-1)
            np.testing.assert_allclose(got, ref, **TOL,
                                       err_msg=f"call {i} tp2 rank {i2}")
        for r in range(world):
            np.testing.assert_array_equal(ranks[r][f"pick{i}"],
                                          ref.argmax(-1))
