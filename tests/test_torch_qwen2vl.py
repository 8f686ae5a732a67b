"""The port's M-RoPE and ``embeds`` input (qwen2-vl-7b) against the
reference's, on the CPU.

qwen2-vl-7b ``.reduced()``: 2 dense layers, d_model 128, 4 q / 2 kv heads
of 32, M-RoPE sections (4, 6, 6).  Weights come from the reference's
``init_params`` in fp32 and cross as numpy through
``convert.params_from_jax``; inputs are made from a seed with numpy.  The
``embeds`` stand in for the vision frontend (the reference has no vision
encoder either): random rows for 6 text positions, a 3 x 4 grid of patches
and 6 more text positions, with ``positions3`` t = h = w = i for text, t
fixed and h/w the row/column over the grid, the text after it from the
grid's largest id on.  Tolerance 1e-4 (relative and absolute).
  - ``layers.apply_mrope`` on distinct t/h/w ids against the reference's,
    and on broadcast text ids equal to ``apply_rope`` (the paged path's
    text-only identity);
  - ``prefill_logits`` and ``train_loss`` (every gradient) with
    ``embeds`` + ``positions3``;
  - the paged server's greedy tokens on text prompts against the
    reference's server;
  - one spawn of four gloo ranks (``_torch_qwen2vl_worker.py``) on (1, 2,
    2) with 2 q / 2 kv heads, where ``make_attn_plan`` gives r = 2 (the
    query rows split over two ranks, ``positions3`` narrowed on its
    sequence dim): the prefill logits, the training loss and the gradients
    against the reference's on one device.  The reference on that mesh
    departs from its one-device result (ROADMAP §C); a test pins that.
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
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.core.atp import make_context as jax_make_context  # noqa: E402
from repro.core.compat import shard_map  # noqa: E402
from repro.core.mesh import atp_topo as jax_atp_topo  # noqa: E402
from repro.launch.serve import make_paged_server as jax_server  # noqa: E402
from repro.launch.steps import batch_pspecs  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models.paging import PagedConfig as JaxPagedConfig  # noqa: E402
from repro.runtime.server import Request as JaxRequest  # noqa: E402
from repro.runtime.server import ServerConfig as JaxServerConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_config as port_config  # noqa: E402
from repro_torch.core.atp import make_context  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.models.paging import PagedConfig  # noqa: E402
from repro_torch.runtime.server import Request, ServerConfig  # noqa: E402

from test_torch_train import (_flat, assert_trees_close,  # noqa: E402
                              port_loss_and_grads_at)
from test_torch_xlstm import _unflat_into  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "qwen2-vl-7b"
TOPO = atp_topo(1, 1, 1)
MESH = (1, 2, 2)
#: text before the grid, the grid's rows and columns, text after it
LAYOUT = (6, 3, 4, 6)
BATCH = 2
ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_qwen2vl_worker.py"


def _cfgs(heads=None):
    cfg, pcfg = get_config(ARCH).reduced(), port_config(ARCH).reduced()
    if heads is not None:
        cfg = dataclasses.replace(cfg, num_heads=heads, num_kv_heads=heads)
        pcfg = dataclasses.replace(pcfg, num_heads=heads, num_kv_heads=heads)
    return cfg, pcfg


@functools.lru_cache(maxsize=None)
def weights(heads=None):
    return jax.tree.map(np.asarray, jax_lm.init_params(
        _cfgs(heads)[0], jax.random.PRNGKey(0), jnp.float32))


def port_params(heads=None, mesh=(1, 1, 1), rank=0):
    return convert.params_from_jax(_cfgs(heads)[1], weights(heads),
                                   atp_topo(*mesh), rank)


def mrope_positions(before, rows, cols, after, b=1):
    """positions3 [3, b, s] of ``before`` text tokens, a ``rows x cols``
    grid of patches (t fixed at ``before``, h and w its row and column
    from ``before`` on) and ``after`` text tokens from ``before +
    max(rows, cols)`` on."""
    text0 = np.arange(before)
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    grid = np.stack([np.full(rows * cols, before), before + r.ravel(),
                     before + c.ravel()])
    text1 = before + max(rows, cols) + np.arange(after)
    pos = np.concatenate([np.stack([text0] * 3), grid,
                          np.stack([text1] * 3)], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                (3, b, pos.shape[1])))


@functools.lru_cache(maxsize=None)
def batch(heads=None, seed=4):
    """embeds [b, s, h] (random rows x 0.02, standing in for the frontend),
    positions3 [3, b, s] and labels [b, s]."""
    cfg = _cfgs(heads)[0]
    pos = mrope_positions(*LAYOUT, b=BATCH)
    rng = np.random.default_rng(seed)
    s = pos.shape[-1]
    embeds = (rng.normal(size=(BATCH, s, cfg.d_model)) * 0.02).astype(
        np.float32)
    labels = rng.integers(0, cfg.vocab_size, (BATCH, s), dtype=np.int32)
    labels[0, -2:] = -1
    return {"embeds": embeds, "positions3": pos, "labels": labels}


def test_apply_mrope_matches_the_reference_on_distinct_ids():
    rng = np.random.default_rng(1)
    pos = mrope_positions(*LAYOUT, b=2)
    x = rng.normal(size=(2, pos.shape[-1], 3, 32)).astype(np.float32)
    sections = _cfgs()[0].mrope_sections
    want = jax_layers.apply_mrope(x, pos, 1e6, sections)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                             sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the h and w ids matter: swapping them moves the result
    swapped = layers.apply_mrope(torch.from_numpy(x),
                                 torch.from_numpy(pos[[0, 2, 1]]), 1e6,
                                 sections)
    assert np.abs(swapped.numpy() - np.asarray(want)).max() > 1e-2


@settings(max_examples=20)
@given(st.integers(0, 2**32 - 1))
def test_apply_mrope_on_text_ids_is_apply_rope(seed):
    """On text positions broadcast to t = h = w, M-RoPE is RoPE, bit for
    bit: what the paged path relies on for text tokens."""
    rng = np.random.default_rng(seed)
    b, s = rng.integers(1, 4), rng.integers(1, 9)
    pos = torch.from_numpy(rng.integers(0, 4096, (b, s)))
    x = torch.from_numpy(rng.normal(size=(b, s, 2, 32)).astype(np.float32))
    got = layers.apply_mrope(x, pos[None].expand(3, b, s), 1e6, (4, 6, 6))
    assert torch.equal(got, layers.apply_rope(x, pos, 1e6))


@functools.lru_cache(maxsize=None)
def ref_prefill(heads=None, mesh=(1, 1, 1)):
    """The reference's ``prefill_logits`` on ``batch()``: [b, V].  Without
    the vma check, which a batch of embeds fails under jax 0.9.0 (ROADMAP
    §C)."""
    cfg = _cfgs(heads)[0]
    topo = jax_atp_topo(*mesh)
    ctx = jax_make_context(topo)
    bspec = batch_pspecs(cfg, topo, "prefill")
    fn = jax.jit(shard_map(
        lambda p, bt: jax_lm.prefill_logits(ctx, cfg, p, bt),
        mesh=topo.build(jax.devices()[:topo.size]),
        in_specs=(jax_lm.param_specs(cfg, ctx), bspec),
        out_specs=P(None, ctx.ax1), check_vma=False))
    bt = {k: v for k, v in batch(heads).items() if k != "labels"}
    return np.asarray(fn(weights(heads), bt))


@functools.lru_cache(maxsize=None)
def ref_loss(heads=None):
    """The reference's loss and global gradients on ``batch()``, on one
    device: its shard_map of a batch of embeds fails the vma check under
    jax 0.9.0 (the loss is inferred to vary over tp2, ROADMAP §C), and
    without the check its gradient reductions on a mesh are not the vma
    path's, so the mesh's gradients are held against one device's."""
    cfg = _cfgs(heads)[0]
    topo = jax_atp_topo(1, 1, 1)
    ctx = jax_make_context(topo)
    pspecs = jax_lm.param_specs(cfg, ctx)
    fn = jax.jit(shard_map(
        lambda p, bt: jax.value_and_grad(
            lambda q: jax_lm.train_loss(ctx, cfg, q, bt, remat=False))(p),
        mesh=topo.build(jax.devices()[:topo.size]),
        in_specs=(pspecs, batch_pspecs(cfg, topo, "train")),
        out_specs=(P(), pspecs), check_vma=False))
    loss, grads = fn(weights(heads), batch(heads))
    return float(loss), jax.tree.map(np.asarray, grads)


def test_prefill_logits_with_embeds_match_the_reference():
    _, pcfg = _cfgs()
    ctx = make_context(TOPO, device_type="cpu")
    bt = {k: torch.from_numpy(v) for k, v in batch().items()
          if k != "labels"}
    with torch.no_grad():
        got = lm.prefill_logits(ctx, pcfg, port_params(), bt)
    np.testing.assert_allclose(got.numpy(), ref_prefill(), **TOL)
    # positions3 reach the attention: the h and w ids swapped move them
    bt["positions3"] = bt["positions3"][[0, 2, 1]]
    with torch.no_grad():
        moved = lm.prefill_logits(ctx, pcfg, port_params(), bt)
    assert np.abs(moved.numpy() - ref_prefill()).max() > 1e-3


def test_loss_and_every_gradient_with_embeds_match_the_reference():
    _, pcfg = _cfgs()
    want_loss, want = ref_loss()
    loss, grads = port_loss_and_grads_at(pcfg, port_params(), batch())
    np.testing.assert_allclose(loss, want_loss, **TOL)
    # the embedding takes no gradient from a batch of embeds
    assert not np.any(grads["embed"]) and not np.any(want["embed"])
    assert_trees_close(grads, want, **TOL)


def test_paged_server_tokens_equal_the_reference_server():
    """Text prompts of 5, 11, 3 and 9 tokens through both paged servers
    (prefill chunk 4, 2 slots): positions broadcast to [3, b, s]."""
    cfg, pcfg = _cfgs()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in (5, 11, 3, 9)]
    geom = dict(page_size=4, num_pages=40, pages_per_slot=8)
    jserver, _ = jax_server(
        cfg, JaxServerConfig(batch_slots=2, prefill_chunk=4,
                             paged=JaxPagedConfig(**geom)),
        jax.tree.map(jnp.asarray, weights()), topo=jax_atp_topo(1, 1, 1))
    pserver, _ = serve.make_paged_server(
        pcfg, ServerConfig(batch_slots=2, prefill_chunk=4,
                           paged=PagedConfig(**geom)),
        convert.tree_to_torch(weights()), topo=TOPO, device="cpu")
    for rid, p in enumerate(prompts):
        jserver.submit(JaxRequest(rid=rid, prompt=p, max_new=5))
        pserver.submit(Request(rid=rid, prompt=p, max_new=5))
    assert pserver.run_until_drained() == jserver.run_until_drained()
    want = {r.rid: r.out for r in jserver.completed}
    got = {r.rid: r.out for r in pserver.completed}
    assert len(got) == len(prompts) and got == want


# ---------------------------------------------------------------------------
# A gloo mesh whose attention splits the query rows (r = 2).
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Every rank's results on (1, 2, 2) with 2 heads: one spawn."""
    _, pcfg = _cfgs(2)
    assert layers.make_attn_plan(lm.layout_context(atp_topo(*MESH), 0), 2,
                                 2).r == 2
    case = tmp_path_factory.mktemp("qwen2vl_mesh")
    np.savez(case / "params.npz", **_flat(weights(2)))
    np.savez(case / "batch.npz", **batch(2))
    (case / "case.json").write_text(json.dumps(dict(mesh=MESH, heads=2)))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(case)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(int(np.prod(MESH)))]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} failed:\n{log}"
        return [np.load(case / f"rank{r}.npz") for r in range(len(procs))]
    finally:  # a rank that died leaves the others waiting in a collective
        for p in procs:
            p.kill()


def test_prefill_logits_on_a_query_split_match_the_reference(mesh_run):
    """Each rank's vocab shard (over ax1) of the last position's logits,
    against the reference's on one device."""
    want = ref_prefill(2)
    vl = want.shape[-1] // MESH[1]
    for r, got in enumerate(mesh_run):
        i1 = r // MESH[2]
        np.testing.assert_allclose(got["prefill"],
                                   want[:, i1 * vl:(i1 + 1) * vl], **TOL,
                                   err_msg=f"rank {r}")


def test_the_references_query_split_departs_from_one_device():
    """Under jax 0.9.0 the reference's cache-free attention with its query
    rows split over r = 2 ranks does not give its one-device logits (a
    token prefill of a 2-head llama3-8b departs too), where the port's
    does (ROADMAP §C): this pins the departure the test above steps
    around."""
    assert np.abs(ref_prefill(2, MESH) - ref_prefill(2)).max() > 1e-2


def test_gradients_on_a_query_split_match_the_reference(mesh_run):
    """The loss on every rank and the global gradients reassembled from
    every rank's shard, against the reference's on one device."""
    want_loss, want = ref_loss(2)
    _, pcfg = _cfgs(2)
    per_rank = []
    for r, got in enumerate(mesh_run):
        np.testing.assert_allclose(got["loss"], want_loss, **TOL)
        per_rank.append(_unflat_into(port_params(2, MESH, r), got))
    assert_trees_close(convert.params_to_numpy(pcfg, per_rank,
                                               atp_topo(*MESH)), want, **TOL)
