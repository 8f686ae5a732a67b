"""musicgen-medium (a dense LayerNorm model with a gelu MLP, no RoPE, head
dim 64) in the port against the reference, on the CPU.

Reduced musicgen-medium takes fp32 weights from the reference's
``init_params``, which cross as numpy.  Tolerance 1e-4 in fp32, as in
``test_torch_train.py``:
  - training: the loss and every gradient, and three plain AdamW steps, on
    one device and on a gloo mesh (1, 2, 2) (``_torch_train_worker.py``:
    each rank's gradients and updated parameters against the reference's
    single-device ones cut to its shard);
  - serving: the paged step's logits call by call and the greedy picks,
    on one device and on (1, 2, 2) (``_torch_atp_worker.py``), and the
    paged server's greedy tokens against the reference's server.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.launch.serve import make_paged_server as jax_server  # noqa: E402
from repro.core.mesh import atp_topo as jax_atp_topo  # noqa: E402
from repro.models.paging import PagedConfig as JaxPagedConfig  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.runtime.server import Request, ServerConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_config as port_config  # noqa: E402
from repro_torch.core.atp import make_context  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.paging import PagedConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.server import Request as PortRequest  # noqa: E402
from repro_torch.runtime.server import ServerConfig as PortServerConfig  # noqa: E402

import test_torch_atp as atp  # noqa: E402
from test_torch_train import (OPT, ROOT, STEPS, TOL, WORKER, _flat,  # noqa: E402
                              assert_trees_close, jax_loss_and_grads,
                              jax_params, jax_train_steps, make_batch,
                              port_loss_and_grads)

ARCH = "musicgen-medium"
MESH = (1, 2, 2)
TOPO = atp_topo(1, 1, 1)


def test_the_reduced_config_is_layernorm_gelu_without_rope():
    cfg = port_config(ARCH).reduced()
    assert (cfg.norm_kind, cfg.mlp_kind, cfg.use_rope) == ("layernorm",
                                                            "gelu", False)
    assert cfg.hd == 32 and port_config(ARCH).hd == 64


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's weights, three batches, the loss and gradients of
    the first, and its three plain AdamW steps (losses, parameters)."""
    cfg, params = jax_params(ARCH)
    batches = [make_batch(cfg, 2, 12, seed=30 + i) for i in range(STEPS)]
    loss, grads = jax_loss_and_grads(cfg, params, batches[0])
    steps = jax_train_steps(cfg, params, batches, jax_adamw.AdamWConfig(
        mode="plain", **OPT))
    return params, batches, loss, grads, steps


def test_loss_and_every_gradient_match_the_reference():
    params, batches, want_loss, want, _ = _reference()
    loss, grads = port_loss_and_grads(ARCH, params, batches[0])
    np.testing.assert_allclose(loss, want_loss, **TOL)
    assert_trees_close(grads, want, **TOL)


def test_three_plain_adamw_steps_match_the_reference():
    params, batches, _, _, (want_losses, want) = _reference()
    cfg = port_config(ARCH).reduced()
    step, info = build_train_step(cfg, TOPO, adamw.AdamWConfig(
        mode="plain", **OPT), remat=True, device="cpu")
    tp = convert.params_from_jax(cfg, params, TOPO, 0)
    state = adamw.init_opt_state(tp, info.ctx, "plain")
    losses = []
    for bt in batches:
        tp, state, m = step(tp, state, {k: torch.from_numpy(v)
                                        for k, v in bt.items()})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want_losses, **TOL)
    assert_trees_close(convert.params_to_numpy(cfg, [tp], TOPO), want[-1],
                       **TOL)


def test_gloo_mesh_gradients_and_steps_match_the_reference(tmp_path):
    """Each rank of (1, 2, 2): the loss and its gradients (the LayerNorms'
    scales and biases, split over tp2, reduced once), then three plain
    AdamW steps, against the reference's single-device ones cut to its
    shard."""
    params, batches, want_loss, want_grads, (losses, after) = _reference()
    np.savez(tmp_path / "params.npz", **_flat(params))
    np.savez(tmp_path / "batches.npz", **{
        f"{k}{n}": v for n, bt in enumerate(batches) for k, v in bt.items()})
    (tmp_path / "case.json").write_text(json.dumps(dict(
        arch=ARCH, mesh=MESH, chunks=1, mode="plain", steps=STEPS,
        layers=None)))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    world = int(np.prod(MESH))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r),
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:  # a rank that died leaves the others waiting in a collective
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    cfg = port_config(ARCH).reduced()
    topo = atp_topo(*MESH)
    for r in range(world):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_allclose(got["loss"], want_loss, **TOL)
        for name, tree in (("grad", want_grads), ("param", after[-1])):
            want = _flat(lm.tree_map(lambda t: t.numpy(),
                                     convert.params_from_jax(cfg, tree, topo,
                                                             r)))
            for key, w in want.items():
                np.testing.assert_allclose(got[f"{name}/{key}"], w, **TOL,
                                           err_msg=f"rank {r} {name} {key}")
        np.testing.assert_allclose(got["losses"], losses, **TOL)


def test_paged_step_logits_match_the_reference():
    """Two prefill chunks of one slot, one of another, two decode ticks of
    both (``test_torch_atp._calls``), call by call, and the greedy picks."""
    _, params, calls, _, want = atp._reference(ARCH)
    cfg = port_config(ARCH).reduced()
    ctx = make_context(TOPO, device_type="cpu")
    tparams = convert.params_from_jax(cfg, jax.tree.map(np.asarray, params),
                                      TOPO, 0)
    caches = lm.init_paged_caches(cfg, ctx, PagedConfig(**atp.PAGED),
                                  dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for i, ((tok, start, table, _), w) in enumerate(zip(calls, want)):
            got, caches = lm.paged_step(
                ctx, cfg, tparams, torch.as_tensor(tok),
                torch.as_tensor(start), torch.as_tensor(table), caches)
            np.testing.assert_allclose(got.numpy(), w, **TOL,
                                       err_msg=f"call {i}")
            np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                          w.argmax(-1))


def test_gloo_mesh_paged_step_matches_the_reference(tmp_path):
    """The same calls on (1, 2, 2): each tp2 rank's logits gathered over
    tp1, and every rank's vocab-parallel greedy pick."""
    want = atp._reference(ARCH)[4]
    ranks = atp._spawn(tmp_path, ARCH, MESH, chunks=1)
    _, d1, d2 = MESH
    for i, ref in enumerate(want):
        for i2 in range(d2):
            got = np.concatenate([ranks[i1 * d2 + i2][f"logits{i}"]
                                  for i1 in range(d1)], axis=-1)
            np.testing.assert_allclose(got, ref, **TOL,
                                       err_msg=f"call {i} tp2 rank {i2}")
        for r in range(len(ranks)):
            np.testing.assert_array_equal(ranks[r][f"pick{i}"],
                                          ref.argmax(-1))


def test_paged_server_tokens_equal_the_references():
    params = jax.tree.map(np.asarray, _reference()[0])
    cfg = port_config(ARCH).reduced()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in (5, 11, 3, 9)]
    geom = dict(page_size=4, num_pages=40, pages_per_slot=8)
    js, _ = jax_server(jax_params(ARCH)[0], ServerConfig(
        batch_slots=2, prefill_chunk=4, paged=JaxPagedConfig(**geom)),
        params, topo=jax_atp_topo(1, 1, 1))
    ps, _ = port_serve.make_paged_server(
        cfg, PortServerConfig(batch_slots=2, prefill_chunk=4,
                              paged=PagedConfig(**geom)),
        convert.tree_to_torch(params), topo=TOPO, device="cpu")
    for rid, p in enumerate(prompts):
        js.submit(Request(rid=rid, prompt=p, max_new=5))
        ps.submit(PortRequest(rid=rid, prompt=p, max_new=5))
    assert ps.run_until_drained() == js.run_until_drained()
    got = {r.rid: r.out for r in ps.completed}
    assert got == {r.rid: r.out for r in js.completed} and len(got) == 4
