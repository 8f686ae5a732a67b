"""The MTP head's loss term against the reference's, on the CPU.

The reference's ``train_loss`` adds ``mtp_loss_weight`` times the MTP
head's cross-entropy on the token two ahead: the head predicts t+2 from
(h_t, emb(t+1)), with the labels rolled by one, over the trunk loss's
count.  No config has an MTP head of its own; ``mtp=True`` gives reduced
qwen1.5-0.5b (tied head, qkv bias) and llama3-8b one, as the reference's
serving smoke does.  fp32 weights from the reference's ``init_params``
cross as numpy; tolerance 1e-4 as in ``test_torch_train.py``:
  - the loss and every gradient, the MTP leaves' too, on one device;
  - one spawn of four gloo ranks (``_torch_train_worker.py``) on
    (1, 2, 2): psum boundaries, then a ``seq_parallel`` plan (the trunk
    leaves the sequence-parallel domain before the head, so the MTP head
    runs without it), each rank's loss and gradients against the
    single-device reference cut to its shard.
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

from repro.configs.registry import get_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_config as port_config  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.models import lm  # noqa: E402

from test_torch_train import (TOL, TOPO, _flat, assert_trees_close,  # noqa: E402
                              jax_loss_and_grads, make_batch,
                              port_loss_and_grads_at)

ARCHS = ["qwen1.5-0.5b", "llama3-8b"]
ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_train_worker.py"


def _mtp(cfg):
    return dataclasses.replace(cfg, mtp=True)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reduced config with an MTP head, its fp32 weights, a batch and
    the reference's single-device loss and gradients."""
    cfg = _mtp(get_config(arch).reduced())
    params = jax.tree.map(np.asarray, jax_lm.init_params(
        cfg, jax.random.PRNGKey(3), jnp.float32))
    batch = make_batch(cfg, 2, 12, seed=5)
    loss, grads = jax_loss_and_grads(cfg, params, batch)
    return params, batch, loss, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_mtp_loss_and_every_gradient_match_the_reference(arch):
    params, batch, want_loss, want_grads = _reference(arch)
    pcfg = _mtp(port_config(arch).reduced())
    loss, grads = port_loss_and_grads_at(
        pcfg, convert.params_from_jax(pcfg, params, TOPO, 0), batch)
    np.testing.assert_allclose(loss, want_loss, **TOL)
    assert_trees_close(grads, want_grads, **TOL)
    assert np.abs(want_grads["mtp"]["proj_e"]).max() > 0


def test_the_mtp_term_is_the_weighted_loss_two_ahead():
    """The term itself: the loss with the head minus the trunk's loss (the
    same weights without ``params["mtp"]``) is ``mtp_loss_weight`` times a
    cross-entropy, positive and of the order of log(vocab)."""
    arch = "llama3-8b"
    params, batch, want_loss, _ = _reference(arch)
    pcfg = _mtp(port_config(arch).reduced())
    plain = dataclasses.replace(pcfg, mtp=False)
    trunk = {k: v for k, v in params.items() if k != "mtp"}
    base, _ = port_loss_and_grads_at(
        plain, convert.params_from_jax(plain, trunk, TOPO, 0), batch)
    term = (want_loss - base) / pcfg.mtp_loss_weight
    assert 0.5 * np.log(pcfg.vocab_size) < term < 2 * np.log(pcfg.vocab_size)


def test_mtp_gradients_on_a_gloo_mesh_match_the_reference(tmp_path):
    """(1, 2, 2) with psum boundaries and with ``seq_parallel``: the MTP
    head's projections are column-first over (tp2, tp1), its input h
    conjugated over tp1 (or, under ``seq_parallel``, reduced by the exit
    gather), its regather over tp1 and its block under a context without
    the sequence-parallel spec."""
    arch = ARCHS[1]
    params, batch, want_loss, want_grads = _reference(arch)
    np.savez(tmp_path / "params.npz", **_flat(params))
    np.savez(tmp_path / "batches.npz",
             **{f"{k}0": v for k, v in batch.items()})
    cases = [dict(name=name, arch=arch, mtp=True, mesh=[1, 2, 2], chunks=1,
                  seq_parallel=sp, mode=None, steps=0)
             for name, sp in (("psum", False), ("seq_parallel", True))]
    (tmp_path / "case.json").write_text(json.dumps(dict(cases=cases)))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r),
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(4)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:  # a rank that died leaves the others waiting in a collective
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    pcfg = _mtp(port_config(arch).reduced())
    topo = atp_topo(1, 2, 2)
    for case in cases:
        for r in range(4):
            got = np.load(tmp_path / f"{case['name']}_rank{r}.npz")
            np.testing.assert_allclose(got["loss"], want_loss, **TOL)
            want = _flat(lm.tree_map(lambda t: t.numpy(),
                                     convert.params_from_jax(
                                         pcfg, want_grads, topo, r)))
            for key, w in want.items():
                np.testing.assert_allclose(
                    got[f"grad/{key}"], w, **TOL,
                    err_msg=f"{case['name']} rank {r} grad {key}")


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-2b"])
def test_train_step_launches_match_chip_smoke_model_with_a_head(monkeypatch,
                                                                arch):
    """One CPU ``build_train_step`` step (remat on) of a model with an MTP
    head, every kernel wrapper counted as the card would launch it,
    against the launch model ``chip_smoke.py`` asserts on the card: the
    head's projections, dense block, norm and second head GEMM once
    forward and once backward (no remat unit holds them)."""
    from test_torch_gpt_train import BACKWARD, FORWARD, _launches, \
        _load_chip_smoke

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw

    cs = _load_chip_smoke()
    cfg = _mtp(port_config(arch).reduced())
    counts = {k: 0 for k in [*FORWARD.values(), *BACKWARD.values()]}

    def counted(name, fn, key):
        def call(*args, **kw):
            counts[key] += _launches(name, args, kw)
            return fn(*args, **kw)
        return call

    for name, key in {**FORWARD, **BACKWARD}.items():
        monkeypatch.setattr(ops, name, counted(name, getattr(ops, name), key))
    topo = atp_topo(1, 1, 1)
    params = lm.shard_params(cfg, lm.init_params(cfg, seed=0, device="cpu",
                                                 dtype=torch.float32),
                             lm.layout_context(topo, 0))
    step, info = build_train_step(cfg, topo, adamw.AdamWConfig(),
                                  device="cpu")
    state = adamw.init_opt_state(params, info.ctx, "zero1")
    batch = make_batch(cfg, 1, 16, seed=1)
    step(params, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    fwd, bwd = cs.train_launches_per_step(cfg, remat=True)
    plain = cs.train_launches_per_step(dataclasses.replace(cfg, mtp=False),
                                       remat=True)
    assert counts == {**fwd, **bwd}
    assert fwd["matmul"] - plain[0]["matmul"] == 7
    assert fwd["flash_attention"] - plain[0]["flash_attention"] == 1
