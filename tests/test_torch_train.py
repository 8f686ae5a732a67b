"""The port's training step against the JAX package on one device.

Weights come from the JAX ``lm.init_params`` (fp32) and cross as numpy
through ``repro_torch.convert.params_from_jax``; tokens and labels are made
from a seed with numpy.  The JAX side is the reference's own
``jax.value_and_grad(lm.train_loss)`` inside ``shard_map`` on one device,
and its ``build_train_step`` for the optimizer steps.  Everything runs in
fp32 on the CPU, where the port's kernels take their plain forward and
backward versions.  Tolerance 1e-4 (relative and absolute): the two sides
sum in different orders, nothing else differs.  The gloo meshes start
four ranks of ``_torch_train_worker.py`` each.

zamba2-7b runs ``.reduced()`` with 5 layers: two super-blocks (the shared
attention block and one Mamba2 block each) and a one-block Mamba2 tail, so
both recurrent segment kinds train; its sequence of 32 positions is two
SSD chunks.
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
from repro.launch.steps import build_train_step as jax_build_train_step  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_config as port_config  # noqa: E402
from repro_torch.core.atp import make_context  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["llama3-8b", "qwen1.5-0.5b", "gemma2-2b", "gpt-m1", "zamba2-7b"]
#: (batch, sequence) of the loss: gemma2's sequence outruns its reduced
#: 16-token window; zamba2's covers two of its reduced 16-position SSD
#: chunks
SHAPE = {"gemma2-2b": (2, 24), "zamba2-7b": (2, 32)}
#: depth of the reduced configs where it is not ``.reduced()``'s
LAYERS = {"zamba2-7b": 5}
TOPO = atp_topo(1, 1, 1)


def reduced(config, arch):
    """``config`` (the JAX package's or the port's ``get_config``) of
    ``arch``, reduced, at its ``LAYERS`` depth."""
    cfg = config(arch).reduced()
    if arch in LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=LAYERS[arch])
    return cfg


def jax_params(arch, seed=0):
    """The reduced config and its JAX fp32 weights; a zero-initialised qkv
    bias gets random values, so its path adds something."""
    cfg = reduced(get_config, arch)
    params = jax_lm.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    if cfg.qkv_bias:
        rng = np.random.default_rng(1)
        attn = params["seg0"]["attn"]
        for k in ("bq", "bk", "bv"):
            attn[k] = jnp.asarray(rng.normal(size=attn[k].shape) * 0.1,
                                  jnp.float32)
    return cfg, jax.tree.map(np.asarray, params)


def make_batch(cfg, b, s, seed=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1), dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -2:] = -1   # ignored labels: no loss, but in the mean's count
    return {"tokens": toks[:, :-1], "labels": labels}


def jax_loss_and_grads(cfg, params, batch):
    topo = JaxMeshTopo((("data", 1),))
    ctx = jax_make_context(topo)

    def f(p, bt):
        return jax.value_and_grad(
            lambda q: jax_lm.train_loss(ctx, cfg, q, bt, remat=False))(p)

    g = jax.jit(shard_map(f, mesh=topo.build(jax.devices()[:1]),
                          in_specs=(P(), P()), out_specs=(P(), P()),
                          check_vma=True))
    loss, grads = g(params, batch)
    return float(loss), jax.tree.map(np.asarray, grads)


def port_loss_and_grads(arch, params, batch, remat=False):
    pcfg = reduced(port_config, arch)
    return port_loss_and_grads_at(
        pcfg, convert.params_from_jax(pcfg, params, TOPO, 0), batch, remat)


def port_loss_and_grads_at(pcfg, tp, batch, remat=False):
    """The port's loss and gradients at its own parameters ``tp`` (left
    unchanged), the gradients in the reference's tree."""
    ctx = make_context(TOPO, device_type="cpu")
    tp = lm.tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    leaves = adamw.tree_leaves(tp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = lm.train_loss(ctx, pcfg, tp, tb, remat=remat)
    grads = adamw.tree_unflatten(tp, iter(torch.autograd.grad(loss, leaves)))
    return float(loss.detach()), convert.params_to_numpy(pcfg, [grads], TOPO)


def assert_trees_close(got, want, **tol):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == len(jax.tree.leaves(got))
    for path, w in flat_w:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, w, **tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    """llama3-8b (GQA, rope), qwen1.5-0.5b (qkv bias, tied head),
    gemma2-2b (softcaps, window, post-block norms, embedding scale, 1 +
    gamma), gpt-m1 (layernorm with bias, gelu in the matmul epilogue) and
    zamba2-7b (Mamba2 blocks through the SSD scan's and the grouped, gated
    norm's backward; the shared block on the embedding output): the loss
    and the gradient of every parameter, norm scales and biases
    included."""
    cfg, params = jax_params(arch)
    batch = make_batch(cfg, *SHAPE.get(arch, (2, 12)))
    want_loss, want = jax_loss_and_grads(cfg, params, batch)
    loss, got = port_loss_and_grads(arch, params, batch)
    np.testing.assert_allclose(loss, want_loss, **TOL)
    assert_trees_close(got, want, **TOL)


def _remat_gives_identical_gradients(arch):
    cfg, params = jax_params(arch)
    batch = make_batch(cfg, *SHAPE.get(arch, (2, 12)))
    plain = port_loss_and_grads(arch, params, batch, remat=False)
    remat = port_loss_and_grads(arch, params, batch, remat=True)
    assert plain[0] == remat[0]
    assert_trees_close(remat[1], plain[1], rtol=0, atol=0)


def test_remat_gives_identical_gradients():
    _remat_gives_identical_gradients("llama3-8b")


def test_zamba_remat_gives_identical_gradients():
    """Each zamba super-block (the shared block and its Mamba2 blocks) and
    each tail Mamba2 block recomputed in the backward."""
    _remat_gives_identical_gradients("zamba2-7b")


def test_prefill_logits_match_jax():
    cfg, params = jax_params("qwen1.5-0.5b")
    batch = make_batch(cfg, 2, 10)
    topo = JaxMeshTopo((("data", 1),))
    ctx = jax_make_context(topo)
    g = jax.jit(shard_map(lambda p, t: jax_lm.prefill_logits(ctx, cfg, p, t),
                          mesh=topo.build(jax.devices()[:1]),
                          in_specs=(P(), P()), out_specs=P(),
                          check_vma=True))
    want = np.asarray(g(params, {"tokens": batch["tokens"]}))
    pcfg = port_config("qwen1.5-0.5b").reduced()
    with torch.no_grad():
        got = lm.prefill_logits(make_context(TOPO, device_type="cpu"), pcfg,
                                convert.params_from_jax(pcfg, params, TOPO, 0),
                                {"tokens": torch.from_numpy(batch["tokens"])})
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def jax_train_steps(cfg, params, batches, opt):
    """The reference's single-device ``build_train_step``: the losses and
    the parameters after each step."""
    topo = JaxMeshTopo((("data", 1), ("tp1", 1), ("tp2", 1)))
    fn, info = jax_build_train_step(cfg, topo, opt, remat=False)
    state = jax_adamw.init_opt_state(params, info.pspecs, info.ctx, opt.mode)
    p, losses, after = jax.tree.map(jnp.asarray, params), [], []
    for bt in batches:
        p, state, m = fn(p, state, bt)
        losses.append(float(m["loss"]))
        after.append(jax.tree.map(np.asarray, p))
    return losses, after


ROOT = Path(__file__).resolve().parents[1]
#: one rank of the gloo meshes (the end of this file)
WORKER = Path(__file__).resolve().parent / "_torch_train_worker.py"
STEPS = 3
#: the reference's three AdamW steps (plain on one device: with dp = 2,
#: zero1 is full-state Adam on the dp-summed gradient, the same update)
OPT = dict(warmup_steps=2)
#: the archs whose reference also takes ``STEPS`` plain AdamW steps
STEP_ARCHS = ("llama3-8b", "zamba2-7b")


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The JAX weights, the global batches, and the single-device loss and
    gradients of batch 0 and losses and parameters after ``STEPS`` plain
    steps (``STEP_ARCHS`` only)."""
    cfg, params = jax_params(arch)
    batches = [make_batch(cfg, *SHAPE.get(arch, (2, 12)), seed=10 + i)
               for i in range(STEPS)]
    loss, grads = jax_loss_and_grads(cfg, params, batches[0])
    steps = None
    if arch in STEP_ARCHS:
        steps = jax_train_steps(cfg, params, batches, jax_adamw.AdamWConfig(
            mode="plain", **OPT))
    return params, batches, loss, grads, steps


def _three_plain_adamw_steps(arch):
    """The port's ``STEPS`` plain AdamW steps from the reference's weights
    on its batches: the losses, and the parameters before each step and
    after the last, in the reference's tree."""
    params, batches, _, _, _ = _reference(arch)
    pcfg = reduced(port_config, arch)
    step, info = build_train_step(pcfg, TOPO,
                                  adamw.AdamWConfig(mode="plain", **OPT),
                                  remat=False, device="cpu")
    tp = convert.params_from_jax(pcfg, params, TOPO, 0)
    state = adamw.init_opt_state(tp, info.ctx, "plain")

    def copy(tree):   # the step updates the parameters in place
        return lm.tree_map(lambda t: t.detach().clone(), tree)

    losses, seen = [], [copy(tp)]
    for bt in batches:
        tp, state, m = step(tp, state, {k: torch.from_numpy(v)
                                        for k, v in bt.items()})
        losses.append(float(m["loss"]))
        seen.append(copy(tp))
    assert state["step"] == STEPS
    return losses, seen, pcfg


def test_three_plain_adamw_steps_match_jax():
    _, _, _, _, (want_losses, want) = _reference("llama3-8b")
    losses, seen, pcfg = _three_plain_adamw_steps("llama3-8b")
    np.testing.assert_allclose(losses, want_losses, **TOL)
    assert_trees_close(convert.params_to_numpy(pcfg, [seen[-1]], TOPO),
                       want[-1], **TOL)


#: a gradient element this small on both sides is inside their fp32 noise:
#: the gradient test's absolute limit
NOISE = TOL["atol"]


def test_zamba_three_plain_adamw_steps_match_jax():
    """Adam moves an element by about lr whatever the size of its gradient
    once that is above eps (1e-8 here, on both sides), so an element whose
    gradient is inside the two fp32 sides' noise in some step takes a
    +-lr step of a random sign there.  Reduced zamba2-7b has such elements
    (once-seen tokens' embedding rows): every element beyond TOL must have
    had a gradient below ``NOISE`` on both sides, each at its own
    parameters, in some step; every other element is held to TOL."""
    params, batches, _, _, (want_losses, want) = _reference("zamba2-7b")
    losses, seen, pcfg = _three_plain_adamw_steps("zamba2-7b")
    np.testing.assert_allclose(losses, want_losses, **TOL)
    cfg = reduced(get_config, "zamba2-7b")
    noisy = None
    for i, bt in enumerate(batches):
        g_jax = jax_loss_and_grads(cfg, params if i == 0 else want[i - 1],
                                   bt)[1]
        g_port = port_loss_and_grads_at(pcfg, seen[i], bt)[1]
        both = jax.tree.map(lambda a, b: (np.abs(a) < NOISE)
                            & (np.abs(b) < NOISE), g_jax, g_port)
        noisy = both if noisy is None else jax.tree.map(np.logical_or, noisy,
                                                        both)
    got = convert.params_to_numpy(pcfg, [seen[-1]], TOPO)
    flat_w = jax.tree_util.tree_flatten_with_path(want[-1])[0]
    exempt = 0
    for path, w in flat_w:
        g, quiet = got, noisy
        for k in path:
            g, quiet = g[k.key], quiet[k.key]
        far = ~np.isclose(g, w, **TOL)
        assert not (far & ~quiet).any(), (
            f"{jax.tree_util.keystr(path)}: {int((far & ~quiet).sum())} "
            f"elements beyond TOL with a gradient above {NOISE}")
        np.testing.assert_allclose(g[~quiet], w[~quiet], **TOL,
                                   err_msg=jax.tree_util.keystr(path))
        exempt += int(far.sum())
    assert exempt < 100, f"{exempt} elements beyond TOL"


def test_adamw_refuses_what_is_not_ported():
    """What the training step refuses: an AdamW mode the JAX package does
    not have (plain, zero1 and compressed are ported).  A ring boundary
    (ROADMAP A8, ported) builds a step that takes one CPU step from the
    JAX weights with the single device's loss."""
    from repro_torch.core.plan import ParallelPlan

    pcfg = port_config("llama3-8b").reduced()
    tp = convert.params_from_jax(pcfg, jax_params("llama3-8b")[1], TOPO, 0)
    ctx = make_context(TOPO, device_type="cpu")
    with pytest.raises(ValueError, match="unknown AdamW mode"):
        adamw.init_opt_state(tp, ctx, "lion")
    state = adamw.init_opt_state(tp, ctx, "plain")
    with pytest.raises(ValueError, match="unknown AdamW mode"):
        adamw.apply_adamw(adamw.AdamWConfig(mode="lion"), ctx, tp, tp, state)
    step, info = build_train_step(pcfg, device="cpu", plan=ParallelPlan(
        d1=1, d2=1, boundary_mode="ring"))
    assert info.ctx.boundary_mode == "ring"
    cfg, params = jax_params("llama3-8b")
    batch = make_batch(cfg, 2, 12)
    _, _, metrics = step(tp, adamw.init_opt_state(tp, info.ctx, "plain"),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]),
                               jax_loss_and_grads(cfg, params, batch)[0],
                               **TOL)
    assert adamw.lr_at(adamw.AdamWConfig(warmup_steps=2), 0) == 1.5e-4


#: the card's training path check holds a gradient to this relative L2
#: error against fp32 (``chip_smoke.py``'s ``PATH_TOL``)
PATH_TOL = 5e-2


def reference_bf16_gradient_errors(arch):
    """Per leaf of the reference's reduced ``arch``, the relative L2 error
    of its own bf16 gradients against its fp32 gradients from the same
    (bf16) weights and batch."""
    cfg = reduced(get_config, arch)
    params = jax_lm.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    batch = make_batch(cfg, *SHAPE.get(arch, (2, 12)))
    g16 = jax_loss_and_grads(cfg, params, batch)[1]
    g32 = jax_loss_and_grads(cfg, jax.tree.map(
        lambda t: t.astype(jnp.float32), params), batch)[1]
    return {jax.tree_util.keystr(path): float(
        np.linalg.norm(np.float32(g) - w) / np.linalg.norm(w))
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(g32)[0],
                                jax.tree.leaves(g16))}


def test_reference_bf16_gradients_of_llama_stay_near_fp32():
    """The dense model in bf16: every gradient within the path check's
    limit of fp32."""
    errs = reference_bf16_gradient_errors("llama3-8b")
    assert max(errs.values()) < PATH_TOL, errs


def test_reference_bf16_gradients_of_zamba_are_far_from_fp32():
    """zamba2-7b in bf16, in the reference itself: the gradients upstream
    of the last Mamba2 block are O(1) from fp32, while the head's and the
    final norm's stay within the path check's limit.  This is why the
    card's zamba path check holds its gradients against the plain bf16
    path's own error and against the plain backward on the same forward,
    not against fp32 alone."""
    errs = reference_bf16_gradient_errors("zamba2-7b")
    assert max(errs.values()) > 0.5, errs
    for leaf in ("['lm_head']", "['final_norm']['scale']"):
        assert errs[leaf] < PATH_TOL, errs


def test_zamba_bf16_gradient_error_enters_at_the_grouped_norm(monkeypatch):
    """Where the bf16 error comes from, in the port's plain path (reduced,
    5 layers, b = 1, s = 64), bf16 against fp32 from the same weights: at
    the last Mamba2 block the gradient at the grouped norm's input is
    several times farther from fp32 than at its output, and the row that
    carries most of that error has a small RMS and a bf16 value far off
    relative to it (its terms cancel), so the norm's 1/RMS scales a wrong
    direction up."""
    cfg = reduced(port_config, "zamba2-7b")
    params = lm.shard_params(cfg, lm.init_params(cfg, seed=0, device="cpu"),
                             lm.layout_context(TOPO, 0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 65))
    batch = {"tokens": torch.tensor(toks[:, :-1], dtype=torch.int32),
             "labels": torch.tensor(toks[:, 1:], dtype=torch.int32)}
    seen, norm = [], ops.group_rmsnorm

    def recorded(y, gamma, eps=1e-6, *, gate=None):
        rec = {"y": y.detach().float()}
        out = norm(y, gamma, eps, gate=gate)
        y.register_hook(lambda g: rec.__setitem__("dy", g.float()))
        out.register_hook(lambda g: rec.__setitem__("dout", g.float()))
        seen.append(rec)
        return out

    monkeypatch.setattr(ops, "group_rmsnorm", recorded)
    ctx = make_context(TOPO, device_type="cpu")
    last = {}
    for dtype in (torch.bfloat16, torch.float32):
        p = lm.tree_map(lambda t: t.detach().to(
            t.dtype if dtype == torch.bfloat16 else torch.float32)
            .requires_grad_(True), params)
        seen.clear()
        lm.train_loss(ctx, cfg, p, batch, remat=False).backward()
        last[dtype] = seen[-1]
    b16, f32 = last[torch.bfloat16], last[torch.float32]

    def rel(k):
        return float((b16[k] - f32[k]).norm() / f32[k].norm())

    assert rel("dy") > 3 * rel("dout"), (rel("dy"), rel("dout"))
    rms = f32["y"].pow(2).mean(-1).sqrt().flatten()
    share = (b16["dy"] - f32["dy"]).pow(2).sum(-1).flatten()
    worst = int(share.argmax())
    off = float((b16["y"] - f32["y"]).pow(2).mean(-1).sqrt().flatten()[worst]
                / rms[worst])
    assert rms[worst] < rms.median() / 5, (rms[worst], rms.median())
    assert off > 0.1, off


def test_trainer_trains_zamba_on_the_cpu():
    """``launch.train.main --arch zamba2-7b``: two zero1 AdamW steps of
    reduced zamba2-7b at 5 layers (both recurrent segment kinds) on the
    CPU, remat on, as the trainer runs it on the card."""
    from repro_torch.launch import train

    hist = train.main(["--arch", "zamba2-7b", "--reduced", "--device", "cpu",
                       "--layers", "5", "--seq", "20", "--batch", "2",
                       "--steps", "2"])
    assert len(hist) == 2
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in hist)


@pytest.mark.parametrize("corpus", [False, True])
def test_token_source_matches_jax_package(tmp_path, corpus):
    """The copied data pipeline gives the reference's batches, from the
    synthetic stream and from a memmap corpus of uint16 tokens."""
    from repro.data.pipeline import DataConfig as JaxDataConfig
    from repro.data.pipeline import TokenSource as JaxTokenSource
    from repro_torch.data.pipeline import DataConfig, TokenSource

    path = None
    if corpus:
        path = str(tmp_path / "corpus.u16")
        np.random.default_rng(3).integers(0, 512, 4000).astype(
            np.uint16).tofile(path)
    args = (512, 16, 4)
    port = TokenSource(DataConfig(*args, seed=7, corpus_path=path))
    want = JaxTokenSource(JaxDataConfig(*args, seed=7, corpus_path=path))
    for step in (0, 5):
        got, exp = port.host_batch(step, 1, 2), want.host_batch(step, 1, 2)
        assert got.keys() == exp.keys()
        for k in got:
            assert got[k].dtype == np.int32 and got[k].shape == (2, 16)
            np.testing.assert_array_equal(got[k], exp[k])
        np.testing.assert_array_equal(got["tokens"][:, 1:],
                                      got["labels"][:, :-1])


def test_trainer_reads_a_corpus_file(tmp_path):
    """``launch.train.main --corpus`` trains on the file's tokens: two
    plain AdamW steps of reduced llama3-8b on the CPU."""
    from repro_torch.launch import train

    path = tmp_path / "corpus.u16"
    np.random.default_rng(4).integers(0, 512, 3000).astype(
        np.uint16).tofile(path)
    hist = train.main(["--arch", "llama3-8b", "--reduced", "--device", "cpu",
                       "--layers", "1", "--seq", "16", "--batch", "2",
                       "--steps", "2", "--opt-mode", "plain",
                       "--corpus", str(path)])
    assert len(hist) == 2
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in hist)
    with pytest.raises(FileNotFoundError):
        train.main(["--reduced", "--device", "cpu", "--steps", "1",
                    "--corpus", str(tmp_path / "missing")])


# ---------------------------------------------------------------------------
# The plain backward versions against autograd of the plain forward.
# ---------------------------------------------------------------------------


#: the plain versions compute in fp32 (as their kernels do): written-out
#: gradient against autograd, two fp32 sums in different orders
BWD_TOL = dict(rtol=1e-5, atol=1e-5)


def _randn(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


def _autograd(fn, inputs, dy):
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, dy)


@pytest.mark.parametrize("activation", [None, "gelu", "silu"])
def test_plain_matmul_backward_matches_autograd(activation):
    """``ref.matmul_bwd_ref`` and ``ref.epilogue_bwd`` (fp32): dgrad,
    wgrad, the bias gradient and the activation's derivative."""
    rng = np.random.default_rng(0)
    a, b, bias = _randn(rng, 7, 24), _randn(rng, 24, 40), _randn(rng, 40)
    dy = _randn(rng, 7, 40)
    want = _autograd(lambda x, w, c: ref.matmul_ref(x, w, c, activation),
                     (a, b, bias), dy)
    z = ref.matmul_ref(a, b, bias)
    dz = ref.epilogue_bwd(z, dy, activation)
    da, db = ref.matmul_bwd_ref(a, b, dz)
    for got, w in zip((da, db, dz.sum(0)), want):
        torch.testing.assert_close(got, w, **BWD_TOL)
    # and through the autograd Function, a tied head's transposed view too
    a2, w2 = a.clone().requires_grad_(True), b.t().contiguous()
    w2 = w2.requires_grad_(True)
    out = ops.matmul(a2, w2.t(), activation=activation)
    ga, gw = torch.autograd.grad(out, (a2, w2), dy)
    wa, ww = _autograd(lambda x, w: ref.matmul_ref(x, w.t(), None, activation),
                       (a, b.t().contiguous()), dy)
    torch.testing.assert_close(ga, wa, **BWD_TOL)
    torch.testing.assert_close(gw, ww, **BWD_TOL)


@pytest.mark.parametrize("case", [
    dict(b=2, sq=9, skv=9, hq=4, hkv=2, d=16),                    # GQA
    dict(b=1, sq=12, skv=12, hq=2, hkv=2, d=8, window=5),         # window
    dict(b=2, sq=6, skv=6, hq=4, hkv=1, d=8, softcap=5.0),        # softcap
    dict(b=2, sq=4, skv=10, hq=2, hkv=2, d=8, q_offset=(6, 3),
         kv_len=(10, 7)),                                          # ragged
])
def test_plain_attention_backward_matches_autograd(case):
    """``ref.attention_bwd_ref`` from the forward's log-sum-exp against
    autograd of ``ref.attention_ref`` (fp32), and the log-sum-exp
    against the scores' own."""
    c = {"window": 0, "softcap": 0.0, "q_offset": None, "kv_len": None,
         **case}
    rng = np.random.default_rng(1)
    b, sq, skv = c["b"], c["sq"], c["skv"]
    q = _randn(rng, b, sq, c["hq"], c["d"])
    k, v = (_randn(rng, b, skv, c["hkv"], c["d"]) for _ in range(2))
    qo = torch.tensor(c["q_offset"] or (0,) * b)
    kl = torch.tensor(c["kv_len"] or (skv,) * b)
    opts = dict(causal=True, window=c["window"], softcap=c["softcap"])
    do = _randn(rng, b, sq, c["hq"], c["d"])
    want = _autograd(lambda *t: ref.attention_ref(*t, qo, kl, **opts),
                     (q, k, v), do)
    out, lse = ref.attention_lse_ref(q, k, v, qo, kl, **opts)
    torch.testing.assert_close(out, ref.attention_ref(q, k, v, qo, kl, **opts))
    got = ref.attention_bwd_ref(q, k, v, out, do, lse, qo, kl, **opts)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BWD_TOL)
    # through the autograd Function
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fn = torch.autograd.grad(ops.flash_attention(*leaves, qo, kl, **opts),
                             leaves, do)
    for g, w in zip(fn, want):
        torch.testing.assert_close(g, w, **BWD_TOL)


@pytest.mark.parametrize("rows,width", [(5, 16), (3, 96)])
def test_plain_rmsnorm_backward_matches_autograd(rows, width):
    rng = np.random.default_rng(2)
    x, gamma = _randn(rng, rows, width), _randn(rng, width)
    dy = _randn(rng, rows, width)
    want = _autograd(lambda a, g: ref.rmsnorm_ref(a, g, 1e-6), (x, gamma), dy)
    got = ref.rmsnorm_bwd_ref(x, gamma, dy, 1e-6)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BWD_TOL)
    fn = _autograd(lambda a, g: ops.rmsnorm(a, g, eps=1e-6), (x, gamma), dy)
    for g, w in zip(fn, want):
        torch.testing.assert_close(g, w, **BWD_TOL)


def _backward_on_the_cpu_counts_no_launch(arch):
    ops.reset_launches()
    cfg, params = jax_params(arch)
    port_loss_and_grads(arch, params, make_batch(cfg, 1, 8))
    assert set(ops.LAUNCHES.values()) == {0}
    assert set(ops.BACKWARD_LAUNCHES.values()) == {0}


def test_backward_on_the_cpu_counts_no_launch():
    """The plain backward versions run on the CPU: no kernel launch of any
    kind is counted, forward or backward."""
    _backward_on_the_cpu_counts_no_launch("llama3-8b")


def test_zamba_backward_on_the_cpu_counts_no_launch():
    """The same through the SSD scan's and the grouped norm's backward."""
    _backward_on_the_cpu_counts_no_launch("zamba2-7b")


@pytest.mark.parametrize("s,chunk", [
    (8, 8),       # one chunk
    (40, 16),     # two chunks of 20 (mamba2.ssd_chunked's rule)
    (37, 16),     # 37 % 2 != 0: chunks of 16, 16 and a ragged 5
])
def test_plain_ssd_backward_matches_autograd(s, chunk):
    """``ref.ssd_bwd_ref`` (written out, chunk by chunk) against autograd
    of ``ref.ssd_ref`` from a zero state (fp32), and through the autograd
    Function of ``ops.ssd_scan``."""
    rng = np.random.default_rng(3)
    b, nh, hd, ds = 2, 3, 4, 5
    x, B, C = _randn(rng, b, s, nh, hd), _randn(rng, b, s, ds), \
        _randn(rng, b, s, ds)
    dt = torch.nn.functional.softplus(_randn(rng, b, s, nh))
    A_log, D = _randn(rng, nh, scale=0.5), _randn(rng, nh)
    dy = _randn(rng, b, s, nh, hd)
    inputs = (x, dt, A_log, B, C, D)
    want = _autograd(lambda *t: ref.ssd_ref(*t, chunk)[0], inputs, dy)
    got = ref.ssd_bwd_ref(*inputs, dy, chunk)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BWD_TOL)
    fn = _autograd(lambda *t: ops.ssd_scan(*t, chunk=chunk)[0], inputs, dy)
    for g, w in zip(fn, want):
        torch.testing.assert_close(g, w, **BWD_TOL)


def test_ssd_scan_under_autograd_refuses_a_state():
    """The training form starts from zeros: a state in, the pool form and a
    gradient through the final state have no backward."""
    rng = np.random.default_rng(4)
    x = _randn(rng, 1, 4, 2, 4).requires_grad_(True)
    dt = torch.nn.functional.softplus(_randn(rng, 1, 4, 2))
    B, C, vec = _randn(rng, 1, 4, 4), _randn(rng, 1, 4, 4), _randn(rng, 2)
    state = torch.zeros(1, 2, 4, 4)
    with pytest.raises(NotImplementedError, match="zero state"):
        ops.ssd_scan(x, dt, vec, B, C, vec, chunk=4, state_in=state)
    with pytest.raises(NotImplementedError, match="zero state"):
        ops.ssd_scan(x, dt, vec, B, C, vec, chunk=4, pool=state,
                     slot=torch.zeros(1, dtype=torch.int32),
                     fresh=torch.ones(1, dtype=torch.bool))
    _, final = ops.ssd_scan(x, dt, vec, B, C, vec, chunk=4)
    with pytest.raises(NotImplementedError, match="final state"):
        torch.autograd.grad(final.sum(), x)


@pytest.mark.parametrize("gated", [False, True])
def test_plain_group_rmsnorm_backward_matches_autograd(gated):
    """``ref.group_rmsnorm_bwd_ref`` against autograd of
    ``ref.group_rmsnorm_ref`` (fp32), with and without the SiLU gate, and
    through the autograd Function of ``ops.group_rmsnorm``."""
    rng = np.random.default_rng(5)
    y, gamma = _randn(rng, 2, 7, 4, 16), _randn(rng, 4, 16)
    gate = _randn(rng, 2, 7, 4, 16, scale=2.0) if gated else None
    dout = _randn(rng, 2, 7, 4, 16)
    inputs = (y, gamma) + ((gate,) if gated else ())
    want = _autograd(lambda *t: ref.group_rmsnorm_ref(
        t[0], t[1], 1e-6, t[2] if gated else None), inputs, dout)
    got = ref.group_rmsnorm_bwd_ref(y, gamma, dout, 1e-6, gate)
    assert (got[2] is None) == (not gated)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BWD_TOL)
    fn = _autograd(lambda *t: ops.group_rmsnorm(
        t[0], t[1], 1e-6, gate=t[2] if gated else None), inputs, dout)
    for g, w in zip(fn, want):
        torch.testing.assert_close(g, w, **BWD_TOL)


# ---------------------------------------------------------------------------
# Gloo meshes: four ranks against the JAX single device.
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("arch,mesh,chunks,mode", [
    ("llama3-8b", (1, 2, 2), 2, None),
    ("llama3-8b", (2, 2, 1), 1, "zero1"),
    ("llama3-8b", (1, 1, 4), 1, None),
    ("llama3-8b", (2, 1, 2), 1, "plain"),
    ("qwen3-8b", (1, 2, 2), 1, None),
    ("zamba2-7b", (1, 2, 2), 1, None),
])
def test_gloo_mesh_gradients_match_jax_single_device(tmp_path, arch, mesh,
                                                     chunks, mode):
    """Each rank's loss and local gradient (summed over dp) against the JAX
    single-device gradient cut to that rank's shard: every replica of a
    TP-replicated leaf (norm scales, qk-norm gains) must carry the full
    gradient, reduced exactly once.  (1, 2, 2) with chunks=2 runs the
    chunked boundary GEMMs forward and backward; (1, 1, 4) splits the q
    heads four ways over tp2 (kv heads shared by two ranks each);
    qwen3-8b's qk-norm gains meet only each rank's heads (``grad_sync``);
    zamba2-7b's Mamba2 blocks split their SSD heads over the four flat
    ranks (``w_bcdt`` synced over tp1, the per-head leaves over both TP
    axes, each once) and its shared block gathers its in-projections over
    tp1.  The dp = 2 meshes then take three AdamW steps, zero1 and plain,
    one batch each split over dp, against the reference's steps on the
    whole batch."""
    params, batches, want_loss, want_grads, want_steps = _reference(arch)
    np.savez(tmp_path / "params.npz", **_flat(params))
    np.savez(tmp_path / "batches.npz", **{
        f"{k}{n}": v for n, bt in enumerate(batches) for k, v in bt.items()})
    (tmp_path / "case.json").write_text(json.dumps(dict(
        arch=arch, mesh=mesh, chunks=chunks, mode=mode,
        steps=STEPS if mode else 0, layers=LAYERS.get(arch))))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    world = int(np.prod(mesh))
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

    cfg = reduced(port_config, arch)
    topo = atp_topo(*mesh)
    for r in range(world):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_allclose(got["loss"], want_loss, **TOL)
        want = _flat(lm.tree_map(lambda t: t.numpy(), convert.params_from_jax(
            cfg, want_grads, topo, r)))
        for key, w in want.items():
            np.testing.assert_allclose(got[f"grad/{key}"], w, **TOL,
                                       err_msg=f"rank {r} grad {key}")
        if mode:
            losses, after = want_steps
            np.testing.assert_allclose(got["losses"], losses, **TOL)
            want = _flat(lm.tree_map(lambda t: t.numpy(),
                                     convert.params_from_jax(cfg, after[-1],
                                                             topo, r)))
            for key, w in want.items():
                np.testing.assert_allclose(got[f"param/{key}"], w, **TOL,
                                           err_msg=f"rank {r} param {key}")
