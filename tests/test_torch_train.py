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
"""
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
ARCHS = ["llama3-8b", "qwen1.5-0.5b", "gemma2-2b", "gpt-m1"]
#: (batch, sequence) of the loss: gemma2's sequence outruns its reduced
#: 16-token window
SHAPE = {"gemma2-2b": (2, 24)}
TOPO = atp_topo(1, 1, 1)


def jax_params(arch, seed=0):
    """The reduced config and its JAX fp32 weights; a zero-initialised qkv
    bias gets random values, so its path adds something."""
    cfg = get_config(arch).reduced()
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
    pcfg = port_config(arch).reduced()
    ctx = make_context(TOPO, device_type="cpu")
    tp = convert.params_from_jax(pcfg, params, TOPO, 0)
    leaves = adamw.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
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
    gamma) and gpt-m1 (layernorm with bias, gelu in the matmul epilogue):
    the loss and the gradient of every parameter, norm scales and biases
    included."""
    cfg, params = jax_params(arch)
    batch = make_batch(cfg, *SHAPE.get(arch, (2, 12)))
    want_loss, want = jax_loss_and_grads(cfg, params, batch)
    loss, got = port_loss_and_grads(arch, params, batch)
    np.testing.assert_allclose(loss, want_loss, **TOL)
    assert_trees_close(got, want, **TOL)


def test_remat_gives_identical_gradients():
    cfg, params = jax_params("llama3-8b")
    batch = make_batch(cfg, 2, 12)
    plain = port_loss_and_grads("llama3-8b", params, batch, remat=False)
    remat = port_loss_and_grads("llama3-8b", params, batch, remat=True)
    assert plain[0] == remat[0]
    assert_trees_close(remat[1], plain[1], rtol=0, atol=0)


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
    the parameters after the steps."""
    topo = JaxMeshTopo((("data", 1), ("tp1", 1), ("tp2", 1)))
    fn, info = jax_build_train_step(cfg, topo, opt, remat=False)
    state = jax_adamw.init_opt_state(params, info.pspecs, info.ctx, opt.mode)
    p, losses = jax.tree.map(jnp.asarray, params), []
    for bt in batches:
        p, state, m = fn(p, state, bt)
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, p)


ROOT = Path(__file__).resolve().parents[1]
#: one rank of the gloo meshes (the end of this file)
WORKER = Path(__file__).resolve().parent / "_torch_train_worker.py"
STEPS = 3
#: the reference's three AdamW steps (plain on one device: with dp = 2,
#: zero1 is full-state Adam on the dp-summed gradient, the same update)
OPT = dict(warmup_steps=2)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The JAX weights, the global batches, and the single-device loss and
    gradients of batch 0 and losses and parameters after ``STEPS`` plain
    steps (llama3-8b only)."""
    cfg, params = jax_params(arch)
    batches = [make_batch(cfg, 2, 12, seed=10 + i) for i in range(STEPS)]
    loss, grads = jax_loss_and_grads(cfg, params, batches[0])
    steps = None
    if arch == "llama3-8b":
        steps = jax_train_steps(cfg, params, batches,
                                jax_adamw.AdamWConfig(mode="plain", **OPT))
    return params, batches, loss, grads, steps


def test_three_plain_adamw_steps_match_jax():
    params, batches, _, _, (want_losses, want) = _reference("llama3-8b")
    pcfg = port_config("llama3-8b").reduced()
    step, info = build_train_step(
        pcfg, TOPO, adamw.AdamWConfig(mode="plain", **OPT), remat=False,
        device="cpu")
    tp = convert.params_from_jax(pcfg, params, TOPO, 0)
    state = adamw.init_opt_state(tp, info.ctx, "plain")
    losses = []
    for bt in batches:
        tp, state, m = step(tp, state, {k: torch.from_numpy(v)
                                        for k, v in bt.items()})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want_losses, **TOL)
    assert state["step"] == 3
    assert_trees_close(convert.params_to_numpy(pcfg, [tp], TOPO), want, **TOL)


def test_adamw_refuses_what_is_not_ported():
    pcfg = port_config("llama3-8b").reduced()
    tp = convert.params_from_jax(pcfg, jax_params("llama3-8b")[1], TOPO, 0)
    ctx = make_context(TOPO, device_type="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A5b"):
        adamw.init_opt_state(tp, ctx, "compressed")
    with pytest.raises(NotImplementedError, match="ROADMAP A5b"):
        build_train_step(port_config("zamba2-7b").reduced(), TOPO,
                         device="cpu")
    assert adamw.lr_at(adamw.AdamWConfig(warmup_steps=2), 0) == 1.5e-4


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


def test_backward_on_the_cpu_counts_no_launch():
    """The plain backward versions run on the CPU: no kernel launch of any
    kind is counted, forward or backward."""
    ops.reset_launches()
    cfg, params = jax_params("llama3-8b")
    port_loss_and_grads("llama3-8b", params, make_batch(cfg, 1, 8))
    assert set(ops.LAUNCHES.values()) == {0}
    assert set(ops.BACKWARD_LAUNCHES.values()) == {0}


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
])
def test_gloo_mesh_gradients_match_jax_single_device(tmp_path, arch, mesh,
                                                     chunks, mode):
    """Each rank's loss and local gradient (summed over dp) against the JAX
    single-device gradient cut to that rank's shard: every replica of a
    TP-replicated leaf (norm scales, qk-norm gains) must carry the full
    gradient, reduced exactly once.  (1, 2, 2) with chunks=2 runs the
    chunked boundary GEMMs forward and backward; (1, 1, 4) splits the q
    heads four ways over tp2 (kv heads shared by two ranks each);
    qwen3-8b's qk-norm gains meet only each rank's heads (``grad_sync``).
    The dp = 2 meshes then take three AdamW steps, zero1 and plain, one
    batch each split over dp, against the reference's steps on the whole
    batch."""
    params, batches, want_loss, want_grads, want_steps = _reference(arch)
    np.savez(tmp_path / "params.npz", **_flat(params))
    np.savez(tmp_path / "batches.npz", **{
        f"{k}{n}": v for n, bt in enumerate(batches) for k, v in bt.items()})
    (tmp_path / "case.json").write_text(json.dumps(dict(
        arch=arch, mesh=mesh, chunks=chunks, mode=mode,
        steps=STEPS if mode else 0)))
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

    cfg = port_config(arch).reduced()
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
            losses, final = want_steps
            np.testing.assert_allclose(got["losses"], losses, **TOL)
            want = _flat(lm.tree_map(lambda t: t.numpy(),
                                     convert.params_from_jax(cfg, final,
                                                             topo, r)))
            for key, w in want.items():
                np.testing.assert_allclose(got[f"param/{key}"], w, **TOL,
                                           err_msg=f"rank {r} param {key}")
