"""Training on meshes with two data-parallel axes, and the compressed
AdamW, against the JAX package.

One spawn of four gloo ranks (``_torch_train_worker.py``, a file store
under the test's temporary directory) runs every case of this file on
reduced llama3-8b (but where a case names another arch), from the JAX
weights, on the same three global batches of 4 rows (each dp rank takes
its rows):

  - (pods 2, data 2, d1 1, d2 1) with zero1 and with plain, and (pods 2,
    data 1, d1 1, d2 2) with zero1 (one dp axis, pod, and the split
    RMSNorm over tp2): the loss, every rank's gradient (summed over dp)
    and three AdamW steps against the reference's single device, within
    1e-4, as ``test_torch_train.py``'s gloo meshes are held;
  - compressed on (2, 2, 1) and on (pods 2, data 2): three steps against
    the reference's own compressed ``build_train_step`` on the same host
    mesh (the single device has no dp axis, so it does not quantize);
    the same on (2, 2, 1) for reduced qwen1.5-0.5b (its fused q|k|v and
    their bias);
  - the first compressed step of reduced qwen1.5-0.5b and zamba2-7b on
    (2, 2, 1), whose fused leaves (q|k|v, their bias, up|gate, the Mamba2
    z|x) must quantize piece by piece, each on its own scale, as the
    reference's separate leaves do: every piece of the port's dequantized
    gradient on the 255 levels of its own largest value, that value
    within 1e-4 of the reference leaf's, the values as the
    three-step cases hold them.  zamba2-7b's gradient reaches 1.2 (its
    grad norm 25), and the port's fp32 gradient stands 1e-4 relative from
    the reference's, as the plain meshes allow: that moves its residual
    by more than 1e-4, and its first step's level flips (15 of its
    embedding's 32,768) turn into whole Adam steps (lr) on those elements,
    until 1% of them flip by the second step.  So zamba2-7b takes one step
    and its residual is not held.

The port sums the dp ranks' gradients in fp32 and the reference's AD
gives each rank the summed gradient, in another order: an element that
falls within that rounding of a level's edge can quantize one level apart
(``q``).  So each compressed leaf is held within 1e-4, except that at most
0.1% of its elements (one, in a leaf of fewer than 2,000: reduced
llama3-8b's norm scales have 64 to 128, and one of them flips) may stand
one level apart, and then within what one
level moves: ``err`` within one gradient step and one residual step; its
gradient (read from the AdamW moments, ``(m_t - b1 m_{t-1}) / (1 - b1)``,
the clipped dequantized gradient) within one quantization step (its
leaf's largest magnitude / 127) and what ``err`` carried in from the step
before (the error feedback hands a level that one step rounded the other
way to the next step's gradient, where a smaller scale makes it more than
one of that step's levels); a parameter within 2 lr a step taken.  The
functions themselves are held exactly: ``grad_compress`` against the
reference's inside ``shard_map`` on a dp = 2 host mesh.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core.compat import shard_map  # noqa: E402
from repro.core.mesh import MeshTopo as JaxMeshTopo  # noqa: E402
from repro.launch.steps import build_train_step as jax_build_train_step  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import grad_compress as jax_gc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw, grad_compress  # noqa: E402

from test_torch_train import (LAYERS, OPT, ROOT, STEPS, TOL, WORKER,  # noqa: E402
                              _flat, jax_loss_and_grads, jax_params,
                              jax_train_steps, make_batch, port_config,
                              reduced)

ARCH = "llama3-8b"
#: global batch rows and sequence: one row a rank at dp = 4; zamba2's
#: sequence covers two of its reduced 16-position SSD chunks
BATCH = {ARCH: (4, 12), "qwen1.5-0.5b": (4, 12), "zamba2-7b": (4, 32)}
#: name -> the worker's case: mesh (dp, d1, d2), pods, AdamW mode and the
#: arch where it is not ``ARCH``
CASES = {
    "pods2x2-zero1": dict(mesh=(2, 1, 1), pods=2, mode="zero1"),
    "pods2x2-plain": dict(mesh=(2, 1, 1), pods=2, mode="plain"),
    "pods2-d2x2-zero1": dict(mesh=(1, 1, 2), pods=2, mode="zero1"),
    "2x2x1-compressed": dict(mesh=(2, 2, 1), mode="compressed"),
    "pods2x2-compressed": dict(mesh=(2, 1, 1), pods=2, mode="compressed"),
    "qwen-2x2x1-compressed": dict(mesh=(2, 2, 1), mode="compressed",
                                  arch="qwen1.5-0.5b"),
    "zamba2-2x2x1-compressed": dict(mesh=(2, 2, 1), mode="compressed",
                                    arch="zamba2-7b", steps=1),
}
_DP2_TP2 = (("data", 2), ("tp1", 2), ("tp2", 1))
#: the reference's host mesh of each compressed case
JAX_AXES = {"2x2x1-compressed": _DP2_TP2,
            "pods2x2-compressed": (("pod", 2), ("data", 2), ("tp1", 1),
                                   ("tp2", 1)),
            "qwen-2x2x1-compressed": _DP2_TP2,
            "zamba2-2x2x1-compressed": _DP2_TP2}
#: a leaf's elements that may stand one quantization level apart
FLIP_SHARE = 1e-3


def topo_of(name):
    c = CASES[name]
    return atp_topo(*c["mesh"], pods=c.get("pods", 1))


def arch_of(name):
    return CASES[name].get("arch", ARCH)


def _np(tree):
    """Host copies (the next step donates the state's buffers)."""
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def jax_compressed_steps(cfg, params, batches, axes):
    """The reference's compressed ``build_train_step`` on a host mesh:
    per step the loss, the grad norm, the parameters, the first moments
    and the error-feedback residuals (global arrays)."""
    opt = jax_adamw.AdamWConfig(mode="compressed", **OPT)
    fn, info = jax_build_train_step(cfg, JaxMeshTopo(axes), opt, remat=False)
    state = jax_adamw.init_opt_state(params, info.pspecs, info.ctx,
                                     "compressed")
    p, out = jax.tree.map(jnp.asarray, params), []
    for bt in batches:
        p, state, m = fn(p, state, bt)
        out.append(dict(
            loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
            params=_np(p), err=_np(state["err"]),
            m=_np(jax.tree.map(lambda st: st["m"], state["leaves"],
                               is_leaf=lambda x: isinstance(x, dict)
                               and "m" in x))))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker's outputs of every case, rank by rank, and the
    references: the single device's loss, gradients and plain steps, and
    each compressed case's host-mesh steps (computed while the ranks
    run)."""
    d = tmp_path_factory.mktemp("mesh_train")
    inputs = {}   # arch -> (cfg, its JAX weights, its batches)
    for arch, shape in BATCH.items():
        cfg, params = jax_params(arch)
        batches = [make_batch(cfg, *shape, seed=10 + i) for i in range(STEPS)]
        inputs[arch] = cfg, params, batches
        np.savez(d / f"params_{arch}.npz", **_flat(params))
        np.savez(d / f"batches_{arch}.npz", **{
            f"{k}{n}": v for n, bt in enumerate(batches)
            for k, v in bt.items()})
    (d / "case.json").write_text(json.dumps(dict(cases=[
        dict(name=name, chunks=1, layers=LAYERS.get(arch_of(name)),
             params=f"params_{arch_of(name)}.npz",
             batches=f"batches_{arch_of(name)}.npz",
             **{"arch": ARCH, "steps": STEPS, **c})
        for name, c in CASES.items()])))
    cfg, params, batches = inputs[ARCH]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(d)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        loss, grads = jax_loss_and_grads(cfg, params, batches[0])
        plain = jax_train_steps(cfg, params, batches, jax_adamw.AdamWConfig(
            mode="plain", **OPT))
        compressed = {}
        for name, axes in JAX_AXES.items():
            cfg_n, params_n, batches_n = inputs[arch_of(name)]
            compressed[name] = jax_compressed_steps(
                cfg_n, params_n, batches_n[:CASES[name].get("steps", STEPS)],
                axes)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:  # a rank that died leaves the others waiting in a collective
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    got = {name: [dict(np.load(d / f"{name}_rank{r}.npz")) for r in range(4)]
           for name in CASES}
    return got, (loss, grads, plain), compressed


def shard(tree, name, rank):
    """Rank ``rank``'s port leaves of the global reference ``tree`` (a
    parameter-shaped tree, JAX keys), flattened as the worker writes
    them."""
    cfg = reduced(port_config, arch_of(name))
    return _flat(lm.tree_map(lambda t: t.numpy(), convert.params_from_jax(
        cfg, tree, topo_of(name), rank)))


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c["mode"] != "compressed"])
def test_two_dp_axes_match_jax_single_device(runs, name):
    """Each rank's loss and gradient (summed over the dp ranks of its
    flat (pod, data) group, or over pod alone), then the losses and
    parameters of three AdamW steps, against the single device's."""
    got, (loss, grads, (losses, after)), _ = runs
    for r, res in enumerate(got[name]):
        np.testing.assert_allclose(res["loss"], loss, **TOL)
        for key, w in shard(grads, name, r).items():
            np.testing.assert_allclose(res[f"grad/{key}"], w, **TOL,
                                       err_msg=f"rank {r} grad {key}")
        np.testing.assert_allclose(res["losses"], losses, **TOL)
        for key, w in shard(after[-1], name, r).items():
            np.testing.assert_allclose(res[f"param/{key}"], w, **TOL,
                                       err_msg=f"rank {r} param {key}")


def close_but_few(what, got, want, limit):
    """``got`` within TOL of ``want``, except at most ``FLIP_SHARE`` of its
    elements (one in a leaf of fewer than 2,000), which must be within
    ``limit`` (and TOL's atol) of it."""
    far = ~np.isclose(got, want, **TOL)
    allowed = max(1, int(FLIP_SHARE * got.size))
    assert int(far.sum()) <= allowed, (what, int(far.sum()), allowed)
    if far.any():
        off = np.abs(got - want)[far]
        assert (off <= limit + TOL["atol"]).all(), (what, float(off.max()),
                                                    limit)
    return int(far.sum())


#: the compressed cases held step by step, and the first-step cases
STEP_CASES = ["2x2x1-compressed", "pods2x2-compressed",
              "qwen-2x2x1-compressed"]
PIECE_CASES = ["qwen-2x2x1-compressed", "zamba2-2x2x1-compressed"]


@pytest.mark.parametrize("name", STEP_CASES)
def test_compressed_steps_match_jax_on_the_same_mesh(runs, name):
    """Three compressed steps: every rank's losses and grad norms against
    the reference's within 1e-4; after every step its gradients (from the
    moments) and residuals, and after the last its parameters, each leaf
    within 1e-4 but for at most 0.1% of its elements one quantization
    level apart (module docstring).  The first step's gradient of a whole
    leaf takes at most 255 values: it was quantized."""
    got, _, compressed = runs
    ref = compressed[name]
    b1 = adamw.AdamWConfig().b1
    lrs = [adamw.lr_at(adamw.AdamWConfig(**OPT), n) for n in range(len(ref))]
    for r, res in enumerate(got[name]):
        np.testing.assert_allclose(res["losses"], [s["loss"] for s in ref],
                                   **TOL)
        np.testing.assert_allclose(res["grad_norms"],
                                   [s["grad_norm"] for s in ref], **TOL)
        prev_got = prev_want = None
        carried = {}   # per leaf: the err limit of the step before
        for n, step in enumerate(ref):
            want_m = shard(step["m"], name, r)
            want_err = shard(step["err"], name, r)
            clip = min(1.0, 1.0 / (step["grad_norm"] + 1e-9))
            for key, m_want in want_m.items():
                m_got = res[f"opt{n}/{key}/m"]
                g_got, g_want = ((m - (b1 * prev[key] if n else 0)) / (1 - b1)
                                 for m, prev in ((m_got, prev_got),
                                                 (m_want, prev_want)))
                level = np.abs(g_want).max() / 127
                close_but_few(f"rank {r} step {n} grad {key}", g_got, g_want,
                              level + clip * carried.get(key, 0.0))
                e_want = want_err[key]
                carried[key] = level / clip + np.abs(e_want).max() / 127
                close_but_few(f"rank {r} step {n} err {key}",
                              res[f"err{n}/{key}"], e_want, carried[key])
            prev_got = {k: res[f"opt{n}/{k}/m"] for k in want_m}
            prev_want = want_m
        for key, w in shard(ref[-1]["params"], name, r).items():
            close_but_few(f"rank {r} param {key}", res[f"param/{key}"], w,
                          2 * sum(lrs))
        assert len(np.unique(res["opt0/embed/m"])) <= 255


def _pieces_of(name, tree):
    """The port-layout ``tree`` (flattened, as the worker writes it) cut
    into the JAX package's leaves: each fused leaf into its pieces."""
    cfg = reduced(port_config, arch_of(name))
    ctx = lm.layout_context(topo_of(name), 0)
    out = {}
    for key, a in tree.items():
        w = L.fused_widths(cfg, ctx, key.rsplit("/", 1)[-1], a.shape[-1])
        cuts = np.cumsum(w)[:-1] if w else []
        for i, piece in enumerate(np.split(a, cuts, axis=-1)):
            out[f"{key}#{i}"] = piece
    return out


@pytest.mark.parametrize("name", PIECE_CASES)
def test_compressed_first_step_quantizes_each_piece_on_its_own_scale(
        runs, name):
    """The first compressed step (module docstring): every rank's loss and
    grad norm within 1e-4 of the reference's; per piece of each leaf (a
    fused leaf's pieces are the reference's leaves), the dequantized,
    clipped gradient (the first moment / (1 - b1)) on the 255 levels of
    its own largest magnitude, that magnitude (unclipped) within 1e-4 of
    the reference's, and the values within 1e-4 but for at most 0.1% of
    them one level apart.  A fused leaf quantized whole puts its narrower
    piece on the wider one's levels."""
    got, _, compressed = runs
    step = compressed[name][0]
    b1 = adamw.AdamWConfig().b1
    for r, res in enumerate(got[name]):
        np.testing.assert_allclose(res["losses"][0], step["loss"], **TOL)
        np.testing.assert_allclose(res["grad_norms"][0], step["grad_norm"],
                                   **TOL)
        want = _pieces_of(name, shard(step["m"], name, r))
        mine = _pieces_of(name, {k: res[f"opt0/{k}/m"] for k in shard(
            step["m"], name, r)})
        # the clipped gradient back to the quantized one
        unclip = [max(1.0, n + 1e-9) for n in (res["grad_norms"][0],
                                               step["grad_norm"])]
        for key, m_want in want.items():
            g_got, g_want = mine[key] / (1 - b1), m_want / (1 - b1)
            top, top_want = np.abs(g_got).max(), np.abs(g_want).max()
            if top_want == 0:
                assert top == 0, key
                continue
            np.testing.assert_allclose(top * unclip[0], top_want * unclip[1],
                                       **TOL, err_msg=f"rank {r} {key}")
            levels = g_got / (top / 127)
            np.testing.assert_allclose(levels, np.round(levels), rtol=0,
                                       atol=1e-3, err_msg=f"rank {r} {key}")
            close_but_few(f"rank {r} grad {key}", g_got, g_want,
                          top_want / 127)


def test_grad_compress_matches_jax_inside_shard_map():
    """``compressed_psum_mean_ef`` and ``compressed_psum_mean`` on the same
    numpy gradient and residual, replicated over a dp = 2 host mesh: the
    reference's (its pmax and int32 psums over identical values) against
    the port's (none), the same levels and values within 1e-6; with no
    dp axis both pass the gradient and the residual through."""
    rng = np.random.default_rng(0)
    g = (rng.standard_normal((64, 48)) * 1e-3).astype(np.float32)
    err = (rng.standard_normal((64, 48)) * 1e-5).astype(np.float32)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))

    def ref(gj, ej):
        q, e = jax_gc.compressed_psum_mean_ef(gj, ej, ("data",))
        return q, e, jax_gc.compressed_psum_mean(gj, ("data",))

    want = jax.jit(shard_map(ref, mesh=mesh, in_specs=(P(), P()),
                             out_specs=(P(), P(), P()),
                             check_vma=False))(g, err)
    want = [np.asarray(w) for w in want]
    tg, te = torch.from_numpy(g), torch.from_numpy(err)
    got = [*grad_compress.compressed_psum_mean_ef(tg, te, ("data",)),
           grad_compress.compressed_psum_mean(tg, ("data",))]
    got = [t.numpy() for t in got]
    scales = [max(np.abs(g + err).max() / 127, 1e-12),
              None, max(np.abs(g).max() / 127, 1e-12)]
    for i, (a, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, w, rtol=0, atol=1e-6, err_msg=str(i))
        if scales[i] is not None:   # the same integer levels
            np.testing.assert_array_equal(np.round(a / scales[i]),
                                          np.round(w / scales[i]))
    # the residual is itself on a grid of at most 255 levels
    assert len(np.unique(got[1])) <= 255
    same_g, same_err = grad_compress.compressed_psum_mean_ef(tg, te, ())
    assert same_g is tg and same_err is te
    assert grad_compress.compressed_psum_mean(tg, ()) is tg


def test_adamw_compressed_state_and_step_without_dp():
    """``init_opt_state(..., "compressed")`` adds an fp32 ``err`` in each
    leaf's shape (never banked); with no dp axis the compressed step is
    the plain one (nothing quantized), ``err`` stays zero; a fused leaf
    quantizes piece by piece (``lm.fused_pieces``)."""
    from repro_torch.core.atp import make_context

    cfg = reduced(port_config, ARCH)
    topo = atp_topo(1, 1, 1)
    params = convert.params_from_jax(cfg, jax_params(ARCH)[1], topo, 0)
    ctx = make_context(topo, device_type="cpu")
    state = adamw.init_opt_state(params, ctx, "compressed")
    for p, e in zip(adamw.tree_leaves(params), adamw.tree_leaves(
            state["err"])):
        assert e.shape == p.shape and e.dtype == torch.float32
        assert not e.any()
    pieces = lm.fused_pieces(cfg, ctx, params)
    qkv = params["seg0"]["attn"]["w_qkv"]
    assert sum(pieces["seg0"]["attn"]["w_qkv"]) == qkv.shape[-1]
    assert pieces["seg0"]["mlp"]["w_upgate"] == (cfg.d_ff,) * 2
    assert pieces["embed"] is None
    grads = lm.tree_map(lambda t: torch.full_like(t, 1e-3), params)
    outs = []
    for mode in ("plain", "compressed"):
        p = lm.tree_map(torch.clone, params)
        st = adamw.init_opt_state(p, ctx, mode)
        outs.append(adamw.apply_adamw(adamw.AdamWConfig(mode=mode), ctx, p,
                                      grads, st, pieces=pieces))
    for a, b in zip(adamw.tree_leaves(outs[0][0]),
                    adamw.tree_leaves(outs[1][0])):
        assert torch.equal(a, b)
    assert not any(e.any() for e in adamw.tree_leaves(outs[1][1]["err"]))
    assert outs[1][1]["step"] == 1


def test_compressed_adamw_needs_the_fused_pieces():
    """``apply_adamw`` under ``compressed`` refuses to run without
    ``lm.fused_pieces`` (a fused leaf quantized whole would give other
    numbers than the reference's), and the pieces of each fused leaf
    cover it: q|k|v and its bias this rank's q and kv columns, the Mamba2
    z|x two halves."""
    from repro_torch.core.atp import make_context

    topo = atp_topo(1, 1, 1)
    ctx = make_context(topo, device_type="cpu")
    for arch in ("qwen1.5-0.5b", "zamba2-7b"):
        cfg = reduced(port_config, arch)
        params = convert.params_from_jax(cfg, jax_params(arch)[1], topo, 0)
        pieces = lm.fused_pieces(cfg, ctx, params)
        fused = {}   # name -> (width, pieces) of each fused leaf

        def walk(tree, widths, name=None):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, widths[k], k)
            elif widths is not None:
                fused[name] = tree.shape[-1], widths

        walk(params, pieces)
        assert all(sum(w) == n for n, w in fused.values()), fused
        assert set(fused) == ({"w_qkv", "b_qkv", "w_upgate"} if cfg.qkv_bias
                              else {"w_zx", "w_qkv", "w_upgate"}), fused
        state = adamw.init_opt_state(params, ctx, "compressed")
        with pytest.raises(ValueError, match="fused_pieces"):
            adamw.apply_adamw(adamw.AdamWConfig(mode="compressed"), ctx,
                              params, params, state)


def test_trainer_takes_compressed_on_the_cpu():
    """``launch.train.main --opt-mode compressed``: two steps of reduced
    llama3-8b on one CPU rank (no dp axis: the state carries ``err``, and
    nothing is quantized)."""
    from repro_torch.launch import train

    hist = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--layers", "1", "--seq", "16", "--batch", "2",
                       "--steps", "2", "--opt-mode", "compressed"])
    assert len(hist) == 2
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in hist)
