"""The port's MLA segment kinds (``models/mla.py``: ``mla_dense``,
``mla_moe`` and deepseek-v3's MLA MTP head) against the reference's, on
the CPU.

Reduced deepseek-v3 (3 layers: one ``mla_dense``, two ``mla_moe`` of 4
experts, top-2, one shared expert; MLA ranks 64/32, q/k 32 + 16, v 32;
the MTP head) takes fp32 weights from the reference's ``init_params``,
which cross as numpy through ``convert.params_from_jax``.  Tolerance 1e-4
in fp32, as in ``test_torch_train.py``:
  - ``mla_block`` of layer 0 in both branches: the cache-free one (q/k of
    48 and v of 32 through the attention) and the absorbed one over a
    contiguous latent cache;
  - the paged step's logits call by call and the greedy picks, with
    full-width and int8 latent pools;
  - the wave's contiguous caches (``decode_step``) step by step;
  - ``train_loss`` with the aux and MTP terms, every gradient, and three
    plain AdamW steps;
  - ``mtp_draft_logits`` on the trunk's hidden.
One device, then gloo (1, 2, 2) and (1, 4, 1) in one spawn
(``_torch_mla_worker.py``) against the reference on a host mesh of the
same shape; there the forward record of a training step equals
``repro.analysis.expect.expected_signature`` but for the departures
``test_torch_collectives.departed`` names.  The reference's own
``test_analysis.py::test_segment_kind_conformance[deepseek-v3-671b]``
fails under jax 0.9.0 (ROADMAP §C, the reference's own failures): the
record is held against ``expect``'s derivation directly, as for the
other kinds.
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
from repro.core.compat import pcast, shard_map  # noqa: E402
from repro.core.mesh import atp_topo as jax_atp_topo  # noqa: E402
from repro.launch.steps import _check_vma, batch_pspecs  # noqa: E402
from repro.launch.steps import build_train_step as jax_build_train_step  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro.models.paging import PagedConfig as JaxPagedConfig  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_config as port_config  # noqa: E402
from repro_torch.core.atp import make_context  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.core.plan import ParallelPlan  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.models import lm, mla  # noqa: E402
from repro_torch.models.paging import PagedConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

from test_torch_atp import _calls  # noqa: E402
from test_torch_collectives import expected, recorded  # noqa: E402
from test_torch_train import (TOL, _flat, assert_trees_close,  # noqa: E402
                              make_batch, port_loss_and_grads_at)

ARCH = "deepseek-v3-671b"
MESHES = ((1, 2, 2), (1, 4, 1))
PAGED = dict(page_size=4, num_pages=12, pages_per_slot=4)
BATCH, SEQ = 2, 12
#: the wave's batch, prompt length, cache length and steps
WAVE = dict(b=2, prompt=5, s_max=16, steps=4)
STEPS = 3
OPT = dict(warmup_steps=2)
ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_mla_worker.py"
TOPO = atp_topo(1, 1, 1)


def ref_config():
    return get_config(ARCH).reduced()


def port_cfg():
    return port_config(ARCH).reduced()


@functools.lru_cache(maxsize=None)
def weights():
    return jax.tree.map(np.asarray, jax_lm.init_params(
        ref_config(), jax.random.PRNGKey(3), jnp.float32))


def port_params(mesh=(1, 1, 1), rank=0):
    return convert.params_from_jax(port_cfg(), weights(), atp_topo(*mesh),
                                   rank)


@functools.lru_cache(maxsize=None)
def block_input():
    """Layer 0's MLA input [b, s, h] and its positions."""
    rng = np.random.default_rng(11)
    h = ref_config().d_model
    x = rng.normal(size=(2, 6, h)).astype(np.float32)
    return x, np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()


def _mesh(mesh):
    topo = jax_atp_topo(*mesh)
    ctx = jax_make_context(topo)
    return ctx, topo.build(jax.devices()[:topo.size])


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@functools.lru_cache(maxsize=None)
def ref_block(mesh, cached: bool):
    """The reference's ``mla_block`` of layer 0 on ``block_input()``: the
    cache-free branch, or the absorbed one over a zeroed contiguous latent
    cache at length 0."""
    cfg, (ctx, jmesh) = ref_config(), _mesh(mesh)
    m = cfg.mla
    p0 = _layer0(weights()["seg0"]["mla"])
    x, pos = block_input()
    xs = P(None, None, ctx.ax2)
    tp1 = tuple(a for a in ctx.tp_axes if a != ctx.ax2)
    cache = None
    if cached:
        b, s = x.shape[:2]
        cache = {"ckv": np.zeros((b, 8, m.kv_lora_rank), np.float32),
                 "krope": np.zeros((b, 8, m.qk_rope_head_dim), np.float32),
                 "len": np.int32(0)}

    def block(p, v, ps, c):
        v = pcast(v, tp1, to="varying") if tp1 else v
        return jax_mla.mla_block(ctx, cfg, p, v, ps, cache=c)[0]

    fn = jax.jit(shard_map(
        block, mesh=jmesh,
        in_specs=(jax_mla.mla_param_specs(ctx, cfg), xs, P(), P()),
        out_specs=xs, check_vma=False))
    return np.asarray(fn(p0, x, pos, cache))


@functools.lru_cache(maxsize=None)
def ref_loss(mesh):
    """The reference's loss (with its aux and MTP terms) and global
    gradients on ``mesh``."""
    cfg, (ctx, jmesh) = ref_config(), _mesh(mesh)
    pspecs = jax_lm.param_specs(cfg, ctx)
    fn = jax.jit(shard_map(
        lambda p, b: jax.value_and_grad(
            lambda q: jax_lm.train_loss(ctx, cfg, q, b, remat=False))(p),
        mesh=jmesh, in_specs=(pspecs, batch_pspecs(cfg, ctx.topo, "train")),
        out_specs=(P(), pspecs), check_vma=_check_vma(ctx)))
    loss, grads = fn(weights(), make_batch(cfg, BATCH, SEQ, seed=4))
    return float(loss), jax.tree.map(np.asarray, grads)


@functools.lru_cache(maxsize=None)
def ref_logits(mesh, page_dtype="bf16"):
    """The reference's paged step on ``mesh``, call by call: global logits
    [b, s, V].  Without the vma check (its MoE's replicated dispatch fails
    it under jax 0.9.0, ROADMAP §C)."""
    cfg, (ctx, jmesh) = ref_config(), _mesh(mesh)
    caches, cspecs = jax_lm.init_paged_caches(
        cfg, ctx, JaxPagedConfig(**PAGED, page_dtype=page_dtype),
        dtype=jnp.float32)
    step = jax.jit(shard_map(
        lambda p, t, s, tb, c: jax_lm.paged_step(ctx, cfg, p, t, s, tb, c),
        mesh=jmesh, in_specs=(jax_lm.param_specs(cfg, ctx), P(), P(), P(),
                              cspecs),
        out_specs=(P(None, None, ctx.ax1), cspecs), check_vma=False))
    out = []
    for tok, start, table, _ in _calls(cfg.vocab_size):
        logits, caches = step(weights(), tok, start, table, caches)
        out.append(np.asarray(logits))
    return out


@functools.lru_cache(maxsize=None)
def ref_mtp():
    """The reference's ``paged_step`` hidden of the first call and its
    ``mtp_draft_logits`` on the greedy picks, one device."""
    cfg, (ctx, jmesh) = ref_config(), _mesh((1, 1, 1))
    caches, _ = jax_lm.init_paged_caches(cfg, ctx, JaxPagedConfig(**PAGED),
                                         dtype=jnp.float32)
    tok, start, table, _ = _calls(cfg.vocab_size)[0]

    def fn(p, t, s, tb, c):
        logits, h, _ = jax_lm.paged_step(ctx, cfg, p, t, s, tb, c,
                                         with_hidden=True)
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        pos = s[:, None] + jnp.arange(t.shape[1], dtype=jnp.int32)[None]
        return h, nxt, jax_lm.mtp_draft_logits(ctx, cfg, p, h, pos, nxt)

    f = jax.jit(shard_map(fn, mesh=jmesh, in_specs=(P(),) * 5,
                          out_specs=(P(),) * 3, check_vma=False))
    return tuple(np.asarray(a) for a in f(weights(), tok, start, table,
                                          caches))


@functools.lru_cache(maxsize=None)
def ref_mtp_mesh(mesh):
    """The reference's draft logits [b, s, V] on ``mesh``: its paged step's
    hidden on that mesh (an MoE dispatch's capacity depends on the tokens a
    rank routes, so the trunk differs from one device's) and the
    one-device greedy picks ``ref_mtp()[1]`` as the next tokens."""
    cfg, (ctx, jmesh) = ref_config(), _mesh(mesh)
    caches, cspecs = jax_lm.init_paged_caches(cfg, ctx, JaxPagedConfig(**PAGED),
                                              dtype=jnp.float32)
    tok, start, table, _ = _calls(cfg.vocab_size)[0]

    def fn(p, t, s, tb, c, nxt):
        _, h, _ = jax_lm.paged_step(ctx, cfg, p, t, s, tb, c,
                                    with_hidden=True)
        pos = s[:, None] + jnp.arange(t.shape[1], dtype=jnp.int32)[None]
        return jax_lm.mtp_draft_logits(ctx, cfg, p, h, pos, nxt)

    f = jax.jit(shard_map(
        fn, mesh=jmesh, in_specs=(jax_lm.param_specs(cfg, ctx), P(), P(),
                                  P(), cspecs, P()),
        out_specs=P(None, None, ctx.ax1), check_vma=False))
    return np.asarray(f(weights(), tok, start, table, caches, ref_mtp()[1]))


# ---------------------------------------------------------------------------
# One device.
# ---------------------------------------------------------------------------


def test_the_reduced_config_has_both_mla_kinds_and_an_mtp_head():
    from repro_torch.configs.base import segments
    cfg = port_cfg()
    assert [(s.kind, s.count) for s in segments(cfg)] == [
        ("mla_dense", 1), ("mla_moe", 2)]
    assert cfg.mtp and cfg.moe.num_shared == 1
    assert set(port_params()["mtp"]["block"]) == {"ln_attn", "mla", "ln_mlp",
                                                  "mlp"}


@pytest.mark.parametrize("cached", [False, True], ids=["cache_free",
                                                        "absorbed"])
def test_mla_block_matches_the_reference(cached):
    cfg = port_cfg()
    m = cfg.mla
    p0 = lm.tree_map(lambda t: t[0], port_params()["seg0"]["mla"])
    ctx = make_context(TOPO, device_type="cpu")
    x, pos = (torch.from_numpy(a) for a in block_input())
    cache = None
    if cached:
        b = x.shape[0]
        cache = {"ckv": torch.zeros(b, 8, m.kv_lora_rank),
                 "krope": torch.zeros(b, 8, m.qk_rope_head_dim),
                 "len": torch.zeros((), dtype=torch.int32)}
    with torch.no_grad():
        y = mla.mla_block(ctx, cfg, p0, x, pos, cache)
    np.testing.assert_allclose(y.numpy(), ref_block((1, 1, 1), cached),
                               **TOL)
    if cached:
        assert int(cache["len"]) == x.shape[1]


def test_loss_with_aux_and_mtp_and_every_gradient_match_the_reference():
    cfg = port_cfg()
    want_loss, want = ref_loss((1, 1, 1))
    loss, grads = port_loss_and_grads_at(
        cfg, port_params(), make_batch(cfg, BATCH, SEQ, seed=4))
    np.testing.assert_allclose(loss, want_loss, **TOL)
    assert_trees_close(grads, want, **TOL)
    for key in ("w_dq", "w_uq", "w_dkv", "w_ukv", "q_ln", "kv_ln"):
        assert np.abs(want["mtp"]["block"]["mla"][key]).max() > 0, key


@functools.lru_cache(maxsize=None)
@functools.lru_cache(maxsize=None)
def _ref_steps(mesh=(1, 1, 1)):
    """The reference's ``STEPS`` plain AdamW steps on ``mesh`` (dp 1): the
    batches, the losses and the global parameters after the last."""
    cfg = ref_config()
    batches = [make_batch(cfg, BATCH, SEQ, seed=20 + i) for i in range(STEPS)]
    fn, info = jax_build_train_step(cfg, jax_atp_topo(*mesh),
                                    jax_adamw.AdamWConfig(mode="plain", **OPT),
                                    remat=False)
    state = jax_adamw.init_opt_state(weights(), info.pspecs, info.ctx, "plain")
    p = jax.device_put(weights(), info.sharding(info.pspecs))
    state = jax.device_put(state, info.sharding(info.ospecs))
    losses = []
    for bt in batches:
        p, state, m = fn(p, state, jax.device_put(
            {k: jnp.asarray(v) for k, v in bt.items()},
            info.sharding(info.bspecs)))
        losses.append(float(m["loss"]))
    return batches, losses, jax.tree.map(np.asarray, p)


def test_three_plain_adamw_steps_match_the_reference():
    batches, want_losses, want = _ref_steps()
    cfg = port_cfg()
    step, info = build_train_step(cfg, TOPO, adamw.AdamWConfig(
        mode="plain", **OPT), remat=True, device="cpu")
    tp = port_params()
    state = adamw.init_opt_state(tp, info.ctx, "plain")
    losses = []
    for bt in batches:
        tp, state, m = step(tp, state, {k: torch.from_numpy(v)
                                        for k, v in bt.items()})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want_losses, **TOL)
    assert_trees_close(convert.params_to_numpy(cfg, [tp], TOPO), want, **TOL)


@pytest.mark.parametrize("page_dtype", ["bf16", "int8"])
def test_paged_step_logits_match_the_reference(page_dtype):
    """Full-width latent pools (the model's dtype) and int8 ones with their
    fp16 scales, call by call, and the greedy picks."""
    cfg = port_cfg()
    ctx = make_context(TOPO, device_type="cpu")
    params = port_params()
    caches = lm.init_paged_caches(
        cfg, ctx, PagedConfig(**PAGED, page_dtype=page_dtype),
        dtype=torch.float32, device="cpu")
    seg = caches["seg1"]
    assert seg["ckv"].shape == (2, PAGED["num_pages"], PAGED["page_size"],
                                cfg.mla.kv_lora_rank)
    assert ("ckv_scale" in seg) == (page_dtype == "int8")
    with torch.no_grad():
        for i, ((tok, start, table, _), want) in enumerate(zip(
                _calls(cfg.vocab_size), ref_logits((1, 1, 1), page_dtype))):
            logits, caches = lm.paged_step(
                ctx, cfg, params, torch.from_numpy(tok),
                torch.from_numpy(start), torch.from_numpy(table), caches)
            np.testing.assert_allclose(logits.numpy(), want, **TOL,
                                       err_msg=f"call {i}")
            np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                          want.argmax(-1))


@functools.lru_cache(maxsize=None)
def ref_wave():
    """The reference's ``decode_step`` on one device over contiguous
    latent caches: a prefill of ``WAVE['prompt']`` tokens, then greedy
    ticks.  Each step's input tokens, logits [b, V] and every segment's
    ``len`` after it."""
    cfg = ref_config()
    jctx, jmesh = _mesh((1, 1, 1))
    step = jax.jit(shard_map(
        lambda p, t, pos, c: jax_lm.decode_step(jctx, cfg, p, t, pos, c),
        mesh=jmesh, in_specs=(P(),) * 4, out_specs=(P(), P()),
        check_vma=False))
    jcaches, _ = jax_lm.init_decode_caches(cfg, jctx, WAVE["b"],
                                           WAVE["s_max"], dtype=jnp.float32)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (WAVE["b"], WAVE["prompt"]),
                        dtype=np.int32)
    out = []
    for _ in range(WAVE["steps"]):
        pos = sum(t.shape[1] for t, *_ in out)
        want, jcaches = step(weights(), toks, jnp.int32(pos), jcaches)
        want = np.asarray(want)
        out.append((toks, pos, want, {seg: int(jcaches[seg]["len"][0])
                                      for seg in jcaches}))
        toks = want.argmax(-1).astype(np.int32)[:, None]
    return out


def test_wave_decode_steps_match_the_reference():
    """The contiguous latent caches: a prefill of ``WAVE['prompt']`` tokens,
    then greedy ticks, logits and ``len`` step by step."""
    pcfg = port_cfg()
    b, s_max = WAVE["b"], WAVE["s_max"]
    ctx = make_context(TOPO, device_type="cpu")
    params = port_params()
    caches = lm.init_decode_caches(pcfg, ctx, b, s_max, dtype=torch.float32,
                                   device="cpu")
    assert caches["seg0"]["ckv"].shape == (1, b, s_max,
                                           pcfg.mla.kv_lora_rank)
    for i, (toks, pos, want, lens) in enumerate(ref_wave()):
        with torch.no_grad():
            got, caches = lm.decode_step(
                ctx, pcfg, params, torch.as_tensor(toks),
                torch.tensor(pos, dtype=torch.int32), caches)
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"step {i}")
        for seg, n in lens.items():
            assert (caches[seg]["len"] == n).all(), (i, seg)


def test_mtp_draft_logits_match_the_reference():
    """The MLA MTP head as the draft proposer: the trunk's hidden from the
    paged step, the greedy picks, and the draft logits (its block
    cache-free over the fed window)."""
    cfg = port_cfg()
    want_h, want_next, want = ref_mtp()
    ctx = make_context(TOPO, device_type="cpu")
    params = port_params()
    caches = lm.init_paged_caches(cfg, ctx, PagedConfig(**PAGED),
                                  dtype=torch.float32, device="cpu")
    tok, start, table, _ = (torch.from_numpy(a)
                            for a in _calls(cfg.vocab_size)[0])
    with torch.no_grad():
        logits, h, _ = lm.paged_step(ctx, cfg, params, tok, start, table,
                                     caches, with_hidden=True)
        nxt = logits.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(nxt.numpy(), want_next)
        draft = lm.mtp_draft_logits(ctx, cfg, params, h,
                                    lm.step_positions(tok, start, cfg),
                                    nxt)
    np.testing.assert_allclose(h.numpy(), want_h, **TOL)
    np.testing.assert_allclose(draft.numpy(), want, **TOL)


def test_mla_heads_must_divide_over_the_ranks():
    cfg = dataclasses.replace(port_cfg(), num_heads=6)
    ctx = lm.layout_context(atp_topo(1, 2, 2), 0)
    with pytest.raises(ValueError, match="MLA heads"):
        mla.heads_per_rank(ctx, cfg)


# ---------------------------------------------------------------------------
# gloo meshes.
# ---------------------------------------------------------------------------


def _write(case_dir: Path, mesh):
    cfg = ref_config()
    np.savez(case_dir / "params.npz", **_flat(weights()))
    np.savez(case_dir / "batch.npz", **make_batch(cfg, BATCH, SEQ, seed=4))
    x, pos = block_input()
    np.savez(case_dir / "block.npz", x=x, pos=pos)
    np.savez(case_dir / "calls.npz", **{
        f"{name}{i}": arr for i, c in enumerate(_calls(cfg.vocab_size))
        for name, arr in zip(("tokens", "start", "table"), c[:3])})
    batches, _, _ = _ref_steps()
    np.savez(case_dir / "steps.npz", **{
        f"{k}{n}": v for n, bt in enumerate(batches) for k, v in bt.items()})
    np.savez(case_dir / "wave.npz", **{
        f"tokens{i}": t for i, (t, *_) in enumerate(ref_wave())})
    (case_dir / "case.json").write_text(json.dumps(dict(
        mesh=mesh, paged=PAGED, calls=len(_calls(cfg.vocab_size)),
        steps=STEPS, opt=OPT, wave=WAVE,
        wave_pos=[pos for _, pos, *_ in ref_wave()],
        mtp_next=ref_mtp()[1].tolist())))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's results, rank by rank: one spawn of both meshes."""
    procs, dirs = {}, {}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for mesh in MESHES:
        dirs[mesh] = tmp_path_factory.mktemp("x".join(map(str, mesh)))
        _write(dirs[mesh], mesh)
        procs[mesh] = [subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(dirs[mesh])], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(int(np.prod(mesh)))]
    out = {}
    try:
        for mesh, ps in procs.items():
            logs = [p.communicate(timeout=300)[0] for p in ps]
            for r, (p, log) in enumerate(zip(ps, logs)):
                assert p.returncode == 0, f"{mesh} rank {r} failed:\n{log}"
            out[mesh] = [(np.load(dirs[mesh] / f"rank{r}.npz"),
                          json.loads((dirs[mesh] / f"rank{r}.json")
                                     .read_text()))
                         for r in range(len(ps))]
    finally:  # a rank that died leaves the others waiting in a collective
        for ps in procs.values():
            for p in ps:
                p.kill()
    return out


IDS = ["x".join(map(str, m)) for m in MESHES]


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
@pytest.mark.parametrize("cached", [False, True], ids=["cache_free",
                                                        "absorbed"])
def test_mla_block_on_a_gloo_mesh_matches_the_reference(runs, mesh, cached):
    """Each rank's feature shard of layer 0's MLA output, both branches."""
    d2 = mesh[2]
    want = ref_block(mesh, cached)
    hl = want.shape[-1] // d2
    key = "absorbed" if cached else "cache_free"
    for r, (got, _) in enumerate(runs[mesh]):
        i2 = r % d2
        np.testing.assert_allclose(got[f"blk_{key}"],
                                   want[..., i2 * hl:(i2 + 1) * hl], **TOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_loss_and_gradients_on_a_gloo_mesh_match_the_reference(runs, mesh):
    """Each rank's loss (aux and MTP terms in) and gradients against the
    reference's global gradients on the same mesh cut to its shard."""
    cfg = port_cfg()
    want_loss, want = ref_loss(mesh)
    for r, (got, _) in enumerate(runs[mesh]):
        np.testing.assert_allclose(got["loss"], want_loss, **TOL)
        shard = _flat(lm.tree_map(lambda t: t.numpy(), convert.params_from_jax(
            cfg, want, atp_topo(*mesh), r)))
        for key, w in shard.items():
            np.testing.assert_allclose(got[f"grad/{key}"], w, **TOL,
                                       err_msg=f"rank {r} grad {key}")


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_paged_step_on_a_gloo_mesh_matches_the_reference(runs, mesh):
    """Local logits [b, s, V/d1] of every call and the greedy picks."""
    _, d1, d2 = mesh
    for i, want in enumerate(ref_logits(mesh)):
        vl = want.shape[-1] // d1
        for r, (got, _) in enumerate(runs[mesh]):
            i1 = r // d2
            np.testing.assert_allclose(
                got[f"logits{i}"], want[..., i1 * vl:(i1 + 1) * vl], **TOL,
                err_msg=f"call {i} rank {r}")
            np.testing.assert_array_equal(got[f"pick{i}"], want.argmax(-1))


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_paged_step_with_int8_latent_pools_on_a_gloo_mesh(runs, mesh):
    """The same calls through int8 latent pools (the latent replicated
    over TP, quantized per position) against the reference's int8 pools
    on a host mesh of the same shape."""
    _, d1, d2 = mesh
    for i, want in enumerate(ref_logits(mesh, "int8")):
        vl = want.shape[-1] // d1
        for r, (got, _) in enumerate(runs[mesh]):
            i1 = r // d2
            np.testing.assert_allclose(
                got[f"int8_logits{i}"], want[..., i1 * vl:(i1 + 1) * vl],
                **TOL, err_msg=f"call {i} rank {r}")


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_wave_and_mtp_draft_on_a_gloo_mesh_match_the_reference(runs, mesh):
    """The wave's contiguous latent caches step by step (each rank's vocab
    shard of the reference's single-device logits: at these few tokens the
    MoE takes its replicated dispatch, the single device's capacity), and
    the MTP head's draft logits from the paged step's hidden and the
    one-device picks, against the reference's on the same mesh."""
    _, d1, d2 = mesh
    draft = ref_mtp_mesh(mesh)
    for r, (got, _) in enumerate(runs[mesh]):
        i1 = r // d2
        for i, (_, _, want, _) in enumerate(ref_wave()):
            vl = want.shape[-1] // d1
            np.testing.assert_allclose(
                got[f"wave{i}"], want[..., i1 * vl:(i1 + 1) * vl], **TOL,
                err_msg=f"wave step {i} rank {r}")
        vl = draft.shape[-1] // d1
        np.testing.assert_allclose(got["draft"],
                                   draft[..., i1 * vl:(i1 + 1) * vl], **TOL,
                                   err_msg=f"draft rank {r}")


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_three_plain_adamw_steps_on_a_gloo_mesh(runs, mesh):
    """Three plain AdamW steps against the reference's on a host mesh of
    the same shape (its MoE capacity depends on the tokens a rank routes):
    the losses and every parameter after the last, cut to each rank's
    shard."""
    _, want_losses, want = _ref_steps(mesh)
    cfg = port_cfg()
    for r, (got, _) in enumerate(runs[mesh]):
        np.testing.assert_allclose(got["step_losses"], want_losses, **TOL)
        shard = _flat(lm.tree_map(lambda t: t.numpy(), convert.params_from_jax(
            cfg, want, atp_topo(*mesh), r)))
        for key, w in shard.items():
            np.testing.assert_allclose(got[f"param/{key}"], w, **TOL,
                                       err_msg=f"rank {r} param {key}")


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_the_mla_record_equals_the_references_expectation(runs, mesh):
    """The forward record of a training step, every key, count for count
    and byte for byte: the two latent all-reduces over ax2, the core
    output's gather over ax2, wo's row boundary, and the MoE layers' and
    the MTP head's collectives, with the named departures applied."""
    _, d1, d2 = mesh
    plan = ParallelPlan(d1=d1, d2=d2, dp=1,
                        provenance=(("searcher", "test"),))
    want = expected(ARCH, plan, BATCH, SEQ)
    for r, (_, meta) in enumerate(runs[mesh]):
        got = recorded(meta)
        assert got == want, (r, sorted(set(got.items()) ^ set(want.items())))
        regions = {region for region, *_ in got}
        assert {"seg0:mla_dense", "seg1:mla_moe"} <= regions


# ---------------------------------------------------------------------------
# The launch models chip_smoke.py asserts on the card.
# ---------------------------------------------------------------------------


def _counting(monkeypatch):
    """Every ``ops`` kernel wrapper counted as the card would launch it."""
    from test_torch_gpt_train import BACKWARD, FORWARD, _launches
    from repro_torch.kernels import ops

    counts = {k: 0 for k in [*FORWARD.values(), *BACKWARD.values()]}

    def counted(name, fn, key):
        def call(*args, **kw):
            counts[key] += _launches(name, args, kw)
            return fn(*args, **kw)
        return call

    for name, key in {**FORWARD, **BACKWARD}.items():
        monkeypatch.setattr(ops, name, counted(name, getattr(ops, name), key))
    return counts


def test_train_step_launches_match_chip_smoke_model(monkeypatch):
    """One CPU training step (remat on) of reduced deepseek-v3 with its
    MTP head, every wrapper counted, against ``chip_smoke``'s launch model:
    the cache-free MLA layer's kv up-projection and attention, its two
    latent norms, the MoE layers' expert GEMMs, the head's mla_dense
    block once."""
    from test_torch_gpt_train import _load_chip_smoke

    cs = _load_chip_smoke()
    counts = _counting(monkeypatch)
    cfg = port_cfg()
    step, info = build_train_step(cfg, TOPO, adamw.AdamWConfig(),
                                  device="cpu")
    params = port_params()
    state = adamw.init_opt_state(params, info.ctx, "zero1")
    bt = make_batch(ref_config(), 1, 16, seed=2)
    step(params, state, {k: torch.from_numpy(v) for k, v in bt.items()})
    fwd, bwd = cs.train_launches_per_step(cfg, remat=True)
    assert counts == {**fwd, **bwd}
    # 3 layers and the head's block: an attention each, twice under remat
    # but the head's
    assert counts["flash_attention"] == 2 * 3 + 1
    assert counts["flash_attention_bwd"] == 3 + 1


@pytest.mark.parametrize("depth", [3, 1], ids=["mixed", "dense_prefix"])
def test_paged_step_launches_match_chip_smoke_model(monkeypatch, depth):
    """One paged step of reduced deepseek-v3 (no MTP head, as
    serve-deepseek serves it; also cut to its dense prefix, as
    ``configs.base.cut_depth`` cuts it for training) against
    ``chip_smoke.launches_per_step``: no attention kernel (the absorbed
    form scores against the latent with torch ops)."""
    from test_torch_gpt_train import _load_chip_smoke
    from repro_torch.configs.base import cut_depth, segments

    cs = _load_chip_smoke()
    cfg = dataclasses.replace(cut_depth(port_cfg(), depth), mtp=False)
    kinds = [s.kind for s in segments(cfg)]
    assert kinds == (["mla_dense", "mla_moe"] if depth == 3
                     else ["mla_dense"])
    params = lm.shard_params(cfg, lm.init_params(cfg, seed=0, device="cpu"),
                             lm.layout_context(TOPO, 0))
    ctx = make_context(TOPO, device_type="cpu")
    caches = lm.init_paged_caches(cfg, ctx, PagedConfig(**PAGED),
                                  device="cpu")
    counts = _counting(monkeypatch)
    tok, start, table, _ = _calls(cfg.vocab_size)[3]
    with torch.no_grad():
        lm.paged_step(ctx, cfg, params, torch.from_numpy(tok),
                      torch.from_numpy(start), torch.from_numpy(table),
                      caches)
    want = cs.launches_per_step(cfg)
    assert {k: counts[k] for k in want} == want
    assert want["flash_attention"] == 0


# ---------------------------------------------------------------------------
# The new kernel modes' plain versions at the kernels' own dims.
# ---------------------------------------------------------------------------

#: q/k 192 with a V of 128, a few heads, s = 256 (two row tiles of the
#: training kernel)
QK, DV, HEADS, S = 192, 128, 3, 256


def _mla_cfg():
    return get_config(ARCH)


def _attention_inputs(seed=21):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, S, HEADS, QK)).astype(np.float32)
    k = rng.normal(size=(2, S, HEADS, QK)).astype(np.float32)
    v = rng.normal(size=(2, S, HEADS, DV)).astype(np.float32)
    do = rng.normal(size=(2, S, HEADS, DV)).astype(np.float32)
    return q, k, v, do


def test_qk192_v128_plain_versions_match_the_references_attention():
    """``ref.attention_lse_ref`` and ``ref.attention_train_ref`` (the mirror
    of the training kernel's order, key tiles of 128) against the
    reference's ``layers.attention_core`` on a deepseek config (scale
    1/sqrt of q's dim, 192), and ``ops.attention_plan`` giving variant 1."""
    from repro.models import layers as jax_layers
    from repro_torch.kernels import ops, ref

    q, k, v, _ = _attention_inputs()
    want = np.asarray(jax_layers.attention_core(_mla_cfg(), q, k, v,
                                                q_offset=0))
    qo = torch.zeros(2, dtype=torch.int32)
    kl = torch.full((2,), S, dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = ref.attention_lse_ref(tq, tk, tv, qo, kl)
    assert out.shape == (2, S, HEADS, DV)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    mirror, mlse = ref.attention_train_ref(tq, tk, tv, qo, kl)
    np.testing.assert_allclose(mirror.numpy(), want, **TOL)
    np.testing.assert_allclose(mlse.numpy(), lse.numpy(), **TOL)
    np.testing.assert_allclose(ops.flash_attention(tq, tk, tv, qo, kl).numpy(),
                               want, **TOL)
    plan = ops.attention_plan(1, 2048, 128, 128, 2048, d=QK)
    assert (plan.variant, plan.rows, plan.bkv) == (1, 128, 128)
    assert ops.attention_plan(1, 64, 128, 128, 272, d=QK).variant == 0


def test_qk192_v128_plain_backward_matches_jax_vjp():
    """``ref.attention_bwd_ref`` (FA2's backward from the forward's
    log-sum-exp) against ``jax.vjp`` of the reference's attention_core:
    dQ and dK [.., 192], dV [.., 128]."""
    from repro.models import layers as jax_layers
    from repro_torch.kernels import ref

    q, k, v, do = _attention_inputs(seed=22)
    out, vjp = jax.vjp(lambda a, b, c: jax_layers.attention_core(
        _mla_cfg(), a, b, c, q_offset=0), q, k, v)
    want = vjp(do)
    qo = torch.zeros(2, dtype=torch.int32)
    kl = torch.full((2,), S, dtype=torch.int32)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = ref.attention_lse_ref(tq, tk, tv, qo, kl)
    got = ref.attention_bwd_ref(tq, tk, tv, o, tdo, lse, qo, kl)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("rows", [4, 64])
def test_rmsnorm_plain_versions_at_7168_match_pallas_and_jax(rows):
    """deepseek-v3's block norm rows: ``ops.rmsnorm`` on the CPU (its
    plain version) against the Pallas kernel in interpret mode, and the
    plain backward against ``jax.vjp`` of the reference's plain norm; the
    plan takes the 8-warp instance."""
    from repro.kernels import ops as jax_ops
    from repro.kernels import ref as jax_ref
    from repro_torch.kernels import ops, ref

    h = 7168
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(rows, h)).astype(np.float32) * 3
    g = (rng.random(h) + 0.5).astype(np.float32)
    dy = rng.normal(size=(rows, h)).astype(np.float32)
    want = np.asarray(jax_ops.rmsnorm(jnp.asarray(x), jnp.asarray(g),
                                      eps=1e-6, block_rows=8, interpret=True))
    tx, tg, tdy = (torch.from_numpy(a) for a in (x, g, dy))
    np.testing.assert_allclose(ops.rmsnorm(tx, tg, eps=1e-6).numpy(), want,
                               **TOL)
    _, vjp = jax.vjp(lambda a, b: jax_ref.rmsnorm_ref(a, b, 1e-6),
                     jnp.asarray(x), jnp.asarray(g))
    wdx, wdg = vjp(jnp.asarray(dy))
    dx, dgamma = ref.rmsnorm_bwd_ref(tx, tg, tdy, 1e-6)
    np.testing.assert_allclose(dx.numpy(), np.asarray(wdx), **TOL)
    np.testing.assert_allclose(dgamma.numpy(), np.asarray(wdg), **TOL)
    plan = ops.rmsnorm_plan(rows, h)
    assert (plan.threads, plan.vectors, plan.rows) == (256, 4, 1)
    assert ops.rmsnorm_bwd_blocks(2048, h) == ops.SMS
    assert ops.rmsnorm_bwd_blocks(2048, 4096) == ops.SMS
    assert ops.rmsnorm_bwd_blocks(rows, h) == rows
