"""The port's xLSTM (``models/xlstm.py``: the mLSTM and sLSTM blocks and
their per-slot state pools) against the reference's, on the CPU.

xlstm-1.3b ``.reduced()``: 4 layers in two super-blocks of one mLSTM and
one sLSTM block, d_model 128, 4 heads (mLSTM q/k 32, v 64).  Weights come
from the reference's ``init_params`` in fp32 and cross as numpy through
``convert.params_from_jax``; inputs are made from a seed with numpy.
Tolerance 1e-4 (relative and absolute): the two sides sum in other orders,
nothing else differs.
  - ``mlstm_chunked`` with a state in and out at 1, 2 and 3 chunks, and
    ``mlstm_step``, against the reference's ``_mlstm_chunked`` and
    ``_mlstm_step``;
  - ``mlstm_block`` and ``slstm_block`` with and without state;
  - the paged step on the zamba schedule (a chunked prefill that carries
    state, a mixed tick with sentinel rows, a recycled slot that reads
    zeros) and the state pools after it;
  - the paged server's greedy tokens against the reference's server;
  - the wave's decode steps against the reference's, and its tokens
    against the paged server's;
  - ``train_loss`` and every gradient, with and without remat;
  - one spawn of four gloo ranks (``_torch_xlstm_worker.py``) on (1, 2, 2)
    with 2 heads, where ``mlstm_plan`` gives g = 2, r = 2 (a value-dim
    split): the paged logits and the training gradients against the
    reference on one device.  The reference on that mesh departs from its
    one-device result (it normalises each rank's slice of a head's value
    dim on its own, ROADMAP §C); a test pins that departure.
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
from repro.launch.serve import make_paged_server as jax_server  # noqa: E402
from repro.launch.steps import _check_vma, batch_pspecs  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import xlstm as jax_xlstm  # noqa: E402
from repro.models.paging import PagedConfig as JaxPagedConfig  # noqa: E402
from repro.runtime.server import Request as JaxRequest  # noqa: E402
from repro.runtime.server import ServerConfig as JaxServerConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import segments  # noqa: E402
from repro_torch.configs.registry import get_config as port_config  # noqa: E402
from repro_torch.core.atp import make_context  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm, xlstm  # noqa: E402
from repro_torch.models.paging import PagedConfig  # noqa: E402
from repro_torch.runtime.server import Request, ServerConfig  # noqa: E402

from test_torch_train import (_flat, assert_trees_close,  # noqa: E402
                              make_batch, port_loss_and_grads_at)
from test_torch_zamba import GEOM, SLOTS, _schedule  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "xlstm-1.3b"
JAX_TOPO = JaxMeshTopo((("data", 1),))
TOPO = atp_topo(1, 1, 1)
BATCH, SEQ = 2, 32
MESH = (1, 2, 2)
ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_xlstm_worker.py"


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


def test_the_reduced_config_runs_both_xlstm_block_kinds():
    _, pcfg = _cfgs()
    assert [(s.kind, s.count, s.inner) for s in segments(pcfg)] == \
        [("xlstm", 2, 2)]
    assert lm.is_recurrent(pcfg)


def _scan_inputs(s, seed=7, state=True):
    """q, k [b, s, nh, dk], v [b, s, nh, dv], the log gates [b, s, nh] and
    a state [b, nh, dk, dv+1] (or None) from a seed."""
    rng = np.random.default_rng(seed)
    b, nh, dk, dv = 2, 3, 8, 6
    q, k = (rng.normal(size=(b, s, nh, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(b, s, nh, dv)).astype(np.float32)
    li, lf = (np.log(1 / (1 + np.exp(-rng.normal(size=(b, s, nh)))))
              .astype(np.float32) for _ in range(2))
    st = (rng.normal(size=(b, nh, dk, dv + 1)).astype(np.float32)
          if state else None)
    return q, k, v, li, lf, st


@pytest.mark.parametrize("chunks", [1, 2, 3])
@pytest.mark.parametrize("state", [False, True], ids=["zeros", "state_in"])
def test_mlstm_chunked_matches_the_reference(chunks, state):
    chunk = 8
    args = _scan_inputs(chunks * chunk, state=state)
    want_h, want_s = jax_xlstm._mlstm_chunked(*args[:5], chunk,
                                              state=args[5])
    got_h, got_s = xlstm.mlstm_chunked(
        *(torch.from_numpy(a) for a in args[:5]), chunk,
        state=None if args[5] is None else torch.from_numpy(args[5]))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


def test_mlstm_step_matches_the_reference_and_the_chunked_form():
    args = _scan_inputs(1)
    want_h, want_s = jax_xlstm._mlstm_step(*args)
    got_h, got_s = xlstm.mlstm_step(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    ch_h, ch_s = xlstm.mlstm_chunked(*(torch.from_numpy(a)
                                       for a in args[:5]), 8,
                                     state=torch.from_numpy(args[5]))
    np.testing.assert_allclose(got_h.numpy(), ch_h.numpy(), **TOL)
    np.testing.assert_allclose(got_s.numpy(), ch_s.numpy(), **TOL)


def _block_state(cfg, kind, b, rng):
    if kind == "mlstm":
        d_inner, nh, dk, dv = jax_xlstm.mlstm_dims(cfg)
        return {"conv": rng.normal(size=(b, cfg.ssm.conv_kernel - 1,
                                         d_inner)).astype(np.float32),
                "C": rng.normal(size=(b, 1, nh, dk, dv + 1))
                .astype(np.float32)}
    nh, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    st = {k: rng.normal(size=(b, nh, dh)).astype(np.float32)
          for k in ("c", "h")}
    st["n"] = np.abs(rng.normal(size=(b, nh, dh))).astype(np.float32) + 0.5
    return st


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["training", "state"])
def test_blocks_match_the_reference(kind, with_state):
    """Super-block 0's block of ``kind`` on a random input of 20 positions
    (two chunks of 16 would not divide it: one chunk of 20), from zeros or
    from a random state; its output and its new state."""
    cfg, pcfg = _cfgs()
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    w = weights()["seg0"][kind]
    p0 = jax.tree.map(lambda a: a[0, 0] if kind == "mlstm" else a[0], w)
    st = _block_state(cfg, kind, 2, rng) if with_state else None
    jctx = jax_make_context(JAX_TOPO)
    jfn = jax_xlstm.mlstm_block if kind == "mlstm" else jax_xlstm.slstm_block
    fn = jax.jit(shard_map(lambda p, v, s: jfn(jctx, cfg, p, v, state=s),
                           mesh=JAX_TOPO.build(jax.devices()[:1]),
                           in_specs=(P(),) * 3, out_specs=(P(), P()),
                           check_vma=True))
    want, want_st = fn(p0, x, st)
    tp = port_params()["seg0"][kind]
    tp0 = lm.tree_map(lambda a: a[0, 0] if kind == "mlstm" else a[0], tp)
    tst = None
    if st is not None:
        tst = {k: torch.from_numpy(v[:, 0] if k == "C" else v)
               for k, v in st.items()}
    ctx = make_context(TOPO, device_type="cpu")
    pfn = xlstm.mlstm_block if kind == "mlstm" else xlstm.slstm_block
    with torch.no_grad():
        got, got_st = pfn(ctx, pcfg, tp0, torch.from_numpy(x), tst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if st is None:
        assert got_st is None and want_st is None
        return
    for k, v in got_st.items():
        w = np.asarray(want_st[k])
        np.testing.assert_allclose(v.numpy(), w[:, 0] if k == "C" else w,
                                   **TOL, err_msg=k)


def _jax_paged_step(cfg):
    ctx = jax_make_context(JAX_TOPO)

    def step(p, tok, start, table, slot, caches):
        return jax_lm.paged_step(ctx, cfg, p, tok, start, table, caches,
                                 slot=slot)

    return jax.jit(shard_map(step, mesh=JAX_TOPO.build(jax.devices()[:1]),
                             in_specs=(P(),) * 6, out_specs=(P(), P()),
                             check_vma=True))


def test_paged_step_matches_the_reference_with_slot_pools():
    """zamba's schedule: chunked prefill that carries the state (a 32-token
    chunk is two mLSTM chunks), a mixed tick with a sentinel row, a tick
    with two, then a recycled slot whose state must read as zeros; the
    state pools after it (the sentinel rows wrote nothing)."""
    cfg, pcfg = _cfgs()
    params = weights()
    g = _jax_paged_step(cfg)
    jcaches, _ = jax_lm.init_paged_caches(cfg, jax_make_context(JAX_TOPO),
                                          JaxPagedConfig(**GEOM),
                                          dtype=jnp.float32, slots=SLOTS)
    ctx = make_context(TOPO, device_type="cpu")
    tparams = port_params()
    caches = lm.init_paged_caches(pcfg, ctx, PagedConfig(**GEOM),
                                  dtype=torch.float32, device="cpu",
                                  slots=SLOTS)
    got_all = []
    for i, (tok, start, table, slot, live) in enumerate(
            _schedule(cfg.vocab_size)):
        want, jcaches = g(params, tok, start, table, slot, jcaches)
        with torch.no_grad():
            got, caches = lm.paged_step(
                ctx, pcfg, tparams, torch.from_numpy(tok),
                torch.from_numpy(start), torch.from_numpy(table), caches,
                slot=torch.from_numpy(slot))
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   **TOL, err_msg=f"step {i}")
        got_all.append(got.numpy())
    np.testing.assert_allclose(got_all[-1][0], got_all[3][0, :4], **TOL)
    for part, keys in (("mlstm", ("conv", "C")), ("slstm", ("c", "n", "h"))):
        for k in keys:
            want = np.asarray(jcaches["seg0"][part][k])
            if k == "C":   # the reference keeps the flat TP dim (size 1)
                want = want[..., 0, :, :, :]
            np.testing.assert_allclose(caches["seg0"][part][k].numpy(), want,
                                       **TOL, err_msg=f"{part}/{k}")


def test_paged_caches_need_slots_and_have_the_reference_shapes():
    cfg, pcfg = _cfgs()
    ctx = make_context(TOPO, device_type="cpu")
    with pytest.raises(ValueError, match="slots="):
        lm.init_paged_caches(pcfg, ctx, PagedConfig(**GEOM), device="cpu")
    want, _ = jax_lm.init_paged_caches(cfg, jax_make_context(JAX_TOPO),
                                       JaxPagedConfig(**GEOM), abstract=True,
                                       slots=SLOTS)
    got = lm.init_paged_caches(pcfg, ctx, PagedConfig(**GEOM), device="cpu",
                               slots=SLOTS)
    for part, node in want["seg0"].items():
        for k, a in node.items():
            shape = a.shape[:3] + a.shape[4:] if k == "C" else a.shape
            assert tuple(got["seg0"][part][k].shape) == shape, (part, k)
            assert str(got["seg0"][part][k].dtype).endswith(str(a.dtype))


def test_paged_server_tokens_equal_the_reference_server():
    """Recurrent mode on both sides: prompts of 5, 11, 3 and 9 tokens with
    prefill chunk 4, fed tails one token at a time; 2 slots, so slots are
    recycled.  fp32 weights, each server's default bf16 state."""
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
                           paged=PagedConfig(**geom), prefix_cache=True),
        convert.tree_to_torch(weights()), topo=TOPO, device="cpu")
    assert pserver.cfg.recurrent and not pserver.cfg.prefix_cache
    for rid, p in enumerate(prompts):
        jserver.submit(JaxRequest(rid=rid, prompt=p, max_new=5))
        pserver.submit(Request(rid=rid, prompt=p, max_new=5))
    assert pserver.run_until_drained() == jserver.run_until_drained()
    want = {r.rid: r.out for r in jserver.completed}
    got = {r.rid: r.out for r in pserver.completed}
    assert len(got) == len(prompts) and got == want


WAVE = dict(b=2, prompt=6, max_new=4, max_seq=12)


@functools.lru_cache(maxsize=None)
def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, _cfgs()[0].vocab_size, size=WAVE["prompt"],
                         dtype=np.int32) for _ in range(WAVE["b"])]


def test_wave_decode_steps_match_the_reference():
    """``lm.decode_step`` over contiguous fp32 caches: a prefill of the
    prompts into the caches and four ticks, each fed the reference's
    greedy pick, within 1e-4 of the reference's logits, and the states
    after them.  fp32 caches on both sides: with fp32 weights the
    reference's contiguous conv state turns fp32 after its first step (its
    scan returns the conv's fp32 window uncast), while its paged pools and
    the port's caches keep the dtype they were made with."""
    cfg, pcfg = _cfgs()
    jctx = jax_make_context(JAX_TOPO)
    step = jax.jit(shard_map(
        lambda p, t, pos, c: jax_lm.decode_step(jctx, cfg, p, t, pos, c),
        mesh=JAX_TOPO.build(jax.devices()[:1]), in_specs=(P(),) * 4,
        out_specs=(P(), P()), check_vma=False))
    jcaches, _ = jax_lm.init_decode_caches(cfg, jctx, WAVE["b"],
                                           WAVE["max_seq"],
                                           dtype=jnp.float32)
    ctx = make_context(TOPO, device_type="cpu")
    params = port_params()
    caches = lm.init_decode_caches(pcfg, ctx, WAVE["b"], WAVE["max_seq"],
                                   dtype=torch.float32, device="cpu")
    toks, pos = np.stack(_prompts()), 0
    for i in range(5):
        want, jcaches = step(weights(), toks, jnp.int32(pos), jcaches)
        with torch.no_grad():
            got, caches = lm.decode_step(ctx, pcfg, params,
                                         torch.as_tensor(toks),
                                         torch.tensor(pos, dtype=torch.int32),
                                         caches)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {i}")
        pos += toks.shape[1]
        toks = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    for part, node in jcaches["seg0"].items():
        for k, w in node.items():
            w = np.asarray(w)
            np.testing.assert_allclose(
                caches["seg0"][part][k].numpy(),
                w[..., 0, :, :, :] if k == "C" else w, **TOL,
                err_msg=f"{part}/{k}")


def test_wave_tokens_equal_the_paged_servers():
    """``launch.serve.serve`` over contiguous caches (the model's bf16
    state) gives the paged server's tokens on the same prompts."""
    _, pcfg = _cfgs()
    got = serve.serve(pcfg, TOPO, convert.tree_to_torch(weights()),
                      _prompts(), WAVE["max_new"], WAVE["max_seq"],
                      device="cpu")
    assert got.shape == (WAVE["b"], WAVE["max_new"])
    server, _ = serve.make_paged_server(
        pcfg, ServerConfig(batch_slots=WAVE["b"], prefill_chunk=4,
                           paged=PagedConfig(page_size=4, num_pages=16,
                                             pages_per_slot=3)),
        convert.tree_to_torch(weights()), device="cpu")
    for rid, p in enumerate(_prompts()):
        server.submit(Request(rid=rid, prompt=p, max_new=WAVE["max_new"]))
    server.run_until_drained()
    paged = {r.rid: r.out for r in server.completed}
    assert [paged[i] for i in range(WAVE["b"])] == got.tolist()


@functools.lru_cache(maxsize=None)
def ref_loss(heads=None, mesh=(1, 1, 1)):
    """The reference's loss and global gradients on ``mesh``."""
    cfg = _cfgs(heads)[0]
    topo = jax_atp_topo(*mesh)
    ctx = jax_make_context(topo)
    pspecs = jax_lm.param_specs(cfg, ctx)
    fn = jax.jit(shard_map(
        lambda p, b: jax.value_and_grad(
            lambda q: jax_lm.train_loss(ctx, cfg, q, b, remat=False))(p),
        mesh=topo.build(jax.devices()[:topo.size]),
        in_specs=(pspecs, batch_pspecs(cfg, ctx.topo, "train")),
        out_specs=(P(), pspecs), check_vma=_check_vma(ctx)))
    loss, grads = fn(weights(heads), make_batch(cfg, BATCH, SEQ, seed=4))
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_every_gradient_match_the_reference(remat):
    _, pcfg = _cfgs()
    want_loss, want = ref_loss()
    loss, grads = port_loss_and_grads_at(
        pcfg, port_params(), make_batch(pcfg, BATCH, SEQ, seed=4), remat)
    np.testing.assert_allclose(loss, want_loss, **TOL)
    assert_trees_close(grads, want, **TOL)


def test_mlstm_plan_splits_the_value_dim_where_heads_run_out():
    _, pcfg = _cfgs(heads=2)
    assert xlstm.mlstm_plan(lm.layout_context(atp_topo(*MESH), 0),
                            pcfg) == (2, 2)
    assert xlstm.mlstm_plan(lm.layout_context(atp_topo(1, 2, 2), 0),
                            _cfgs()[1]) == (4, 1)


# ---------------------------------------------------------------------------
# A gloo mesh with a value-dim split.
# ---------------------------------------------------------------------------

PAGED = dict(page_size=4, num_pages=16, pages_per_slot=8)


def _mesh_calls(vocab):
    """(tokens, start, table, slot) of each paged call on the mesh: a
    chunk of 8 for slot 0, then one of 4 for slot 1, then a tick of both."""
    rng = np.random.default_rng(6)
    toks = rng.integers(0, vocab, (2, 12), dtype=np.int32)
    t0 = np.arange(8, dtype=np.int32).reshape(1, 8)
    t1 = np.arange(8, 16, dtype=np.int32).reshape(1, 8)
    return [(toks[0:1, 0:8], np.int32([0]), t0, np.int32([0])),
            (toks[1:2, 0:4], np.int32([0]), t1, np.int32([1])),
            (toks[:, 8:9], np.int32([8, 4]), np.concatenate([t0, t1]),
             np.int32([0, 1]))]


@functools.lru_cache(maxsize=None)
def ref_paged_logits(heads=None):
    """The reference's paged calls on one device: logits [b, s, V]."""
    cfg = _cfgs(heads)[0]
    caches, _ = jax_lm.init_paged_caches(
        cfg, jax_make_context(JAX_TOPO), JaxPagedConfig(**PAGED),
        dtype=jnp.float32, slots=2)
    step = _jax_paged_step(cfg)
    out = []
    for tok, start, table, slot in _mesh_calls(cfg.vocab_size):
        logits, caches = step(weights(heads), tok, start, table, slot,
                              caches)
        out.append(np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Every rank's results on (1, 2, 2): one spawn."""
    cfg = _cfgs(2)[0]
    case = tmp_path_factory.mktemp("xlstm_mesh")
    np.savez(case / "params.npz", **_flat(weights(2)))
    np.savez(case / "batch.npz", **make_batch(cfg, BATCH, SEQ, seed=4))
    calls = _mesh_calls(cfg.vocab_size)
    np.savez(case / "calls.npz", **{
        f"{name}{i}": arr for i, c in enumerate(calls)
        for name, arr in zip(("tokens", "start", "table", "slot"), c)})
    (case / "case.json").write_text(json.dumps(dict(
        mesh=MESH, heads=2, paged=PAGED, calls=len(calls))))
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


def test_paged_logits_on_a_value_dim_split_match_one_device(mesh_run):
    """Each rank's vocab shard (over ax1) of every call's logits, against
    the reference's on one device."""
    d1 = MESH[1]
    for i, want in enumerate(ref_paged_logits(2)):
        vl = want.shape[-1] // d1
        for r, got in enumerate(mesh_run):
            i1 = r // MESH[2]
            np.testing.assert_allclose(
                got[f"logits{i}"], want[..., i1 * vl:(i1 + 1) * vl], **TOL,
                err_msg=f"call {i} rank {r}")


def test_gradients_on_a_value_dim_split_match_one_device(mesh_run):
    """The loss on every rank, and the global gradients reassembled from
    every rank's shard (``convert.params_to_numpy``), against the
    reference's on one device."""
    want_loss, want = ref_loss(2)
    _, pcfg = _cfgs(2)
    per_rank = []
    for r, got in enumerate(mesh_run):
        np.testing.assert_allclose(got["loss"], want_loss, **TOL)
        per_rank.append(_unflat_into(port_params(2, MESH, r), got))
    assert_trees_close(convert.params_to_numpy(pcfg, per_rank,
                                               atp_topo(*MESH)), want, **TOL)


def test_the_references_value_dim_split_departs_from_one_device():
    """The reference's group norm normalises each rank's slice of a head's
    value dim on its own: on (1, 2, 2) with 2 heads its loss is not its
    one-device loss (ROADMAP §C), which the port's mesh loss equals."""
    assert abs(ref_loss(2, MESH)[0] - ref_loss(2)[0]) > 1e-2


def _unflat_into(tree, got, prefix="grad/"):
    """``tree``'s structure with each leaf replaced by the rank's gradient
    saved under its path."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}{k}/") for k, v in node.items()}
        return torch.from_numpy(got[prefix + path[:-1]])
    return walk(tree, "")
