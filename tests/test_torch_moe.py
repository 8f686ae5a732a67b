"""The port's MoE segment kind (``models/moe.py``, dbrx-132b) against the
reference's, on the CPU.

Reduced dbrx-132b (4 experts, top-2, 2 layers, layernorm) and a variant
with one shared expert (``num_shared=1`` by ``dataclasses.replace``, the
deepseek path) take fp32 weights from the reference's ``init_params``,
which cross as numpy.  Tolerance 1e-4, as in ``test_torch_train.py``:
  - ``moe_block`` of layer 0, its output and aux loss; torch's top-k picks
    the reference's order on the same gates;
  - the paged step's logits call by call, and the paged server's greedy
    tokens;
  - ``train_loss`` with its aux term, and every gradient, the router's
    too.
One device, then gloo (1, 2, 2) (both variants) and (1, 4, 1), with one
expert a rank (``_torch_moe_worker.py``, both meshes spawned at once),
against the
reference on a host mesh of the same shape: the capacity, and so which
slots drop, depends on the tokens a rank routes.  A 4-token prefill chunk
over 4 ranks takes the all-to-all dispatch, a 2-slot decode tick the
replicated one.  On the meshes the forward record of a training step
equals ``repro.analysis.expect.expected_signature``'s count for count and
byte for byte, but for the departure ``test_torch_collectives.departed``
names (the token gather over tp1 is an all-gather).
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
from jax import lax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.core.atp import make_context as jax_make_context  # noqa: E402
from repro.core.compat import pcast, shard_map  # noqa: E402
from repro.core.mesh import atp_topo as jax_atp_topo  # noqa: E402
from repro.launch.serve import make_paged_server as jax_server  # noqa: E402
from repro.launch.steps import _check_vma, batch_pspecs  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.paging import PagedConfig as JaxPagedConfig  # noqa: E402
from repro.runtime.server import Request, ServerConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_config as port_config  # noqa: E402
from repro_torch.core.atp import make_context  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.core.plan import ParallelPlan  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import lm, moe, paging  # noqa: E402
from repro_torch.models.paging import PagedConfig  # noqa: E402
from repro_torch.runtime.server import Request as PortRequest  # noqa: E402
from repro_torch.runtime.server import ServerConfig as PortServerConfig  # noqa: E402

from test_torch_atp import _calls  # noqa: E402
from test_torch_collectives import expected, recorded  # noqa: E402
from test_torch_train import (TOL, _flat, assert_trees_close,  # noqa: E402
                              make_batch, port_loss_and_grads_at)

ARCH = "dbrx-132b"
SHARED = (0, 1)
#: the meshes and the variants (shared experts) each runs
MESHES = {(1, 2, 2): (0, 1), (1, 4, 1): (0,)}
PAGED = dict(page_size=4, num_pages=12, pages_per_slot=4)
BATCH, SEQ = 2, 12
#: a batch of fewer tokens than the meshes' 4 ranks: the replicated
#: dispatch, whose capacity is then the single device's
SMALL = (1, 2)
ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_moe_worker.py"


def _with_shared(cfg, shared):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, num_shared=shared))


def ref_config(shared):
    return _with_shared(get_config(ARCH).reduced(), shared)


def port_cfg(shared):
    return _with_shared(port_config(ARCH).reduced(), shared)


@functools.lru_cache(maxsize=None)
def weights(shared):
    return jax.tree.map(np.asarray, jax_lm.init_params(
        ref_config(shared), jax.random.PRNGKey(shared), jnp.float32))


@functools.lru_cache(maxsize=None)
def inputs():
    """The MoE layer's inputs [b, s, h]: 12 tokens (every mesh's
    all-to-all path) and 2 (fewer than 4 ranks: the replicated path)."""
    rng = np.random.default_rng(9)
    h = get_config(ARCH).reduced().d_model
    return {"a2a": rng.normal(size=(2, 6, h)).astype(np.float32),
            "rep": rng.normal(size=(1, 2, h)).astype(np.float32)}


def _mesh(mesh):
    topo = jax_atp_topo(*mesh)
    ctx = jax_make_context(topo)
    return ctx, topo.build(jax.devices()[:topo.size])


@functools.lru_cache(maxsize=None)
def ref_block(shared, mesh, key):
    """The reference's ``moe_block`` of layer 0 on ``inputs()[key]``."""
    cfg, ctx = ref_config(shared), _mesh(mesh)[0]
    p0 = jax.tree.map(lambda a: a[0], weights(shared)["seg0"]["moe"])
    x = P(None, None, ctx.ax2)
    # typed as the block's input is in the model: varying over tp1 too
    tp1 = tuple(a for a in ctx.tp_axes if a != ctx.ax2)

    def block(p, v):
        return jax_moe.moe_block(ctx, cfg, p, pcast(v, tp1, to="varying")
                                 if tp1 else v)

    fn = jax.jit(shard_map(
        block, mesh=_mesh(mesh)[1],
        in_specs=(jax_moe.moe_param_specs(ctx, cfg), x), out_specs=(x, P()),
        check_vma=_check_vma(ctx)))
    y, aux = fn(p0, inputs()[key])
    return np.asarray(y), float(aux)


@functools.lru_cache(maxsize=None)
def ref_loss(shared, mesh, shape=(BATCH, SEQ)):
    """The reference's loss and global gradients on ``mesh`` for a batch
    of ``shape``."""
    cfg, (ctx, jmesh) = ref_config(shared), _mesh(mesh)
    pspecs = jax_lm.param_specs(cfg, ctx)
    fn = jax.jit(shard_map(
        lambda p, b: jax.value_and_grad(
            lambda q: jax_lm.train_loss(ctx, cfg, q, b, remat=False))(p),
        mesh=jmesh, in_specs=(pspecs, batch_pspecs(cfg, ctx.topo, "train")),
        out_specs=(P(), pspecs), check_vma=_check_vma(ctx)))
    loss, grads = fn(weights(shared), make_batch(cfg, *shape, seed=4))
    return float(loss), jax.tree.map(np.asarray, grads)


@functools.lru_cache(maxsize=None)
def ref_logits(shared, mesh):
    """The reference's paged step on ``mesh``, call by call: global logits
    [b, s, V].  Without the vma check: under jax 0.9.0 the reference's
    replicated dispatch psums an aux loss typed invariant over tp1 and
    fails it (ROADMAP §C); the forward's values do not depend on it."""
    cfg, (ctx, jmesh) = ref_config(shared), _mesh(mesh)
    caches, cspecs = jax_lm.init_paged_caches(
        cfg, ctx, JaxPagedConfig(**PAGED), dtype=jnp.float32)
    step = jax.jit(shard_map(
        lambda p, t, s, tb, c: jax_lm.paged_step(ctx, cfg, p, t, s, tb, c),
        mesh=jmesh, in_specs=(jax_lm.param_specs(cfg, ctx), P(), P(), P(),
                              cspecs),
        out_specs=(P(None, None, ctx.ax1), cspecs), check_vma=False))
    out = []
    for tok, start, table, _ in _calls(cfg.vocab_size):
        logits, caches = step(weights(shared), tok, start, table, caches)
        out.append(np.asarray(logits))
    return out


# ---------------------------------------------------------------------------
# One device.
# ---------------------------------------------------------------------------


def test_topk_breaks_ties_as_the_reference_on_the_tests_gates():
    """``torch.topk`` gives ``lax.top_k``'s experts in its order on the
    gates of every input here."""
    router = weights(0)["seg0"]["moe"]["router"][0]
    for x in inputs().values():
        gates = jax.nn.softmax(x.reshape(-1, x.shape[-1]) @ router, axis=-1)
        want = np.asarray(lax.top_k(gates, 2)[1])
        got = torch.topk(torch.tensor(np.asarray(gates)), 2, dim=-1)[1]
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shared", SHARED)
@pytest.mark.parametrize("key", ["a2a", "rep"])
def test_moe_block_matches_the_reference(shared, key):
    cfg = port_cfg(shared)
    params = convert.params_from_jax(cfg, weights(shared), atp_topo(1, 1, 1),
                                     0)
    p0 = lm.tree_map(lambda t: t[0], params["seg0"]["moe"])
    ctx = make_context(atp_topo(1, 1, 1), device_type="cpu")
    y, aux = moe.moe_block(ctx, cfg, p0, torch.from_numpy(inputs()[key]))
    want_y, want_aux = ref_block(shared, (1, 1, 1), key)
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(float(aux), want_aux, **TOL)


@pytest.mark.parametrize("shared", SHARED)
def test_loss_with_aux_and_every_gradient_match_the_reference(shared):
    cfg = port_cfg(shared)
    want_loss, want = ref_loss(shared, (1, 1, 1))
    loss, grads = port_loss_and_grads_at(
        cfg, convert.params_from_jax(cfg, weights(shared), atp_topo(1, 1, 1),
                                     0),
        make_batch(cfg, BATCH, SEQ, seed=4))
    np.testing.assert_allclose(loss, want_loss, **TOL)
    assert_trees_close(grads, want, **TOL)
    assert np.abs(want["seg0"]["moe"]["router"]).max() > 0


def test_paged_step_logits_and_server_tokens_match_the_reference():
    cfg = port_cfg(0)
    ctx = make_context(atp_topo(1, 1, 1), device_type="cpu")
    params = convert.params_from_jax(cfg, weights(0), atp_topo(1, 1, 1), 0)
    caches = lm.init_paged_caches(cfg, ctx, PagedConfig(**PAGED),
                                  dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for (tok, start, table, _), want in zip(_calls(cfg.vocab_size),
                                                ref_logits(0, (1, 1, 1))):
            logits, caches = lm.paged_step(
                ctx, cfg, params, torch.from_numpy(tok),
                torch.from_numpy(start), torch.from_numpy(table), caches)
            np.testing.assert_allclose(logits.numpy(), want, **TOL)

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in (5, 11, 3, 9)]
    geom = dict(page_size=4, num_pages=40, pages_per_slot=8)
    js, _ = jax_server(ref_config(0), ServerConfig(
        batch_slots=2, prefill_chunk=4, paged=JaxPagedConfig(**geom)),
        weights(0), topo=jax_atp_topo(1, 1, 1))
    ps, _ = port_serve.make_paged_server(
        cfg, PortServerConfig(batch_slots=2, prefill_chunk=4,
                              paged=PagedConfig(**geom)),
        convert.tree_to_torch(weights(0)), topo=atp_topo(1, 1, 1),
        device="cpu")
    for rid, p in enumerate(prompts):
        js.submit(Request(rid=rid, prompt=p, max_new=5))
        ps.submit(PortRequest(rid=rid, prompt=p, max_new=5))
    assert ps.run_until_drained() == js.run_until_drained()
    got = {r.rid: r.out for r in ps.completed}
    assert got == {r.rid: r.out for r in js.completed} and len(got) == 4


def test_a_step_writes_colliding_places_once_from_one_plan(monkeypatch):
    """A decode tick's idle rows all write the garbage page's position 0,
    and behind an MoE layer their values differ: each colliding write
    carries the last writer's value, so the pool does not depend on the
    order the device applies them.  A paged step works out where its k/v
    land once, for every layer and for k and v."""
    table = torch.tensor([[1, 2], [0, 0], [0, 0], [0, 0]], dtype=torch.int32)
    start = torch.tensor([9, 0, 0, 0], dtype=torch.int32)
    phys, off, last = paging.write_plan(table, start, 1, 16)
    assert phys.tolist() == [1, 0, 0, 0] and off.tolist() == [9, 0, 0, 0]
    assert last.tolist() == [0, 3, 3, 3]
    values = torch.randn(4, 1, 2, 8, generator=torch.Generator().manual_seed(0))
    pages = paging.append_tokens(torch.zeros(3, 16, 2, 8), table, start,
                                 values)
    assert torch.equal(pages[0, 0], values[3, 0])
    assert torch.equal(pages[1, 9], values[0, 0])

    plans, plan = [], paging.write_plan

    def counted(*args):
        plans.append(args)
        return plan(*args)

    monkeypatch.setattr(paging, "write_plan", counted)
    cfg = port_cfg(0)
    ctx = make_context(atp_topo(1, 1, 1), device_type="cpu")
    params = convert.params_from_jax(cfg, weights(0), atp_topo(1, 1, 1), 0)
    caches = lm.init_paged_caches(cfg, ctx, PagedConfig(**PAGED),
                                  dtype=torch.float32, device="cpu")
    tok, start, table, _ = _calls(cfg.vocab_size)[3]
    with torch.no_grad():
        lm.paged_step(ctx, cfg, params, torch.from_numpy(tok),
                      torch.from_numpy(start), torch.from_numpy(table),
                      caches)
    assert cfg.num_layers > 1 and len(plans) == 1
    assert plans[0][2:] == (1, PAGED["page_size"])


# ---------------------------------------------------------------------------
# gloo meshes.
# ---------------------------------------------------------------------------


def _write(case_dir: Path, mesh):
    cfg = ref_config(0)
    cases = [dict(name=f"shared{s}", shared=s, paged=PAGED,
                  calls=len(_calls(cfg.vocab_size)), record=s == 0)
             for s in MESHES[mesh]]
    for s in MESHES[mesh]:
        np.savez(case_dir / f"params_shared{s}.npz", **_flat(weights(s)))
    np.savez(case_dir / "batch.npz", **make_batch(cfg, BATCH, SEQ, seed=4))
    np.savez(case_dir / "small.npz", **make_batch(cfg, *SMALL, seed=4))
    np.savez(case_dir / "blocks.npz", **inputs())
    np.savez(case_dir / "calls.npz", **{
        f"{name}{i}": arr for i, c in enumerate(_calls(cfg.vocab_size))
        for name, arr in zip(("tokens", "start", "table"), c[:3])})
    (case_dir / "case.json").write_text(json.dumps(dict(mesh=mesh,
                                                        cases=cases)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's results, rank by rank: one spawn per mesh, both at
    once."""
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
            out[mesh] = [{s: (np.load(dirs[mesh] / f"shared{s}_rank{r}.npz"),
                              json.loads((dirs[mesh] / f"shared{s}_rank{r}"
                                          ".json").read_text()))
                          for s in MESHES[mesh]} for r in range(len(ps))]
    finally:  # a rank that died leaves the others waiting in a collective
        for ps in procs.values():
            for p in ps:
                p.kill()
    return out


CASES = [(mesh, s) for mesh, shared in MESHES.items() for s in shared]
IDS = [f"{'x'.join(map(str, m))}-shared{s}" for m, s in CASES]


@pytest.mark.parametrize("mesh,shared", CASES, ids=IDS)
def test_moe_block_on_a_gloo_mesh_matches_the_reference(runs, mesh, shared):
    """Both dispatch paths: each rank's feature shard of the output, and
    the aux loss."""
    d2 = mesh[2]
    for key in inputs():
        want_y, want_aux = ref_block(shared, mesh, key)
        hl = want_y.shape[-1] // d2
        for r, res in enumerate(runs[mesh]):
            got = res[shared][0]
            i2 = r % d2
            np.testing.assert_allclose(
                got[f"blk_out_{key}"], want_y[..., i2 * hl:(i2 + 1) * hl],
                **TOL, err_msg=f"{key} rank {r}")
            np.testing.assert_allclose(got[f"blk_aux_{key}"], want_aux,
                                       **TOL)


@pytest.mark.parametrize("mesh,shared", CASES, ids=IDS)
def test_loss_and_gradients_on_a_gloo_mesh_match_the_reference(runs, mesh,
                                                                shared):
    """Each rank's loss and gradients against the reference's global
    gradients on the same mesh cut to its shard: the experts over the flat
    ranks, the router replicated and reduced once; through both dispatch
    paths."""
    cfg = port_cfg(shared)
    # the small batch's tokens, fewer than the ranks, take the replicated
    # dispatch, which routes every token on every rank at the single
    # device's capacity: the reference's one-device gradients (its own
    # replicated dispatch on a mesh fails its vma check, ROADMAP §C)
    for prefix, (want_loss, want) in (
            ("", ref_loss(shared, mesh)),
            ("small_", ref_loss(shared, (1, 1, 1), SMALL))):
        for r, res in enumerate(runs[mesh]):
            got = res[shared][0]
            np.testing.assert_allclose(got[f"{prefix}loss"], want_loss, **TOL)
            shard = _flat(lm.tree_map(lambda t: t.numpy(),
                                      convert.params_from_jax(
                                          cfg, want, atp_topo(*mesh), r)))
            for key, w in shard.items():
                np.testing.assert_allclose(
                    got[f"{prefix}grad/{key}"], w, **TOL,
                    err_msg=f"rank {r} {prefix}grad {key}")


@pytest.mark.parametrize("mesh,shared", CASES, ids=IDS)
def test_paged_step_on_a_gloo_mesh_matches_the_reference(runs, mesh, shared):
    """Local logits [b, s, V/d1] (vocab over tp1) of every call, and the
    greedy picks, through prefill chunks (all-to-all dispatch) and decode
    ticks (replicated)."""
    _, d1, d2 = mesh
    for i, want in enumerate(ref_logits(shared, mesh)):
        vl = want.shape[-1] // d1
        for r, res in enumerate(runs[mesh]):
            got = res[shared][0]
            i1 = r // d2
            np.testing.assert_allclose(
                got[f"logits{i}"], want[..., i1 * vl:(i1 + 1) * vl], **TOL,
                err_msg=f"call {i} rank {r}")
            np.testing.assert_array_equal(got[f"pick{i}"], want.argmax(-1))


@pytest.mark.parametrize("mesh", MESHES)
def test_the_moe_record_equals_the_references_expectation(runs, mesh):
    """The forward record of a training step, every key, count for count
    and byte for byte: the ax2 all-to-alls of the token scatter and gather,
    the aux loss's all-reduce, the two dispatch all-to-alls over the flat
    TP group, and the token gather over tp1 as the named departure."""
    _, d1, d2 = mesh
    plan = ParallelPlan(d1=d1, d2=d2, dp=1,
                        provenance=(("searcher", "test"),))
    want = expected(ARCH, plan, BATCH, SEQ)
    for r, res in enumerate(runs[mesh]):
        got = recorded(res[0][1])
        assert got == want, (r, sorted(set(got.items()) ^ set(want.items())))
        moe_ops = {(op, tuple(axes)) for region, op, axes, *_ in
                   res[0][1]["fwd"] if region == "seg0:moe"}
        flat = ("tp1", "tp2") if d2 > 1 else ("tp1",)
        assert {("all_to_all", flat), ("all_gather", ("tp1",))} <= moe_ops


def test_paged_step_launches_match_chip_smoke_model(monkeypatch):
    """One paged step of reduced dbrx-132b at 4 layers, each kernel
    wrapper counted, against ``chip_smoke.launches_per_step``, the count
    ``serve-dbrx`` asserts on the card: per layer the attention's two
    GEMMs and two a local expert (every expert runs, empty or not), one
    attention core, no rmsnorm (a LayerNorm model); the head once."""
    from test_torch_gpt_train import _load_chip_smoke

    from repro_torch.kernels import ops

    cs = _load_chip_smoke()
    cfg = dataclasses.replace(port_cfg(0), num_layers=4)
    counts = dict.fromkeys(("matmul", "flash_attention", "rmsnorm",
                            "ssd_scan"), 0)
    for name in counts:
        def call(*args, _fn=getattr(ops, name), _name=name, **kw):
            counts[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(ops, name, call)
    ctx = make_context(atp_topo(1, 1, 1), device_type="cpu")
    params = lm.shard_params(cfg, lm.init_params(cfg, seed=0, device="cpu"),
                             lm.layout_context(atp_topo(1, 1, 1), 0))
    caches = lm.init_paged_caches(cfg, ctx, PagedConfig(**PAGED),
                                  device="cpu")
    tok, start, table, _ = _calls(cfg.vocab_size)[3]   # a 2-slot tick
    with torch.no_grad():
        lm.paged_step(ctx, cfg, params, torch.from_numpy(tok),
                      torch.from_numpy(start), torch.from_numpy(table),
                      caches)
    assert counts == cs.launches_per_step(cfg)
    assert counts["matmul"] == 4 * (2 + 2 * cfg.moe.num_experts) + 1
