"""Ring and quantized boundaries and the sequence-parallel block I/O on
four-rank gloo meshes, against the JAX package under the same plans.

Reduced llama3-8b, cut to 2 layers, b = 4, s = 16, on (1, 2, 2) and
(1, 4, 1): the port's training step (``build_train_step(plan=...)``, four
ranks of ``_torch_plan_worker.py``) on the JAX weights, against the
reference's ``lm.train_loss`` and ``lm.prefill_logits`` inside
``shard_map`` on the same host mesh, with the ``check_vma`` its
``build_train_step`` uses (``repro.launch.steps._check_vma``).  The plans: psum, ring, ring at
chunks 2, seq_parallel, ring + seq_parallel, the int8 wire (psum and ring)
and the fp8 wire.

  - the loss equals the reference's same-plan loss, within 1e-5 on a bf16
    wire and 1e-4 on a quantized one (the port's fp32 partial sums can
    flip a grid level that JAX's do not);
  - the last position's logits equal the reference's same-plan logits
    within 1e-4 on a bf16 wire, and under :func:`assert_flips_only` on a
    quantized one;
  - the gradients.  Under jax 0.9.0 the reference's ring plans (traced
    with ``check_vma=False``) count the gradient tp times, and its int8
    wire on psum boundaries does not trace a gradient at all (ROADMAP §C);
    the port reduces each gradient once.  So the bf16-wire plans' gradients
    are held against the reference's psum-plan gradients at 1e-4 and the
    ring plans' also against its ring gradient / tp.  Without
    seq_parallel the port quantizes another tensor than the reference in
    the backward (``core.atp``'s docstring; the distance is in ROADMAP
    §C), so a quantized plan's gradients are held twice: against a plain
    witness of the port's own placement (``chip_smoke.wire_witness_loss``:
    one process, the ranks' partial products cut out of global GEMMs, the
    same boundaries on the same shared-scale wire), the backward's grid
    values under :func:`assert_flips_only`'s rule call by call and the
    gradients at 1e-4 once the witness takes the port's grid values; and
    per leaf within twice the reference's own distance from the exact
    gradient, of the reference's ring gradient on the same wire / tp and
    of the exact gradient.

:func:`assert_flips_only` admits what a quantized wire does when the two
sides' fp32 partial sums differ in their last bits: an element lands on
the neighbouring grid level, its quotient at the rounding midpoint.  It
is not a looser tolerance: a different quantizer, scale or tensor fails
it.  Flips compound: a flipped element moves every later boundary's
partial sums by more than their last bits, so each side is held against
the other with the earlier calls' grid values shared.

One zamba2-7b case (reduced, 5 layers) runs ring + seq_parallel on
(1, 2, 2): its zamba segments mask seq_parallel, so it runs as a ring plan.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from jax import lax  # noqa: E402

from repro.core import overlap as ref_overlap  # noqa: E402
from repro.core.atp import make_context as jax_make_context  # noqa: E402
from repro.core.compat import shard_map  # noqa: E402
from repro.core.plan import ParallelPlan as RefPlan  # noqa: E402
from repro.launch.steps import _check_vma, batch_pspecs  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_config as port_config  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.core.plan import ParallelPlan  # noqa: E402
from repro_torch.models import lm  # noqa: E402

from _torch_plan_worker import batch_of, finish, start  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, SEQ = 4, 16
LAYERS = {"llama3-8b": 2, "zamba2-7b": 5}
PLANS = {"psum": {}, "ring": dict(boundary_mode="ring"),
         "ring-ck2": dict(boundary_mode="ring", chunks=2),
         "sp": dict(seq_parallel=True),
         "ring-sp": dict(boundary_mode="ring", seq_parallel=True),
         "int8": dict(wire_dtype="int8"),
         "int8-ring": dict(wire_dtype="int8", boundary_mode="ring"),
         "fp8": dict(wire_dtype="fp8")}
MESHES = ((1, 2, 2), (1, 4, 1))
#: the reference plans whose gradients the port's are held against
GRAD_PLANS = ("psum", "ring", "int8-ring", "fp8-ring")


def wire_of(name):
    return "fp8" if name.startswith("fp8") else (
        "int8" if name.startswith("int8") else "bf16")


def config(config_fn, arch):
    return dataclasses.replace(config_fn(arch).reduced(),
                               num_layers=LAYERS[arch])


def plan_of(mesh, knobs) -> dict:
    _, d1, d2 = mesh
    return ParallelPlan(d1=d1, d2=d2, **knobs).to_dict()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def reference(cfg, params, plan: dict, grads: bool):
    """The reference's loss, gradients (or None) and last-position logits
    [b, V] under ``plan`` on the host mesh."""
    rplan = RefPlan.from_dict(plan)
    topo = rplan.topo()
    ctx = jax_make_context(topo, plan=rplan)
    pspecs = jax_lm.param_specs(cfg, ctx)
    glob = batch_of(cfg, BATCH, SEQ)

    def f(p, b):
        def loss(q):
            return jax_lm.train_loss(ctx, cfg, q, b, remat=False)
        lv, g = jax.value_and_grad(loss)(p) if grads else (loss(p), p)
        return lv, g, jax_lm.prefill_logits(ctx, cfg, p,
                                            {"tokens": b["tokens"]})

    fn = jax.jit(shard_map(
        f, mesh=topo.build(jax.devices()[:topo.size]),
        in_specs=(pspecs, batch_pspecs(cfg, topo, "train")),
        out_specs=(P(), pspecs, P(None, ctx.ax1)),
        check_vma=_check_vma(ctx)))
    loss, g, logits = fn(params, glob)
    return (float(loss), jax.tree.map(np.asarray, g) if grads else None,
            np.asarray(logits))


def reference_grid_values(cfg, params, plan: dict) -> dict:
    """The grid values and scale of every quantized boundary of the
    reference's forward under ``plan``, rank by rank, in the forward's
    order (``q{CALL}_{RANK}``, ``s{CALL}_{RANK}``): read out of its compiled
    step by a host callback beside ``wire_quantize``, one per call site of
    the traced layer body and per layer."""
    rplan = RefPlan.from_dict(plan)
    topo = rplan.topo()
    ctx = jax_make_context(topo, plan=rplan)
    seen, sites = {}, []
    quantize = ref_overlap.wire_quantize

    def recorded(x, axis, wire):
        q, scale = quantize(x, axis, wire)
        site = len(sites)
        sites.append(site)
        idx = [lax.axis_index(a) if a else jnp.int32(0)
               for a in (ctx.ax1, ctx.ax2)]

        def keep(q, scale, i1, i2, site=site):
            seen.setdefault((site, int(i1) * ctx.d2 + int(i2)), []).append(
                (np.asarray(q), np.asarray(scale)))
        jax.debug.callback(keep, q, scale, *idx)
        return q, scale

    ref_overlap.wire_quantize = recorded
    try:
        fn = jax.jit(shard_map(
            lambda p, b: jax_lm.train_loss(ctx, cfg, p, b, remat=False),
            mesh=topo.build(jax.devices()[:topo.size]),
            in_specs=(jax_lm.param_specs(cfg, ctx),
                      batch_pspecs(cfg, topo, "train")),
            out_specs=P(), check_vma=_check_vma(ctx)))
        jax.block_until_ready(fn(params, batch_of(cfg, BATCH, SEQ)))
    finally:
        ref_overlap.wire_quantize = quantize
    out = {}
    for (site, rank), calls in seen.items():
        for layer, (q, scale) in enumerate(calls):
            k = layer * len(sites) + site
            out[f"q{k}_{rank}"], out[f"s{k}_{rank}"] = q, scale
    return out


QUANT_PLANS = [n for n in PLANS if wire_of(n) != "bf16"]


def cases_of(mesh):
    out = [dict(name=name, arch="llama3-8b", layers=2,
                plan=plan_of(mesh, knobs), batch=BATCH, seq=SEQ,
                params="params_llama3-8b.npz", grads=True, prefill=True,
                record=wire_of(name) != "bf16")
           for name, knobs in PLANS.items()]
    out += [dict(name=f"{name}-replay", arch="llama3-8b", layers=2,
                 plan=plan_of(mesh, PLANS[name]), batch=BATCH, seq=SEQ,
                 params="params_llama3-8b.npz", grads=True, prefill=True,
                 replay=f"replay_{name}.npz", record_bwd=True)
            for name in QUANT_PLANS]
    if mesh == (1, 2, 2):
        out.append(dict(name="zamba-ring-sp", arch="zamba2-7b", layers=5,
                        plan=plan_of(mesh, dict(boundary_mode="ring",
                                                seq_parallel=True)),
                        batch=BATCH, seq=32, params="params_zamba2-7b.npz",
                        grads=True, prefill=False))
    return out


@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch in LAYERS:
        cfg = config(get_config, arch)
        out[arch] = (cfg, jax.tree.map(np.asarray, jax_lm.init_params(
            cfg, jax.random.PRNGKey(0), jnp.float32)))
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory, weights):
    """Both meshes' ranks, started at once once the reference's grid values
    are written, and the reference's values computed while they run: per
    mesh its directory and results rank by rank; per mesh and plan name
    the reference's (loss, gradients or None, logits), the ring-fp8 plan
    for its gradient only."""
    cfg, params = weights["llama3-8b"]
    dirs = {}
    for mesh in MESHES:
        d = dirs[mesh] = tmp_path_factory.mktemp("x".join(map(str, mesh)))
        for arch, (_, p) in weights.items():
            np.savez(d / f"params_{arch}.npz", **_flat(p))
        for name in QUANT_PLANS:
            np.savez(d / f"replay_{name}.npz", **reference_grid_values(
                cfg, params, plan_of(mesh, PLANS[name])))
        (d / "case.json").write_text(json.dumps(dict(mesh=mesh,
                                                     cases=cases_of(mesh))))
    started = {mesh: start(d, mesh) for mesh, d in dirs.items()}
    refs = {}
    for mesh in MESHES:
        for name, knobs in list(PLANS.items()) + [
                ("fp8-ring", dict(wire_dtype="fp8", boundary_mode="ring"))]:
            refs[mesh, name] = reference(cfg, params, plan_of(mesh, knobs),
                                         grads=name in GRAD_PLANS)
    return ({mesh: (dirs[mesh], finish(dirs[mesh], procs))
             for mesh, procs in started.items()}, refs)


@pytest.fixture(scope="module")
def runs(both):
    return both[0]


@pytest.fixture(scope="module")
def references(both):
    return both[1]


def result(runs, mesh, name, rank):
    return next(r for r in runs[mesh][1][rank] if r["name"] == name)


def port_grads(runs, mesh, name, rank) -> dict:
    d = runs[mesh][0]
    return dict(np.load(d / f"grads_{name}_rank{rank}.npz"))


def shard_grads(arch, grads, mesh, rank) -> dict:
    """The reference's global gradients cut to ``rank``'s port leaves."""
    cfg = config(port_config, arch)
    topo = atp_topo(*mesh)
    return _flat(lm.tree_map(lambda t: t.numpy(), convert.params_from_jax(
        cfg, grads, topo, rank)))


def port_logits(runs, mesh, name):
    """[b, V] from the tp1 ranks of tp2 rank 0."""
    d, (_, d1, d2) = runs[mesh][0], mesh
    return np.concatenate([np.load(d / f"prefill_{name}_rank{i1 * d2}.npy")
                           for i1 in range(d1)], axis=-1)


def rel(got, want) -> float:
    """Relative L2 distance."""
    return float(np.linalg.norm(np.float64(got) - want)
                 / max(np.linalg.norm(np.float64(want)), 1e-30))


#: every finite float8 e4m3 value, ascending (the fp8 wire's grid)
FP8_GRID = np.unique(np.arange(256, dtype=np.uint8).view(
    jnp.float8_e4m3fn).astype(np.float32))
FP8_GRID = FP8_GRID[np.isfinite(FP8_GRID)]


def grid_steps(a, b, wire: str):
    """How many grid steps apart the grid values ``a`` and ``b`` lie."""
    if wire == "int8":
        return np.abs(a - b)
    return np.abs(np.searchsorted(FP8_GRID, a) - np.searchsorted(FP8_GRID, b))


def grid_differences(runs, mesh, case, ref, wire):
    """The first forward call (over every rank) where the port's own grid
    values differ from ``ref``'s (the reference's, ``q{CALL}_{RANK}``):
    the call, how many elements differ there, the largest distance of a
    differing element's pre-rounding quotient from the midpoint between
    the two grid values (relative to the midpoint, or absolute below 1),
    and the most grid steps between them; None if no call differs."""
    d = runs[mesh][0]
    own = [np.load(d / f"own_{case}_rank{r}.npz") for r in range(4)]
    calls = sorted(int(k[1:]) for k in own[0].files if k.startswith("q"))
    for k in calls:
        n, far, steps = 0, 0.0, 0
        for rank in range(4):
            q, r = own[rank][f"q{k}"], own[rank][f"r{k}"]
            qr = ref[f"q{k}_{rank}"]
            diff = q != qr
            if not diff.any():
                continue
            n += int(diff.sum())
            a, b = q[diff], qr[diff]
            mid = (a + b) / 2
            far = max(far, float((np.abs(r[diff] - mid)
                                  / np.maximum(np.abs(mid), 1.0)).max()))
            steps = max(steps, int(grid_steps(a, b, wire).max()))
        if n:
            return k, n, far, steps
    return None


#: how far from the rounding midpoint a flipped element's quotient may lie
#: (relative to the quotient; the two sides' fp32 partial sums differ in
#: their last bits)
MIDPOINT = 1e-4
#: what a rounding flip at one boundary element moved the loss by at this
#: size, at most (measured: 1.2e-4 for int8 on (1, 2, 2), 2.5e-4 for fp8 on
#: (1, 4, 1)), with margin
FLIP_LOSS = 5e-4


def assert_flips_only(runs, mesh, case, ref, wire):
    """Where the port's own grid values first differ from the reference's,
    each differing element is one grid step away and its quotient lies at
    the rounding midpoint: a flip, not a different quantizer.  Returns
    whether any call differs."""
    first = grid_differences(runs, mesh, case, ref, wire)
    if first is None:
        return False
    k, n, far, steps = first
    assert steps == 1 and far <= MIDPOINT, (case, k, n, far, steps)
    return True


CASES = [(mesh, name) for mesh in MESHES for name in PLANS]
IDS = [f"{'x'.join(map(str, m))}-{n}" for m, n in CASES]


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_loss_and_logits_equal_the_references_same_plan(runs, references,
                                                        mesh, name):
    """bf16 wire: the loss within 1e-5, the logits within 1e-4.  Quantized
    wire: with the reference's grid values on the wire (replayed), the
    loss within 1e-5 and the logits within 1e-4, and the port's own grid
    values, fed the same values, differ from the reference's only by
    rounding flips; on its own grid values, the loss within 1e-4 where no
    boundary flipped and within ``FLIP_LOSS`` where one did (the first
    call where the values part shows flips only)."""
    want_loss, _, want_logits = references[mesh, name]
    losses = [result(runs, mesh, name, r)["loss"] for r in range(4)]
    assert len(set(losses)) == 1, losses
    if wire_of(name) == "bf16":
        assert abs(losses[0] - want_loss) <= 1e-5, (losses[0], want_loss)
        np.testing.assert_allclose(port_logits(runs, mesh, name),
                                   want_logits, **TOL)
        return
    ref = np.load(runs[mesh][0] / f"replay_{name}.npz")
    replay = f"{name}-replay"
    for rank in range(4):
        loss = result(runs, mesh, replay, rank)["loss"]
        assert abs(loss - want_loss) <= 1e-5, (rank, loss, want_loss)
    np.testing.assert_allclose(port_logits(runs, mesh, replay), want_logits,
                               **TOL)
    assert_flips_only(runs, mesh, replay, ref, wire_of(name))
    flipped = assert_flips_only(runs, mesh, name, ref, wire_of(name))
    assert abs(losses[0] - want_loss) <= (FLIP_LOSS if flipped else 1e-4), (
        losses[0], want_loss, flipped)


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_gradients_are_reduced_once(runs, references, mesh, name):
    """bf16 wire: the reference's psum-plan gradients (and a ring plan's
    the reference's ring gradient / tp too) at 1e-4.  Quantized wire:
    without seq_parallel the port quantizes the column-first inputs'
    partial gradients where the reference quantizes the residual stream's
    (``core.atp``), so per leaf the port's gradient is held to the
    reference's ring gradient on the same wire / tp, and to the exact
    (psum-plan) gradient, each within twice the reference's own distance
    from the exact gradient (relative L2; two quantizations of that size
    are sqrt 2 of it apart)."""
    tp = mesh[1] * mesh[2]
    wire = wire_of(name)
    psum = references[mesh, "psum"][1]
    for rank in range(4):
        got = port_grads(runs, mesh, name, rank)
        exact = shard_grads("llama3-8b", psum, mesh, rank)
        if wire == "bf16":
            wants = [exact]
            if "ring" in name:
                wants.append(shard_grads("llama3-8b", jax.tree.map(
                    lambda g: g / tp, references[mesh, "ring"][1]), mesh,
                    rank))
            for want in wants:
                for key, w in want.items():
                    np.testing.assert_allclose(
                        got[key], w, **TOL, err_msg=f"rank {rank} {key}")
            continue
        quant = shard_grads("llama3-8b", jax.tree.map(
            lambda g: g / tp, references[mesh, f"{wire}-ring"][1]), mesh,
            rank)
        for key, w in quant.items():
            own = rel(w, exact[key])
            assert rel(got[key], w) <= 2 * own + 1e-5, (rank, key)
            assert rel(got[key], exact[key]) <= 2 * own + 1e-5, (rank, key)


def _load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_wire", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def witness(cfg, params, mesh, wire, replay, bwd_replay):
    """The plain witness on the forward grid values ``replay`` and the
    backward's ``bwd_replay``: its loss, its global gradients (a numpy
    tree) and its own backward grid values and quotients (``q{CALL}_{RANK}``,
    ``r{CALL}_{RANK}``)."""
    cs = _load_chip_smoke()
    tree = jax.tree.map(lambda a: torch.tensor(np.asarray(a),
                                               requires_grad=True), params)
    leaves, treedef = jax.tree.flatten(tree)
    glob = batch_of(cfg, BATCH, SEQ)
    own = {}
    loss = cs.wire_witness_loss(
        torch, cfg, tree, torch.from_numpy(glob["tokens"]),
        torch.from_numpy(glob["labels"]), mesh[1], mesh[2], wire,
        replay=replay, bwd_replay=bwd_replay, own=own)
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss.detach()),
            jax.tree.unflatten(treedef, [g.numpy() for g in grads]), own)


def port_backward_grid(runs, mesh, case) -> dict:
    """The port's backward grid values and scales, ``q{CALL}_{RANK}``,
    ``s{CALL}_{RANK}``, from every rank's record."""
    d, out = runs[mesh][0], {}
    for rank in range(4):
        for k, v in np.load(d / f"own_bwd_{case}_rank{rank}.npz").items():
            out[f"{k}_{rank}"] = v
    return out


WITNESS = [(mesh, name) for mesh in MESHES for name in QUANT_PLANS]


@pytest.mark.parametrize("mesh,name", WITNESS, ids=[
    f"{'x'.join(map(str, m))}-{n}" for m, n in WITNESS])
def test_quantized_gradients_equal_a_plain_witness_of_the_placement(
        runs, references, weights, mesh, name):
    """The port's backward wire against the plain witness of its placement
    (``chip_smoke.wire_witness_loss``), both on the reference's forward
    grid values.  The witness computes, at each of the port's backward
    calls, the ranks' partial gradients itself; with the port's grid
    values of the earlier calls on its own wire, its own grid values
    differ from the port's only by rounding flips (one grid step, the
    quotient within ``MIDPOINT`` of the midpoint), call by call; with all
    of the port's grid values, the witness's loss equals the reference's
    within 1e-5 and every gradient the port's at 1e-4.  So the port puts
    on the backward wire exactly the partial gradients its placement
    names, each reduced once."""
    cfg, params = weights["llama3-8b"]
    wire, case = wire_of(name), f"{name}-replay"
    port = port_backward_grid(runs, mesh, case)
    loss, grads, own = witness(cfg, params, mesh, wire,
                               np.load(runs[mesh][0] / f"replay_{name}.npz"),
                               port)
    calls = sorted({int(k[1:].split("_")[0]) for k in port
                    if k.startswith("q")})
    assert calls == list(range(len(calls))) and len(calls) == (
        2 if mesh[2] == 1 else 3) * 2, calls
    assert set(own) == {f"{c}{k[1:]}" for k in port if k.startswith("q")
                        for c in "qr"}
    for k in calls:
        for rank in range(4):
            q, r = own[f"q{k}_{rank}"], own[f"r{k}_{rank}"]
            qp = port[f"q{k}_{rank}"]
            diff = q != qp
            if diff.any():
                mid = (q[diff] + qp[diff]) / 2
                far = float((np.abs(r[diff] - mid)
                             / np.maximum(np.abs(mid), 1.0)).max())
                steps = int(grid_steps(q[diff], qp[diff], wire).max())
                assert steps == 1 and far <= MIDPOINT, (k, rank, far, steps)
    assert abs(loss - references[mesh, name][0]) <= 1e-5, (
        loss, references[mesh, name][0])
    for rank in range(4):
        got = port_grads(runs, mesh, case, rank)
        for key, w in shard_grads("llama3-8b", grads, mesh, rank).items():
            np.testing.assert_allclose(got[key], w, **TOL,
                                       err_msg=f"rank {rank} {key}")


def test_zamba_masks_seq_parallel_and_runs_the_ring(runs, weights):
    """zamba2-7b under ring + seq_parallel: its zamba and mamba segments
    mask seq_parallel (no reduce-scatter, no sequence gather), its row
    boundaries run rings; the loss and gradients equal the reference's
    psum-plan ones (a ring reduces each gradient once)."""
    cfg, params = weights["zamba2-7b"]
    mesh = (1, 2, 2)
    ctx_plan = plan_of(mesh, {})
    rplan = RefPlan.from_dict(ctx_plan)
    topo = rplan.topo()
    ctx = jax_make_context(topo, plan=rplan)
    pspecs = jax_lm.param_specs(cfg, ctx)
    glob = batch_of(cfg, BATCH, 32)
    fn = jax.jit(shard_map(
        lambda p, b: jax.value_and_grad(
            lambda q: jax_lm.train_loss(ctx, cfg, q, b, remat=False))(p),
        mesh=topo.build(jax.devices()[:topo.size]),
        in_specs=(pspecs, batch_pspecs(cfg, topo, "train")),
        out_specs=(P(), pspecs), check_vma=_check_vma(ctx)))
    want_loss, want = fn(params, glob)
    want = jax.tree.map(np.asarray, want)
    for rank in range(4):
        res = result(runs, mesh, "zamba-ring-sp", rank)
        assert abs(res["loss"] - float(want_loss)) <= 1e-5
        ops = {(op, q) for _, op, _, q, _, _ in res["fwd"]}
        assert ("ppermute", False) in ops
        assert not {"reduce_scatter"} & {op for op, _ in ops}
        got = port_grads(runs, mesh, "zamba-ring-sp", rank)
        for key, w in shard_grads("zamba2-7b", want, mesh, rank).items():
            np.testing.assert_allclose(got[key], w, **TOL,
                                       err_msg=f"rank {rank} {key}")
