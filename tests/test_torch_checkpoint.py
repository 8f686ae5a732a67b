"""The port's checkpoints (``repro_torch.checkpoint.manager``) and its
fault-tolerant Trainer (``repro_torch.runtime.trainer``) against the
reference's.

Checkpoints cross both ways, every leaf bit for bit: the reference's
``ckpt.save`` restores into the port, the port's restores into the
reference's ``ckpt.restore`` (bf16 and fp8 as raw bytes under their
names, fp32, the int32 step), and the two packages write the same
``meta.json`` for one tree.  A model's checkpoint tree crosses too: the
reference's ``(params, canonical_opt)`` of reduced llama3-8b (bf16) and
zamba2-7b (fp32 and bf16 leaves) restores through the port's
``make_elastic_trainer`` codec (its template from the config's shapes
alone) onto the port's shards, and the port's encoded tree restores in the
reference.  The manager's and the Trainer's own cases mirror the
reference's ``tests/test_fault_tolerance.py``.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import manager as ref_ckpt  # noqa: E402
from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.plan import ParallelPlan  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenSource  # noqa: E402
from repro_torch.launch.train import make_elastic_trainer  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.trainer import (StragglerWatchdog, Trainer,  # noqa: E402
                                         TrainerConfig)

#: numpy (ml_dtypes) and torch dtypes of the leaves that cross
DTYPES = (("bfloat16", ml_dtypes.bfloat16, torch.bfloat16),
          ("float8_e4m3fn", ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
          ("float8_e5m2", ml_dtypes.float8_e5m2, torch.float8_e5m2),
          ("float32", np.float32, torch.float32))


def _raw(x) -> bytes:
    """A leaf's bytes: numpy (ml_dtypes included), jax or torch."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _mixed_tree(seed: int = 0, e5m2: bool = True):
    """One leaf of each crossing dtype (with infinity and NaN bit patterns
    among the draws), nested in dicts, a tuple and a list, with a None,
    plus an int32 step: as numpy (ml_dtypes).  ``e5m2``: with the
    float8_e5m2 leaf, which the reference writes but cannot read back
    (``test_reference_float8_e5m2_checkpoint_is_unreadable``)."""
    rng = np.random.default_rng(seed)
    leaves = {}
    for name, np_dt, _ in DTYPES:
        x = (rng.standard_normal((3, 5)) * 4).astype(np.float32)
        x[0, 0], x[0, 1] = np.inf, np.nan
        leaves[name] = x.astype(np_dt)
    return {"zz": {"b": leaves["bfloat16"], "a": leaves["float32"]},
            "fp8": (leaves["float8_e4m3fn"], None,
                    [leaves["float8_e5m2"]] if e5m2 else []),
            "step": np.array(11, np.int32)}


def _to_port(tree):
    """The same tree with torch leaves (raw bytes kept), the step numpy."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_port(v) for v in tree)
    if tree is None or tree.dtype == np.int32:
        return tree
    name = np.dtype(tree.dtype).name
    want = next(t for n, _, t in DTYPES if n == name)
    if want == torch.float32:
        return torch.from_numpy(tree.copy())
    ints = tree.view(np.int16 if tree.itemsize == 2 else np.uint8).copy()
    return torch.from_numpy(ints).view(want)


def test_leaf_order_and_structure_are_jax_tree_flattens():
    tree = _mixed_tree()
    leaves, treedef = jax.tree.flatten(tree)
    mine = ckpt.flatten(_to_port(tree))
    assert [_raw(a) for a in mine] == [_raw(b) for b in leaves]
    assert ckpt._flatten(tree)[1] == str(treedef).removeprefix(
        "PyTreeDef(").removesuffix(")")
    back = ckpt.unflatten(tree, list(range(len(leaves))))
    assert back == jax.tree.unflatten(treedef, list(range(len(leaves))))


def test_both_writers_write_the_same_meta(tmp_path):
    tree = _mixed_tree(e5m2=False)
    ref_ckpt.save(str(tmp_path / "ref"), 3, tree)
    ckpt.save(str(tmp_path / "port"), 3, _to_port(tree))
    metas = [json.loads((tmp_path / w / "step_00000003" / "meta.json")
                        .read_text()) for w in ("ref", "port")]
    assert metas[0] == metas[1]
    for i in range(metas[0]["num_leaves"]):
        a, b = (np.load(tmp_path / w / "step_00000003" / f"arr_{i}.npy")
                for w in ("ref", "port"))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_reference_float8_e5m2_checkpoint_is_unreadable(tmp_path):
    """The reference's ``np.save`` of an ml_dtypes float8_e5m2 leaf writes
    the descriptor ``<f1`` (its dtype's ``str``), which ``np.load`` refuses,
    so such a checkpoint restores nowhere; the port writes the leaf's raw
    bytes as ``|V1`` under its name, which both packages read
    (``test_port_checkpoint_restores_in_the_reference_bit_for_bit``)."""
    x = np.ones(4, ml_dtypes.float8_e5m2)
    ref_ckpt.save(str(tmp_path / "ref"), 1, {"x": x})
    with pytest.raises(ValueError, match="<f1"):
        ref_ckpt.restore(str(tmp_path / "ref"), {"x": x})
    ckpt.save(str(tmp_path / "port"), 1, _to_port({"x": x}))
    assert np.load(tmp_path / "port" / "step_00000001" / "arr_0.npy"
                   ).dtype == np.dtype("V1")


def test_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    tree = _mixed_tree(1, e5m2=False)
    ref_ckpt.save(str(tmp_path), 5, tree)
    template = _to_port(tree)
    out, meta = ckpt.restore(str(tmp_path), template)
    assert meta["step"] == 5
    got, want = ckpt.flatten(out), jax.tree.leaves(tree)
    assert [g.dtype for g in got] == [t.dtype if isinstance(t, torch.Tensor)
                                      else torch.int32
                                      for t in ckpt.flatten(template)]
    assert [_raw(g) for g in got] == [_raw(w) for w in want]
    # from a template of shapes and dtypes alone, onto the host as numpy
    specs = ckpt.unflatten(tree, [ckpt.LeafSpec(t.shape, t.dtype)
                                  for t in ckpt.flatten(template)])
    host, _ = ckpt.restore(str(tmp_path), specs, shardings=ckpt.HOST)
    assert [_raw(g) for g in ckpt.flatten(host)] == [_raw(w) for w in want]


def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    tree = _mixed_tree(2)
    ckpt.save(str(tmp_path), 6, _to_port(tree))
    out, meta = ref_ckpt.restore(str(tmp_path), jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree))
    assert meta["step"] == 6
    got, want = jax.tree.leaves(out), jax.tree.leaves(tree)
    assert [np.asarray(g).dtype for g in got] == [w.dtype for w in want]
    assert [_raw(g) for g in got] == [_raw(w) for w in want]


def _reference_tree(cfg_name: str, step: int):
    """The reference's checkpoint tree of a reduced config: its global
    params and plain's canonical opt state with seeded moments."""
    cfg = ref_get_config(cfg_name).reduced()
    params = jax.tree.map(np.asarray,
                          ref_lm.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    leaves = jax.tree.map(lambda p: {
        "m": rng.standard_normal(p.shape).astype(np.float32),
        "v": rng.random(p.shape).astype(np.float32)}, params)
    return params, {"leaves": leaves, "step": np.array(step, np.int32)}


def _port_trainer(name: str, tmp_path, mode: str = "zero1"):
    cfg = get_config(name).reduced()
    return make_elastic_trainer(
        cfg, ParallelPlan(d1=1, d2=1, dp=1),
        adamw.AdamWConfig(mode=mode),
        TrainerConfig(total_steps=1, ckpt_dir=str(tmp_path)),
        TokenSource(DataConfig(cfg.vocab_size, 8, 2)), batch=2, seq=8,
        device="cpu")


@pytest.mark.parametrize("name", ["llama3-8b", "zamba2-7b"])
def test_model_checkpoint_crosses_both_ways(tmp_path, name):
    """The reference's (params, canonical opt) restores through the port's
    codec onto its shards bit for bit, and the port's encoded tree
    restores in the reference bit for bit, its template from shapes."""
    params, canon = _reference_tree(name, 4)
    ref_ckpt.save(str(tmp_path / "ref"), 4, (params, canon))
    trainer, live = _port_trainer(name, tmp_path / "ref")
    p, opt, step = trainer._restore_or_init()
    assert step == 4 and opt["step"] == 4
    cfg, ctx = get_config(name).reduced(), lm.layout_context(
        live["plan"].topo(), 0)
    want = convert.params_from_jax(cfg, params, live["plan"].topo(), 0)
    assert [_raw(a) for a in adamw.tree_leaves(p)] == \
        [_raw(b) for b in adamw.tree_leaves(want)]
    for k in ("m", "v"):
        moments = lm.shard_params(cfg, convert.tree_to_torch(
            jax.tree.map(lambda x: x[k], canon["leaves"],
                         is_leaf=lambda x: isinstance(x, dict)
                         and set(x) == {"m", "v"})), ctx)
        assert [_raw(st[k]) for st in _states(opt["leaves"])] == \
            [_raw(b) for b in adamw.tree_leaves(moments)]
    # and back: the port's tree restores in the reference
    ckpt.save(str(tmp_path / "port"), 4, trainer.encode_ckpt(p, opt))
    ref_cfg = ref_get_config(name).reduced()
    tmpl = (jax.eval_shape(lambda: ref_lm.init_params(
        ref_cfg, jax.random.PRNGKey(0))),
        {"leaves": jax.tree.map(lambda x: {
            "m": jax.ShapeDtypeStruct(x.shape, jnp.float32),
            "v": jax.ShapeDtypeStruct(x.shape, jnp.float32)},
            jax.eval_shape(lambda: ref_lm.init_params(
                ref_cfg, jax.random.PRNGKey(0)))),
         "step": jax.ShapeDtypeStruct((), jnp.int32)})
    back, meta = ref_ckpt.restore(str(tmp_path / "port"), tmpl)
    assert [_raw(a) for a in jax.tree.leaves(back)] == \
        [_raw(b) for b in jax.tree.leaves((params, canon))]


def _states(tree) -> list:
    """The {"m", "v"} leaves of an opt state's ``leaves``, in order."""
    if set(tree) == {"m", "v"} and not isinstance(tree["m"], dict):
        return [tree]
    return [s for v in tree.values() for s in _states(v)]


def test_compressed_state_carries_its_residual(tmp_path):
    """In compressed mode the checkpoint holds ``err`` beside the moments
    (as the reference's), and it round-trips through the codec."""
    trainer, _ = _port_trainer("llama3-8b", tmp_path, mode="compressed")
    params, opt = trainer.init_state()
    for t in adamw.tree_leaves(opt["err"]):
        t.normal_()
    opt["step"] = 3
    tree = trainer.encode_ckpt(params, opt)
    assert set(tree[1]) == {"err", "leaves", "step"}
    ckpt.save(str(tmp_path), 3, tree)
    p2, o2, step = trainer._restore_or_init()
    assert step == 3 and o2["step"] == 3
    assert all(torch.equal(a, b) for a, b in zip(
        adamw.tree_leaves(o2["err"]), adamw.tree_leaves(opt["err"])))


# ---------------------------------------------------------------------------
# The reference's tests/test_fault_tolerance.py, on the port.
# ---------------------------------------------------------------------------


def _orphan(tmp_path):
    d = os.path.join(str(tmp_path), ".tmp_dead")
    os.makedirs(d)
    with open(os.path.join(d, "arr_0.npy"), "w") as f:
        f.write("junk")
    return d


def test_save_sweeps_orphans_on_entry(tmp_path):
    d = _orphan(tmp_path)
    ckpt.save(str(tmp_path), 1, {"a": torch.ones(3)})
    assert not os.path.exists(d)
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_prune_sweeps_orphans(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.ones(3)})
    d = _orphan(tmp_path)
    ckpt.prune(str(tmp_path), keep=1)
    assert not os.path.exists(d)
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_sweep_missing_dir_is_noop(tmp_path):
    assert ckpt.sweep_orphan_tmps(os.path.join(str(tmp_path), "no")) == 0


def test_failed_save_cleans_its_tmp(tmp_path):
    class Boom:
        def __array__(self, *a, **k):
            raise RuntimeError("boom")   # fails mid-save, inside try

    with pytest.raises(RuntimeError):
        ckpt.save(str(tmp_path), 1, {"a": torch.ones(3), "b": Boom()})
    assert not [n for n in os.listdir(str(tmp_path))
                if n.startswith(".tmp_")]


def test_save_restore_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4), "b": {"c": torch.ones(5)}}
    ckpt.save(str(tmp_path), 7, tree)
    out, meta = ckpt.restore(str(tmp_path), tree)
    assert meta["step"] == 7
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])


def test_uncommitted_checkpoint_is_invisible(tmp_path):
    d = ckpt.save(str(tmp_path), 1, {"a": torch.ones(3)})
    os.remove(os.path.join(d, "COMMITTED"))
    assert ckpt.latest_step(str(tmp_path)) is None


def test_latest_and_prune(tmp_path):
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, {"a": torch.ones(3)})
    assert ckpt.latest_step(str(tmp_path)) == 4
    ckpt.prune(str(tmp_path), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert not os.path.exists(os.path.join(str(tmp_path), "step_00000001"))


def test_restore_casts_to_the_template_and_places(tmp_path):
    """``test_sharded_restore_casts_to_template_dtype`` and
    ``test_bf16_checkpoint_round_trips``: the on-disk dtype does not leak
    through, on any placement; bf16 on disk into an fp32 template gives the
    bits recovered, then cast."""
    x = torch.arange(16.0).bfloat16() / 3
    ckpt.save(str(tmp_path), 1, {"x": x, "y": torch.arange(8.0)})
    tmpl = {"x": torch.zeros(16, dtype=torch.bfloat16),
            "y": torch.zeros(8, dtype=torch.bfloat16)}
    out, meta = ckpt.restore(str(tmp_path), tmpl,
                             shardings={"x": torch.device("cpu"), "y": None})
    assert meta["dtypes"] == ["bfloat16", "float32"]
    assert out["x"].dtype == out["y"].dtype == torch.bfloat16
    assert torch.equal(out["x"], x)
    out32, _ = ckpt.restore(str(tmp_path), {"x": torch.zeros(16),
                                            "y": torch.zeros(8)})
    assert torch.equal(out32["x"], x.float())


class _Clock:
    def __init__(self):
        self.t = 0.0
        self.step_cost = 1.0

    def __call__(self):
        self.t += self.step_cost / 2
        return self.t


def _source():
    return TokenSource(DataConfig(vocab_size=10, seq_len=4, global_batch=2))


def _mk(tmp_path, total=8, ckpt_every=2):
    cfg = TrainerConfig(total_steps=total, ckpt_dir=str(tmp_path),
                        ckpt_every=ckpt_every, max_failures=3)

    def build_step():
        def step(params, opt, batch):
            w = params["w"] + batch["tokens"].sum() * 0 + 1.0
            return {"w": w}, opt, {"loss": 1.0 / (w + 1)}
        return step

    def init_state():
        return {"w": torch.zeros(())}, {"n": torch.zeros(())}

    return Trainer(cfg, build_step, _source(), init_state, lambda b: {
        "tokens": torch.as_tensor(b["tokens"])})


def test_trainer_runs_to_completion(tmp_path):
    params, _ = _mk(tmp_path).run()
    assert float(params["w"]) == 8.0
    assert ckpt.latest_step(str(tmp_path)) == 8


def test_trainer_recovers_from_injected_failure(tmp_path):
    tr = _mk(tmp_path)
    fired = {"n": 0}

    def injector(step):
        if step == 5 and fired["n"] == 0:
            fired["n"] = 1
            raise RuntimeError("simulated device failure")

    params, _ = tr.run(fail_injector=injector)
    assert tr.total_failures == 1 and tr.failures == 0
    assert float(params["w"]) == 8.0


def test_failure_counter_decays_after_recovery(tmp_path):
    tr = _mk(tmp_path)
    tr.cfg.max_failures = 1
    fails = {s: 1 for s in (2, 5, 7)}

    def injector(step):
        if fails.get(step):
            fails[step] = 0
            raise RuntimeError("transient fault")

    params, _ = tr.run(fail_injector=injector)
    assert tr.total_failures == 3 and tr.failures == 0
    assert float(params["w"]) == 8.0


def test_consecutive_failures_still_give_up(tmp_path):
    tr = _mk(tmp_path)
    tr.cfg.max_failures = 2
    with pytest.raises(RuntimeError):
        tr.run(fail_injector=lambda step: (_ for _ in ()).throw(
            RuntimeError("persistent")))
    assert tr.failures == 3


def test_transient_fault_is_not_a_replan(tmp_path):
    tr = _mk(tmp_path)
    step_fn = tr.build_step()
    tr.replan = lambda: step_fn
    tr.build_step = lambda: step_fn
    fired = {"n": 0}

    def injector(step):
        if step == 5 and fired["n"] == 0:
            fired["n"] = 1
            raise RuntimeError("transient fault, pool intact")

    tr.watchdog.ema = 123.0
    tr.run(fail_injector=injector)
    assert tr.replans == [] and tr.total_failures == 1


def test_gives_up_after_max_failures(tmp_path):
    tr = _mk(tmp_path)
    tr.cfg.max_failures = 1
    with pytest.raises(RuntimeError):
        tr.run(fail_injector=lambda step: (_ for _ in ()).throw(
            RuntimeError("persistent failure")))


def test_torn_save_is_counted_swept_and_retried(tmp_path):
    """A torn save (an OSError) is counted against the same budget,
    its orphan swept, and retried at once; the run completes."""
    from repro_torch.runtime.faults import (FaultEvent, FaultPlan,
                                            TornCheckpointWrites)

    tr = _mk(tmp_path)
    with TornCheckpointWrites(FaultPlan.scripted(
            FaultEvent("torn_ckpt", at=4))) as torn:
        params, _ = tr.run()
    assert torn.torn == [4] and tr.total_failures == 1
    assert float(params["w"]) == 8.0
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp_")]


def test_watchdog_flags_slow_step():
    wd = StragglerWatchdog(factor=3.0, beta=0.5)
    for _ in range(5):
        assert not wd.observe(0, 1.0)
    assert wd.observe(5, 10.0)
    assert wd.events and wd.events[0][0] == 5


def test_outliers_do_not_poison_ema():
    wd = StragglerWatchdog(factor=3.0, beta=0.5)
    for _ in range(5):
        wd.observe(0, 1.0)
    wd.observe(5, 100.0)
    assert wd.ema == pytest.approx(1.0, rel=0.01)


def test_reset_forgets_ema_keeps_events():
    wd = StragglerWatchdog(factor=3.0, beta=0.5)
    for _ in range(5):
        wd.observe(0, 1.0)
    wd.observe(5, 10.0)
    wd.reset()
    assert wd.ema is None and wd.events
    assert not wd.observe(6, 5.0)
    assert wd.ema == 5.0


def test_replan_resets_watchdog(tmp_path):
    cfg = TrainerConfig(total_steps=8, ckpt_dir=str(tmp_path), ckpt_every=2,
                        max_failures=2, straggler_factor=3.0)
    clock = _Clock()
    fired = {"n": 0}

    def injector(step):
        if step == 4 and fired["n"] == 0:
            fired["n"] = 1
            clock.step_cost = 10.0
            raise RuntimeError("device loss")

    def build_step():
        def step(params, opt, batch):
            return {"w": params["w"] + 1}, opt, {"loss": 0.0}
        return step

    hooks = []
    tr = Trainer(cfg, build_step, _source(),
                 lambda: ({"w": torch.zeros(())}, {}),
                 lambda b: b, mitigation_hook=hooks.append,
                 time_fn=clock, replan=build_step)
    tr.run(fail_injector=injector)
    assert tr.replans == [4]
    assert not hooks and not tr.watchdog.events
    assert tr.watchdog.ema == pytest.approx(5.0)


def test_trainer_fires_mitigation_hook(tmp_path):
    cfg = TrainerConfig(total_steps=8, ckpt_dir=str(tmp_path),
                        ckpt_every=100)
    clock = _Clock()
    hooks = []

    def build_step():
        def step(params, opt, batch):
            clock.step_cost = 50.0 if int(params["w"]) == 5 else 1.0
            return {"w": params["w"] + 1}, opt, {"loss": 0.0}
        return step

    tr = Trainer(cfg, build_step, _source(),
                 lambda: ({"w": torch.zeros(())}, {}),
                 lambda b: b, mitigation_hook=hooks.append, time_fn=clock)
    tr.run()
    assert hooks == [5]


def test_failed_gather_is_counted_and_retried(tmp_path):
    """A device error while the checkpoint tree is gathered to the host
    (``encode_ckpt`` raising) costs only the attempt, as a torn write
    does: counted against the budget, retried, and the run completes."""
    tr = _mk(tmp_path)
    encode, fails = tr.encode_ckpt, {4: 1}

    def flaky(params, opt):
        if fails.get(int(params["w"])):
            fails[int(params["w"])] = 0
            raise RuntimeError("device error while gathering")
        return encode(params, opt)

    tr.encode_ckpt = flaky
    params, _ = tr.run()
    assert tr.total_failures == 1 and tr.failures == 0
    assert float(params["w"]) == 8.0 and ckpt.latest_step(str(tmp_path)) == 8
