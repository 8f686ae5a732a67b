"""The port's elastic shrink across processes against the reference's
``make_elastic_trainer``.

Four gloo ranks on the CPU (one process each, ``_torch_elastic_worker.py``)
train the reference's tiny dense model from the reference's weights under
the reference's plan (dp 2 x tp 2, zero1), over 4 simulated hosts of one
rank each; a transient fault at step 3 restores step 2 onto the intact
mesh (the moments unbanked on save, re-banked at dp 2 on restore), and
hosts 2 and 3 are lost at step 5.  Ranks 2 and 3 leave, ranks
0 and 1 join a new group, recalibrate with the same injected benchmark as
the reference, re-plan, restore the step-4 checkpoint (written at dp 2,
its moments unbanked) onto the new mesh and replay.  The re-planned
plan's JSON equals the reference's run on 4 host devices, each step's loss
is within 1e-4 of the reference's, and the port's step-4 checkpoint
(zero1 at dp 2, written in plain's layout) restores in the reference's
``ckpt.restore`` within fp32 noise of the reference's own.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import manager as ref_ckpt  # noqa: E402
from repro.configs.base import ModelConfig  # noqa: E402
from repro.core.calibrate import CalibEntry  # noqa: E402
from repro.core.plan import plan_search  # noqa: E402
from repro.data.pipeline import DataConfig, TokenSource  # noqa: E402
from repro.launch.train import make_elastic_trainer  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.runtime.faults import (FaultEvent, FaultPlan,  # noqa: E402
                                  trainer_injector)
from repro.runtime.membership import (MembershipRuntime,  # noqa: E402
                                      fabric_over_devices)
from repro.runtime.trainer import TrainerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_elastic_worker.py"
WORLD = 4
CFG = dict(name="smoke-elastic", family="dense", num_layers=2, d_model=64,
           num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
           head_dim=16, dtype="float32")
LOSS_TOL = 1e-4


def _measure(d1, d2):
    """The recalibration's injected benchmark, the same on both sides."""
    return CalibEntry(b1=40.0 / d1, b2=25.0 / d2, t_psum=1e-5, t_ring=2e-5,
                      alpha_s=3e-6)


def _reference(tmp_path, cfg, plan, faults):
    fabric = fabric_over_devices(4, jax.devices()[:4])
    trainer, live = make_elastic_trainer(
        cfg, plan, ref_adamw.AdamWConfig(lr=1e-3, mode="zero1",
                                         total_steps=8),
        TrainerConfig(total_steps=8, ckpt_dir=str(tmp_path / "ref"),
                      ckpt_every=2, max_failures=2),
        TokenSource(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                               global_batch=8)),
        batch=8, seq=32, membership=MembershipRuntime(fabric, local_rank=0),
        recalibrate=True, measure=_measure)
    trainer.run(fail_injector=trainer_injector(faults, fabric))
    return trainer, live, fabric


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run and the port's four ranks' results."""
    tmp = tmp_path_factory.mktemp("elastic")
    cfg = ModelConfig(**CFG)
    plan = plan_search("ic3", 2, model=cfg, batch=8, seq=32, dp=2).best
    # a transient fault at step 3 restores step 2 onto the intact dp-2
    # mesh (zero1's moments re-banked), the loss of hosts 2 and 3 at step
    # 5 restores step 4 onto the survivors
    faults = FaultPlan.scripted(
        FaultEvent("device_loss", at=3),
        FaultEvent("device_loss", at=5, hosts=(2, 3)))
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(0))
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp / "params.npz", **flat)
    work = tmp / "port"
    work.mkdir()
    (work / "case.json").write_text(json.dumps({
        "cfg": CFG, "plan": plan.to_dict(), "faults": faults.to_dict(),
        "params": str(tmp / "params.npz"),
        "measure": {f"{d1},{d2}": _measure(d1, d2).to_dict()
                    for d1, d2 in ((1, 2), (2, 1), (1, 4), (2, 2),
                                   (4, 1))}}))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r),
                               str(WORLD), str(work)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=200)[0] for p in procs]
    finally:   # a rank that died leaves the others waiting
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    port = [json.loads((work / f"shrink{r}.json").read_text())
            for r in range(WORLD)]
    trainer, live, fabric = _reference(tmp, cfg, plan, faults)
    return {"port": port, "trainer": trainer, "live": live, "plan": plan,
            "fabric": fabric, "tmp": tmp, "cfg": cfg}


def test_ranks_outside_the_view_leave(runs):
    port = runs["port"]
    assert ["departed" in r for r in port] == [False, False, True, True]
    for r in port[:2]:
        assert r["replans"] == runs["trainer"].replans == [5]
        assert r["total_failures"] == 2 and r["failures"] == 0
        assert r["epochs"] == {str(e): [list(a) for a in sorted(v)]
                               for e, v in runs["fabric"].epochs().items()}


def test_replanned_plan_is_the_references(runs):
    want = runs["live"]["plan"].to_dict()
    assert want != runs["plan"].to_dict()
    for r in runs["port"][:2]:
        assert r["plan"] == want


def test_losses_within_1e4_of_the_references_at_every_step(runs):
    want = {h["step"]: h["loss"] for h in runs["trainer"].history}
    assert sorted(want) == list(range(8))
    for r in runs["port"][:2]:
        got = {int(k): v for k, v in r["losses"].items()}
        assert sorted(got) == sorted(want)
        for s in want:
            assert abs(got[s] - want[s]) <= LOSS_TOL * max(1.0, abs(want[s])), \
                (s, got[s], want[s])


def test_zero1_dp2_checkpoint_restores_in_the_reference(runs):
    """Step 4 was written at dp 2 (zero1's banked moments unbanked into
    plain's layout); the reference reads it with its own template, and it
    holds the reference's own step-4 state within fp32 noise."""
    tmp = runs["tmp"]
    cfg = runs["cfg"]
    abstract = jax.eval_shape(lambda: ref_lm.init_params(
        cfg, jax.random.PRNGKey(0)))
    tmpl = (abstract, {
        "leaves": jax.tree.map(lambda x: {
            "m": jax.ShapeDtypeStruct(x.shape, np.float32),
            "v": jax.ShapeDtypeStruct(x.shape, np.float32)}, abstract),
        "step": jax.ShapeDtypeStruct((), np.int32)})
    got, meta = ref_ckpt.restore(str(tmp / "port" / "ckpt"), tmpl, step=4)
    want, _ = ref_ckpt.restore(str(tmp / "ref"), tmpl, step=4)
    assert meta["step"] == 4 and int(got[1]["step"]) == 4
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
