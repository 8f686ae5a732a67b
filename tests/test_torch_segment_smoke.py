"""The port's mixed dense + MoE smoke gate (``repro_torch.launch.
segment_smoke``, the counterpart of ``repro.launch.segment_smoke``).

One run of ``python -m repro_torch.launch.segment_smoke --record DIR``
(8 gloo ranks on the CPU: ic3, tp 4, dp 2) must pass the reference's five
checks -- the per-segment search, the v2 plan JSON round trip and
``describe``, the per-segment contexts after loading, decode masking
seq_parallel, three training steps under the mixed plan whose losses
equal the all-replicated plan's within 1e-4 -- and exit 0.  The
reference's static jaxpr lint of the mixed train and decode steps has no
counterpart in the port: each rank's recorded forward collectives of the
mixed train step and of a decode tick are held against
``repro.analysis.expect.expected_signature`` instead, key for key, with
the departures ``test_torch_collectives.departed`` names.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ModelConfig, MoEConfig  # noqa: E402
from repro.analysis.expect import expected_signature  # noqa: E402
from repro.core.plan import ParallelPlan as RefPlan  # noqa: E402
from repro_torch.core.plan import ParallelPlan  # noqa: E402
from repro_torch.launch import segment_smoke  # noqa: E402

from test_torch_collectives import departed  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CHECKS = ("every ranked plan carries per-segment knobs",
          "search never assigns seq_parallel to the MoE segment",
          "v2 plan JSON round-trip is exact",
          "train dense segment: chunks=2 seq_parallel=True",
          "train moe segment: chunks=1 seq_parallel masked",
          "decode masks seq_parallel in every segment plan",
          "mixed-plan losses match replicated plan")


def ref_config():
    """The reference's smoke-mix (``repro/launch/segment_smoke.py:46-54``)."""
    return ModelConfig(
        name="smoke-mix", family="moe", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        dtype="float32",
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                      first_dense_layers=1))


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """One run of the gate, its records kept."""
    record = tmp_path_factory.mktemp("segment_smoke")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.segment_smoke",
         "--record", str(record)], env=env, capture_output=True, text=True,
        timeout=300)
    return proc, record


def test_the_port_config_is_the_references():
    port = segment_smoke.smoke_config()
    ref = ref_config()
    for field in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab_size", "head_dim", "dtype"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.moe.num_experts == ref.moe.num_experts
    assert port.moe.first_dense_layers == ref.moe.first_dense_layers


def test_the_gate_passes_its_five_checks_on_eight_ranks(smoke):
    proc, _ = smoke
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    for what in CHECKS:
        assert f"[segment-smoke] ok: {what}" in out, what
    assert "[segment-smoke] PASS" in out
    assert out.count("[segment-smoke] ok: rank ") == segment_smoke.RANKS


def test_a_failed_check_exits_non_zero(capsys):
    with pytest.raises(SystemExit) as e:
        segment_smoke.check(False, "a planted mismatch")
    assert e.value.code == 1
    assert "FAIL: a planted mismatch" in capsys.readouterr().out


def _recorded(rows):
    return {(r, op, tuple(axes), q): (n, b) for r, op, axes, q, n, b in rows}


@pytest.mark.parametrize("phase", ["train", "decode"])
def test_the_mixed_records_equal_the_references_expectation(smoke, phase):
    """Every rank's forward record of the mixed plan's train step (b = 8,
    s = 32: the dense segment's sequence-parallel reduce-scatters and
    gathers, the MoE all-to-alls) and of its decode tick (4 rows,
    seq_parallel masked, the MoE's replicated dispatch), count for count
    and byte for byte."""
    proc, record = smoke
    assert proc.returncode == 0, proc.stdout
    plan = ParallelPlan.load(str(record / "plan.json"))
    cfg = ref_config()
    batch, seq = ((segment_smoke.BATCH, segment_smoke.SEQ) if phase == "train"
                  else (segment_smoke.DECODE_B, 1))
    exp = expected_signature(cfg, RefPlan.from_dict(plan.to_dict()), phase,
                             batch, seq).by_key()
    want = departed(exp, cfg, plan, batch, seq)
    for r in range(segment_smoke.RANKS):
        got = _recorded(json.loads((record / f"rank{r}.json").read_text())[
            phase])
        assert got == want, (r, sorted(set(got.items()) ^ set(want.items())))
    regions = {k[0] for k in want}
    assert {"seg0:dense", "seg1:moe"} <= regions
