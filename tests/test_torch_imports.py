"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to fall back to the CPU when no device is named."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for name in names:
    __import__(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_every_port_module_imports_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.launch.serve" in report["modules"]
    assert "repro_torch.kernels.ops" in report["modules"]
    assert "repro_torch.launch.train" in report["modules"]
    assert "repro_torch.optim.adamw" in report["modules"]
    for name in ("checkpoint.manager", "runtime.trainer",
                 "runtime.membership", "runtime.faults",
                 "launch.elastic_smoke", "launch.chaos_smoke"):
        assert f"repro_torch.{name}" in report["modules"], name
    assert report["bad"] == []


def test_entry_points_without_a_device_raise_instead_of_using_the_cpu(
        monkeypatch):
    """With no CUDA device, an entry point that is not told ``device="cpu"``
    raises; it never runs on the CPU quietly."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.mesh import atp_topo
    from repro_torch.launch import serve, train
    from repro_torch.launch.steps import build_paged_step, build_train_step
    from repro_torch.models import lm
    from repro_torch.runtime.server import ServerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3-8b").reduced()
    params = lm.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_paged_step(cfg, atp_topo(1, 1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.make_paged_server(cfg, ServerConfig(), params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_step(cfg, atp_topo(1, 1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1", "--ckpt-dir", "unused"])
    # and the CPU runs only where it is asked for
    _, info = build_paged_step(cfg, atp_topo(1, 1, 1), device="cpu")
    assert info.device.type == "cpu"
    _, info = build_train_step(cfg, atp_topo(1, 1, 1), device="cpu")
    assert info.device.type == "cpu"
