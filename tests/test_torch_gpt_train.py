"""The paper's GPT models' training path in the port against the JAX package.

The gelu MLP's up projection fuses its activation into the matmul kernel's
epilogue.  Under autograd the port's forward is one launch that also
writes the pre-activation z (``ref.matmul_aux_ref`` is its plain
version), and the backward takes the activation's derivative at z
(``ops.activation_backward``, plain version ``ref.epilogue_bwd``) before
the matmul's backward.  Here, on the CPU in fp32, from numpy inputs made
from a seed:
- the two-output plain forward against the JAX package's matmul (Pallas
  in interpret mode), with and without its activation;
- the derivative against ``jax.vjp`` of ``jax.nn.gelu(approximate=True)``
  and ``jax.nn.silu``, out to |z| > 10;
- ``ops.matmul`` with a fused activation under autograd against
  ``jax.grad``, through both new functions, the derivative once a
  backward;
- one training step of each trained kind with its wrappers counted
  against ``chip_smoke.train_launches_per_step``, the launch model the
  card run asserts (a LayerNorm model launches no rmsnorm; one
  derivative per gelu MLP).

Tolerances: 1e-5 where one fp32 function is computed in another order,
1e-4 for gradients through a product of 24-64 terms.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
JAX_ACT = {"gelu": lambda x: jax.nn.gelu(x, approximate=True),
           "silu": jax.nn.silu}


def _load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_gpt", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("activation", ["gelu", "silu"])
@pytest.mark.parametrize("M,K,N", [(8, 16, 24), (37, 100, 77),
                                   (130, 64, 200)])
def test_two_output_forward_matches_jax_matmul(M, K, N, activation):
    """``ref.matmul_aux_ref``'s y against the JAX package's matmul with the
    fused activation, and its z against the same matmul with the bias and
    no activation (ragged M, N and K pad inside the JAX call)."""
    rng = np.random.default_rng(M + K + N)
    a, b = _randn(rng, M, K), _randn(rng, K, N, scale=K ** -0.5)
    bias = _randn(rng, N)
    y, z = ref.matmul_aux_ref(torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(bias), activation)
    want_y = jax_ops.matmul(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias),
                            activation=activation, interpret=True)
    want_z = jax_ops.matmul(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias),
                            interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z), **TOL)
    # y is the one-output plain forward's, bit for bit
    assert torch.equal(y, ref.matmul_ref(torch.from_numpy(a),
                                         torch.from_numpy(b),
                                         torch.from_numpy(bias), activation))


@pytest.mark.parametrize("activation", ["gelu", "silu"])
def test_derivative_matches_jax_vjp(activation):
    """``ref.epilogue_bwd`` (the derivative kernel's plain version) against
    ``jax.vjp`` of the activation, over |z| up to 14 (tanh and the sigmoid
    saturate) and at random points."""
    rng = np.random.default_rng(3)
    z = np.concatenate([np.linspace(-14, 14, 2001, dtype=np.float32),
                        _randn(rng, 999, scale=3.0)]).reshape(60, 50)
    dy = _randn(rng, 60, 50)
    got = ref.epilogue_bwd(torch.from_numpy(z), torch.from_numpy(dy),
                           activation)
    _, vjp = jax.vjp(JAX_ACT[activation], jnp.asarray(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]),
                               **TOL)
    # the wrapper takes the plain version for CPU tensors; no activation
    # passes dy on
    dyt, zt = torch.from_numpy(dy), torch.from_numpy(z)
    assert torch.equal(ops.activation_backward(dyt, zt, activation), got)
    assert ops.activation_backward(dyt, zt, None) is dyt


@pytest.mark.parametrize("activation", ["gelu", "silu"])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_activation_under_autograd_matches_jax_grad(monkeypatch,
                                                          activation, bias):
    """``ops.matmul(..., activation=...)`` under autograd: its forward
    through the two-output plain version once, its backward through
    ``ops.activation_backward`` once; the gradients of x, w and b against
    ``jax.grad`` of ``sum(g * act(x @ w + b))``."""
    rng = np.random.default_rng(5)
    x, w = _randn(rng, 2, 9, 24), _randn(rng, 24, 40, scale=0.3)
    b, g = _randn(rng, 40), _randn(rng, 2, 9, 40)
    calls = {"aux": 0, "act_bwd": 0}
    aux, act_bwd = ref.matmul_aux_ref, ops.activation_backward

    def counted_aux(*args, **kw):
        calls["aux"] += 1
        return aux(*args, **kw)

    def counted_act_bwd(*args, **kw):
        calls["act_bwd"] += 1
        return act_bwd(*args, **kw)

    monkeypatch.setattr(ref, "matmul_aux_ref", counted_aux)
    monkeypatch.setattr(ops, "activation_backward", counted_act_bwd)
    leaves = [torch.from_numpy(t).requires_grad_(True)
              for t in ((x, w, b) if bias else (x, w))]
    out = ops.matmul(*leaves[:2], leaves[2] if bias else None,
                     activation=activation)
    loss = (torch.from_numpy(g) * out).sum()
    got = torch.autograd.grad(loss, leaves)
    assert calls == {"aux": 1, "act_bwd": 1}

    def jax_loss(x, w, b):
        return jnp.sum(jnp.asarray(g) * JAX_ACT[activation](x @ w + b))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w),
        jnp.asarray(b) if bias else jnp.zeros(40, jnp.float32))
    for name, gt, wt in zip("xwb", got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **GRAD_TOL,
                                   err_msg=name)


#: the wrappers a training step calls, by the launch count each stands for
#: on the card (a matmul backward launches dgrad and wgrad where needed; a
#: derivative launches only for an activation)
FORWARD = {"matmul": "matmul", "flash_attention": "flash_attention",
           "rmsnorm": "rmsnorm", "group_rmsnorm": "rmsnorm",
           "ssd_scan": "ssd_scan"}
BACKWARD = {"matmul_backward": "matmul_bwd",
            "flash_attention_backward": "flash_attention_bwd",
            "rmsnorm_backward": "rmsnorm_bwd",
            "group_rmsnorm_backward": "group_rmsnorm_bwd",
            "ssd_scan_backward": "ssd_scan_bwd",
            "activation_backward": "matmul_act_bwd"}


def _launches(name, args, kw):
    if name == "matmul_backward":
        return int(kw.get("need_a", True)) + int(kw.get("need_b", True))
    if name == "activation_backward":
        return int(args[2] is not None)
    return 1


@pytest.mark.parametrize("arch,layers", [("gpt-m1", None),
                                         ("llama3-8b", None),
                                         ("zamba2-7b", 5)])
def test_train_step_launches_match_chip_smoke_model(monkeypatch, arch,
                                                    layers):
    """One CPU ``build_train_step`` step (remat on) with every kernel
    wrapper counted as the card would launch it, against the launch model
    ``chip_smoke.py`` asserts on the card: gpt-m1 launches no rmsnorm (its
    LayerNorms, the final one too, run as plain torch) and one derivative
    per gelu MLP; llama3-8b and zamba2-7b none."""
    cs = _load_chip_smoke()
    cfg = get_config(arch).reduced()
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    counts = {k: 0 for k in [*FORWARD.values(), *BACKWARD.values()]}

    def counted(name, fn, key):
        def call(*args, **kw):
            counts[key] += _launches(name, args, kw)
            return fn(*args, **kw)
        return call

    for name, key in {**FORWARD, **BACKWARD}.items():
        monkeypatch.setattr(ops, name, counted(name, getattr(ops, name), key))
    topo = atp_topo(1, 1, 1)
    params = lm.shard_params(cfg, lm.init_params(cfg, seed=0, device="cpu",
                                                 dtype=torch.float32),
                             lm.layout_context(topo, 0))
    step, info = build_train_step(cfg, topo, adamw.AdamWConfig(),
                                  device="cpu")
    state = adamw.init_opt_state(params, info.ctx, "zero1")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 17)))
    batch = {"tokens": toks[:, :-1].int(), "labels": toks[:, 1:].int()}
    step(params, state, batch)
    fwd, bwd = cs.train_launches_per_step(cfg, remat=True)
    assert counts == {**fwd, **bwd}
    if cfg.norm_kind == "layernorm":
        assert counts["rmsnorm"] == counts["rmsnorm_bwd"] == 0
        assert counts["matmul_act_bwd"] == cfg.num_layers > 0
    else:
        assert counts["rmsnorm"] > 0 and counts["matmul_act_bwd"] == 0
