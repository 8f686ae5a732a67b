"""Where xlstm-1.3b's bf16 error grows, on the CPU: its first 8 layers (one
super-block, 7 mLSTM blocks and an sLSTM block) at full width, random
weights from seed 3 (``chip_smoke.py``'s path-check-xlstm weights).

  1. The reference's own bf16 error beside the port's: the same weights
     (the port's, crossed through ``convert.params_to_numpy``) and tokens
     through the reference's ``lm.forward`` and the port's, each in fp32
     and in bf16 (the reference's bf16 leaves as its ``init_params`` makes
     them); the last 4 of 128 positions' logits, relative L2 per row.
  2. The port's plain bf16 path against its fp32 path block by block: the
     residual's error entering each block and the block's own update's.
  3. One mLSTM block's gain: its input moved by a relative 1e-3 (fp32),
     how far each stage moves, relative; and the share of the normalised
     output's move in the tenth of (position, head) rows whose readout is
     smallest, beside those rows' |q.k i|.
  4. The planted faults of path-check-xlstm (plain bf16 with the fault,
     against fp32) on its calls: the logits and each layer's state rows,
     as multiples of the plain bf16 path's own error.

Run: ``PYTHONPATH=src python tests/_torch_xlstm_bf16.py`` (about half a
minute and a few GB).  Needs jax beside torch, as the tests do; it is not a test
(its numbers are the model's, not a pass or fail).
"""
import dataclasses
import math
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import chip_smoke  # noqa: E402
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.core.atp import make_context as jax_context  # noqa: E402
from repro.core.compat import shard_map  # noqa: E402
from repro.core.mesh import MeshTopo  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import cut_depth  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.atp import make_context  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm, xlstm  # noqa: E402
from repro_torch.models.mamba2 import causal_conv  # noqa: E402

LAYERS, SEQ, SEED = 8, 128, 3


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def rows(a, b) -> str:
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    e = np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)
    return ", ".join(f"{x:.3e}" for x in e)


def witness(cfg, params, toks):
    """Part 1: the reference and the port, each in fp32 and bf16."""
    topo = atp_topo(1, 1, 1)
    jcfg = dataclasses.replace(jax_config("xlstm-1.3b"), num_layers=LAYERS)
    glob = convert.params_to_numpy(cfg, [params], topo)
    kinds = jax.eval_shape(lambda k: jax_lm.init_params(jcfg, k, jnp.bfloat16),
                           jax.random.PRNGKey(0))
    jtopo = MeshTopo((("data", 1),))
    jctx = jax_context(jtopo)

    def logits(p, t, pos):
        h = jax_lm.forward(jctx, jcfg, p, t, pos)[0]
        return jax_lm.lm_logits(jctx, jcfg, p, h[:, -4:])

    fn = jax.jit(shard_map(logits, mesh=jtopo.build(jax.devices()[:1]),
                           in_specs=(P(),) * 3, out_specs=P(),
                           check_vma=False))
    t, pos = toks.numpy().astype(np.int32), np.arange(SEQ, dtype=np.int32)[None]
    out = {"reference fp32": fn(jax.tree.map(jnp.float32, glob), t, pos),
           "reference bf16": fn(jax.tree.map(lambda a, k: jnp.asarray(
               a, k.dtype), glob, kinds), t, pos)}
    ctx = make_context(topo, device_type="cpu")
    with torch.no_grad():
        for name, tree in (("port fp32", lm.tree_map(lambda x: x.float(),
                                                     params)),
                           ("port bf16", params)):
            h = lm.forward(ctx, cfg, tree, toks, torch.arange(SEQ)[None])
            out[name] = lm.lm_logits(ctx, cfg, tree, h[:, -4:])
    out = {k: np.asarray(torch.as_tensor(np.asarray(v, np.float32))
                         if not torch.is_tensor(v) else v.float())
           for k, v in out.items()}
    print(f"1. logits of the last 4 of {SEQ} positions at {LAYERS} layers, "
          f"relative L2 per row:")
    for a, b in (("port fp32", "reference fp32"),
                 ("reference bf16", "reference fp32"),
                 ("port bf16", "port fp32"),
                 ("port bf16", "reference bf16")):
        print(f"   {a} against {b}: {rows(out[a], out[b])}")


def growth(cfg, params, toks):
    """Part 2, and the mLSTM blocks' fp32 inputs for part 3."""
    seen, inputs = {}, []
    blocks = {"mLSTM": xlstm.mlstm_block, "sLSTM": xlstm.slstm_block}

    def spy(name, tag):
        def block(ctx, c, p, x, state=None):
            y, st = blocks[name](ctx, c, p, x, state)
            seen.setdefault(tag, []).append((name, x.float(), y.float()))
            if tag == "fp32" and name == "mLSTM":
                inputs.append((p, x.clone()))
            return y, st
        return block

    ctx = make_context(atp_topo(1, 1, 1), device_type="cpu")
    for tag, tree in (("fp32", lm.tree_map(lambda x: x.float(), params)),
                      ("bf16", params)):
        with chip_smoke.swapped(xlstm, mlstm_block=spy("mLSTM", tag),
                                slstm_block=spy("sLSTM", tag)), \
                torch.no_grad():
            lm.forward(ctx, cfg, tree, toks, torch.arange(SEQ)[None])
    print("2. the plain bf16 path against fp32, block by block (relative "
          "L2): the residual entering, the block's own update")
    for i, ((name, x32, y32), (_, x16, y16)) in enumerate(
            zip(seen["fp32"], seen["bf16"])):
        print(f"   block {i} ({name}): residual {rel(x16, x32):.3e}, update "
              f"{rel(y16 - x16, y32 - x32):.3e} (|update| / |residual| "
              f"{float((y32 - x32).norm() / x32.norm()):.2f})")
    return inputs


def stages(cfg, p, x):
    """One mLSTM block's stages in fp32, as ``xlstm.mlstm_block`` runs them
    on one device."""
    _, nh, dk, dv = xlstm.mlstm_dims(cfg)
    ctx = make_context(atp_topo(1, 1, 1), device_type="cpu")
    h_in = L.rms_norm(ctx, x, p["ln"], cfg.norm_eps)
    u, z = (h_in @ p["w_uz"]).chunk(2, dim=-1)
    v = F.silu(causal_conv(u, p["conv"], None)[0]).unflatten(-1, (nh, dv))
    qk = h_in @ p["w_qk"]
    q = qk[..., :nh * dk].unflatten(-1, (nh, dk))
    k = qk[..., nh * dk:].unflatten(-1, (nh, dk))
    g = h_in @ p["w_if"] + p["b_if"]
    li, lf = F.logsigmoid(g[..., :nh]), F.logsigmoid(g[..., nh:])
    y, _ = xlstm.mlstm_chunked(q, k, v, li, lf, cfg.ssm.chunk)
    normed = (y * torch.rsqrt(y.pow(2).mean(-1, keepdim=True) + 1e-6)
              * p["gn"].reshape(nh, dv))
    out = (normed * F.silu(z.unflatten(-1, (nh, dv)))).flatten(-2) \
        @ p["w_down"]
    return {"h_in": h_in, "v": v, "q": q, "k": k, "gates": g,
            "q.k i": (q * k).sum(-1) / math.sqrt(dk) * li.exp(), "y": y,
            "group-normed y": normed, "update": out}


def gain(cfg, inputs):
    """Part 3."""
    gen = torch.Generator().manual_seed(1)
    eps = 1e-3
    print(f"3. an mLSTM block's input moved by a relative {eps:g} (fp32): "
          f"each stage's relative move / {eps:g}")
    with torch.no_grad():
        for i in (0, 3, 6):
            p, x = inputs[i]
            e = torch.randn(x.shape, generator=gen)
            a = stages(cfg, p, x)
            b = stages(cfg, p, x + eps * e * x.norm() / e.norm())
            print(f"   mLSTM {i}: " + ", ".join(
                f"{k} {rel(b[k], a[k]) / eps:.2f}" for k in a))
            size = a["y"].pow(2).mean(-1).sqrt()
            move = (b["group-normed y"] - a["group-normed y"]).pow(2).mean(-1)
            low = size <= size.flatten().quantile(0.1)
            print(f"      the tenth of (position, head) rows with the "
                  f"smallest readout: {float(move[low].sum() / move.sum()):.0%}"
                  f" of the group-normed move; median |q.k i| "
                  f"{float(a['q.k i'].abs()[low].median()):.3f} there, "
                  f"{float(a['q.k i'].abs()[~low].median()):.3f} elsewhere")


def faults(cfg, params):
    """Part 4."""
    pcfg, calls = chip_smoke.path_calls(cfg, SEED, 2)
    fp32 = chip_smoke.run_path(torch, cfg, lm.tree_map(lambda t: t.float(),
                                                       params),
                               pcfg, calls, "cpu", torch.float32)
    plain = chip_smoke.run_path(torch, cfg, params, pcfg, calls, "cpu")
    base = chip_smoke.compare_logits(calls, plain[0], fp32[0])["frob"]

    def pools(got):
        return {n: rel(got[1][n], fp32[1][n]) for n in fp32[1]}

    base_pools = pools(plain)
    print("4. path-check-xlstm's calls (plain bf16 against fp32): logits "
          + ", ".join(f"{x:.3e}" for x in base) + "; state rows "
          + ", ".join(f"{n} {e:.2e}" for n, e in base_pools.items()
                      if "layer 0" in n))

    def gates(shift):
        @chip_smoke.contextlib.contextmanager
        def fault():
            scan, tick = xlstm.mlstm_chunked, xlstm.mlstm_step
            with chip_smoke.swapped(
                    xlstm, mlstm_chunked=lambda q, k, v, li, lf, c, state=None:
                    scan(q, k, v, li + shift, lf, c, state),
                    mlstm_step=lambda q, k, v, li, lf, state:
                    tick(q, k, v, li + shift, lf, state)):
                yield
        return fault

    for name, fault in (("input gates x e^0.1", gates(0.1)),
                        ("input gates x e^0.02 (the planted fault)",
                         chip_smoke.raised_input_gates)):
        with fault():
            got = chip_smoke.run_path(torch, cfg, params, pcfg, calls, "cpu")
        logit = chip_smoke.compare_logits(calls, got[0], fp32[0])["frob"]
        moved = {n: e / base_pools[n] for n, e in pools(got).items()}
        top = sorted(moved, key=moved.get, reverse=True)[:3]
        print(f"   {name}: logits " + ", ".join(
            f"{g / b:.2f}x" for g, b in zip(logit, base))
            + " the plain error; state rows most moved "
            + ", ".join(f"{n} {moved[n]:.1f}x" for n in top))


def main():
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cfg = cut_depth(get_config("xlstm-1.3b"), LAYERS)
    params = lm.shard_params(cfg, lm.init_params(cfg, seed=SEED,
                                                 device="cpu"),
                             lm.layout_context(atp_topo(1, 1, 1), 0))
    toks = torch.randint(0, cfg.vocab_size, (1, SEQ),
                         generator=torch.Generator().manual_seed(0))
    witness(cfg, params, toks)
    inputs = growth(cfg, params, toks)
    gain(cfg, inputs)
    faults(cfg, params)


if __name__ == "__main__":
    main()
