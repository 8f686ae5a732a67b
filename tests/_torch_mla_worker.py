"""One rank of the CPU gloo meshes that ``test_torch_mla.py`` starts.

    python tests/_torch_mla_worker.py RANK CASE_DIR

Reads ``case.json`` from CASE_DIR (the mesh, the paged geometry and the
number of paged calls), the reduced deepseek-v3's global weights
``params.npz``, the global batch ``batch.npz``, layer 0's MLA input
``block.npz`` and the paged calls ``calls.npz``, and joins the gloo group
through a file store there.  On this rank's shard:
  - ``mla_block`` of layer 0 on this rank's feature shard of the input, in
    both branches (cache-free, and absorbed over a zeroed contiguous latent
    cache);
  - the loss (aux and MTP terms in) and every gradient;
  - the paged calls through ``lm.paged_step``: local logits and greedy
    picks, and the local logits through int8 latent pools;
  - the MTP head's draft logits on the first call's hidden;
  - the wave's steps over contiguous latent caches, fed ``wave.npz``'s
    tokens;
  - three plain AdamW steps on ``steps.npz``'s batches: the losses and
    the parameters after the last;
  - the loss's forward once more on the port's own seeded bf16 weights
    under ``analysis.signature.recording("fwd")``, its record by key.
Writes ``rank{RANK}.npz`` and ``rank{RANK}.json``.  Imports only torch,
numpy and the port.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.analysis import signature
from repro_torch.configs.registry import get_config
from repro_torch.core.atp import make_context
from repro_torch.core.mesh import atp_topo
from repro_torch.launch.steps import _greedy_pick, build_train_step
from repro_torch.models import lm, mla
from repro_torch.models.paging import PagedConfig
from repro_torch.optim import adamw

from _torch_train_worker import flatten, unflatten


def main(rank: int, case_dir: Path) -> None:
    torch.set_num_threads(1)
    spec = json.loads((case_dir / "case.json").read_text())
    topo = atp_topo(*spec["mesh"])
    dist.init_process_group("gloo", init_method=f"file://{case_dir}/store",
                            rank=rank, world_size=topo.size)
    cfg = get_config("deepseek-v3-671b").reduced()
    m = cfg.mla
    ctx = make_context(topo, device_type="cpu")
    glob = unflatten(np.load(case_dir / "params.npz"))
    params = convert.params_from_jax(cfg, glob, topo, rank)
    out, meta = {}, {}

    blk = np.load(case_dir / "block.npz")
    x = torch.from_numpy(blk["x"])
    hl = x.shape[-1] // ctx.d2
    x = x[..., ctx.index2() * hl:(ctx.index2() + 1) * hl].contiguous()
    pos = torch.from_numpy(blk["pos"])
    p0 = lm.tree_map(lambda t: t[0], params["seg0"]["mla"])
    with torch.no_grad():
        out["blk_cache_free"] = mla.mla_block(ctx, cfg, p0, x, pos).numpy()
        cache = {"ckv": torch.zeros(x.shape[0], 8, m.kv_lora_rank),
                 "krope": torch.zeros(x.shape[0], 8, m.qk_rope_head_dim),
                 "len": torch.zeros((), dtype=torch.int32)}
        out["blk_absorbed"] = mla.mla_block(ctx, cfg, p0, x, pos,
                                            cache).numpy()

    batch = {k: torch.from_numpy(v)
             for k, v in np.load(case_dir / "batch.npz").items()}
    leaves = adamw.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = lm.train_loss(ctx, cfg, params, batch, remat=False)
    grads = torch.autograd.grad(loss, leaves)
    out["loss"] = loss.detach().numpy()
    out.update(flatten(adamw.tree_unflatten(params, iter(grads)), "grad/"))

    calls = np.load(case_dir / "calls.npz")
    for page_dtype, prefix in (("bf16", ""), ("int8", "int8_")):
        caches = lm.init_paged_caches(
            cfg, ctx, PagedConfig(**spec["paged"], page_dtype=page_dtype),
            dtype=torch.float32, device="cpu")
        with torch.no_grad():
            for i in range(spec["calls"]):
                args = (torch.from_numpy(calls[f"{n}{i}"])
                        for n in ("tokens", "start", "table"))
                logits, caches = lm.paged_step(ctx, cfg, params, *args,
                                               caches)
                out[f"{prefix}logits{i}"] = logits.numpy()
                if not prefix:
                    out[f"pick{i}"] = _greedy_pick(ctx, cfg, logits).numpy()

    # the MTP head as the draft proposer on call 0's hidden
    caches = lm.init_paged_caches(cfg, ctx, PagedConfig(**spec["paged"]),
                                  dtype=torch.float32, device="cpu")
    tok, start, table = (torch.from_numpy(calls[f"{n}0"])
                         for n in ("tokens", "start", "table"))
    with torch.no_grad():
        _, h, _ = lm.paged_step(ctx, cfg, params, tok, start, table, caches,
                                with_hidden=True)
        out["draft"] = lm.mtp_draft_logits(
            ctx, cfg, params, h, lm.step_positions(tok, start),
            torch.tensor(spec["mtp_next"], dtype=torch.int32)).numpy()

    # the wave's contiguous latent caches, fed the reference's tokens
    wave, w = np.load(case_dir / "wave.npz"), spec["wave"]
    caches = lm.init_decode_caches(cfg, ctx, w["b"], w["s_max"],
                                   dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for i, pos in enumerate(spec["wave_pos"]):
            logits, caches = lm.decode_step(
                ctx, cfg, params, torch.from_numpy(wave[f"tokens{i}"]),
                torch.tensor(pos, dtype=torch.int32), caches)
            out[f"wave{i}"] = logits.numpy()

    # three plain AdamW steps from the same weights
    step, info = build_train_step(cfg, topo, adamw.AdamWConfig(
        mode="plain", **spec["opt"]), remat=False, device="cpu")
    tp = convert.params_from_jax(cfg, glob, topo, rank)
    state = adamw.init_opt_state(tp, info.ctx, "plain")
    batches, losses = np.load(case_dir / "steps.npz"), []
    for n in range(spec["steps"]):
        tp, state, m = step(tp, state, {
            k: torch.from_numpy(batches[f"{k}{n}"]) for k in ("tokens",
                                                             "labels")})
        losses.append(float(m["loss"]))
    out["step_losses"] = np.asarray(losses)
    out.update(flatten(tp, "param/"))

    own = lm.shard_params(cfg, lm.init_params(cfg, seed=0, device="cpu"),
                          lm.layout_context(topo, rank))
    with signature.recording("fwd") as rec, torch.no_grad():
        lm.train_loss(ctx, cfg, own, batch, remat=False)
    meta["fwd"] = [[*k[:2], list(k[2]), k[3], *v]
                   for k, v in sorted(rec.by_key("fwd").items())]
    np.savez(case_dir / f"rank{rank}.npz", **out)
    (case_dir / f"rank{rank}.json").write_text(json.dumps(meta))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), Path(sys.argv[2]))
