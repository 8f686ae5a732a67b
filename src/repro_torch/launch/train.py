"""Training launcher (counterpart of ``repro.launch.train``, its
non-elastic loop): a dense, MoE, MLA or zamba/mamba model, random weights
from a seed, batches from ``data.pipeline``, ``build_train_step`` and AdamW.
The paper's GPT models (``--arch gpt-m1`` .. ``gpt-m4``) train at their
own 4 layers unless ``--layers`` cuts them.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --layers 4 --seq 2048 --batch 1 --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
        --layers 14 --seq 2048 --batch 1 --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-m2 \\
        --seq 2048 --batch 1 --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-v3-671b --layers 2 --seq 2048 --batch 1 --steps 5

runs on CUDA unless ``--device cpu`` is given, and prints the loss, the
global grad norm and the wall time of each step.  The batches come from a
synthetic token stream, or with ``--corpus FILE`` from a flat file of
uint16 tokens (read as a memmap).  A mesh of more than one
rank runs one process per rank under ``torch.distributed.run``, e.g.
``python -m torch.distributed.run --nproc-per-node 4 -m
repro_torch.launch.train --d1 2 --d2 2``.

``--ckpt-dir DIR`` trains through the fault-tolerant ``runtime.trainer.
Trainer`` (:func:`make_elastic_trainer`): a checkpoint every
``--ckpt-every`` steps in the JAX package's layout (global ``.npy`` leaves,
``meta.json``, ``COMMITTED``; the last ``--keep-ckpts`` kept), a resume
from the last one at start, and recovery from a failed step:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-m1 \
        --seq 2048 --batch 1 --steps 8 --ckpt-dir ckpt --ckpt-every 4

The strategy is a ``ParallelPlan`` end to end: ``--auto-atp`` searches one
(paper §3.5 with the overlap knobs; ``--no-overlap`` keeps to the seed
Eq. 2 space) on the ``--topology`` preset (default ``h100-sxm-8``) for
TP degree d1 * d2, ``--plan FILE`` loads a saved one, and plain
``--d1/--d2/--chunks`` make one with provenance ``manual-cli``; ``--save-plan
FILE`` writes the plan the run executes.  A plan with ``pods`` (two
data-parallel axes, pod and data) trains through ``--plan``; like the
reference's, the launcher has no ``--pods`` of its own.  ``--opt-mode``
takes plain, zero1 (the default) or compressed:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-m2 \
        --seq 2048 --batch 1 --auto-atp --save-plan plan.json
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-m2 \
        --seq 2048 --batch 1 --plan plan.json

``--calibrate`` (with ``--auto-atp``) measures (B1, B2), alpha_s, the
chunk and launch costs and the quantized bandwidths of every (d1, d2)
that fits the ranks of the run (``core.calibrate.calibrate_mesh``) before
the search; factorizations that do not fit keep the analytic model, so in
one process (``--calibrate`` on one card or on the CPU) the search gives
the analytic plan:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-m2 \
        --seq 2048 --batch 1 --auto-atp --calibrate
    python -m torch.distributed.run --nproc-per-node 8 -m \
        repro_torch.launch.train --arch gpt-m2 --d1 2 --d2 4 --auto-atp \
        --calibrate
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import cut_depth
from repro_torch.configs.registry import get_config
from repro_torch.core import comm_matrix
from repro_torch.core.calibrate import calibrate_mesh, recalibrate_surviving
from repro_torch.core.cost_model import LayerCommProfile
from repro_torch.core.mesh import resolve_device
from repro_torch.core.plan import (ParallelPlan, PlanSearchResult, plan_search,
                                   replan_elastic)
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.launch.steps import build_train_step
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime.membership import SingleObserverMembership
from repro_torch.runtime.trainer import Trainer, TrainerConfig

log = logging.getLogger("repro_torch.train")

#: the comm-matrix presets of the port's own card, and its dense bf16 peak
#: (TFLOP/s; the NVIDIA H100 SXM datasheet) that ``pick_plan`` prices their
#: GEMM time with.  Every other preset keeps ``plan_search``'s default, so
#: its plans stay equal to the reference's.
H100_PRESETS = frozenset({"h100-sxm-8", "h100-sxm-2x8"})
H100_PEAK_TFLOPS = 989.0


def comm_profile(cfg) -> LayerCommProfile:
    """Generalized Eq. 2 coefficients for this architecture's dense block
    (the per-kind constructor in the cost model)."""
    return LayerCommProfile.dense(cfg)


def pick_plan(cfg, tp: int, seq: int, batch: int,
              topology: str = "h100-sxm-8", dp: int = 1,
              calibrate: bool = False,
              overlap: bool = True) -> PlanSearchResult:
    """Search the plan space for this workload (``repro.launch.train.
    pick_plan``).

    The default is the per-segment search (``plan_search(model=cfg)``):
    each model segment gets its own (chunks, seq_parallel) against its
    per-kind comm profile over the shared mesh.  ``overlap=False`` keeps to
    the seed Eq. 2 space.  ``calibrate`` measures the process group the
    caller runs in first (``calibrate_mesh``; every rank must call this):
    the factorizations of ``tp`` that fit its ranks get measured entries,
    the others, and every one in a single process, keep the analytic
    model."""
    calib = None
    if calibrate:
        calib = calibrate_mesh(tp, comm_matrix.PRESETS[topology]())
        log.info("on-mesh calibration (%d factorizations): %s", len(calib),
                 calib.source)
    peak = ({"peak_tflops": H100_PEAK_TFLOPS} if topology in H100_PRESETS
            else {})
    if not overlap:
        return plan_search(topology, tp, layers=cfg.num_layers, batch=batch,
                           seq=seq, profile=comm_profile(cfg), dp=dp,
                           calibration=calib, chunks_options=(1,),
                           seq_parallel_options=(False,),
                           algo="rabenseifner", alpha_s=0.0, **peak)
    return plan_search(topology, tp, model=cfg, batch=batch, seq=seq,
                       dp=dp, calibration=calib, **peak)


@dataclasses.dataclass(frozen=True)
class Rank:
    """One process of the job as the membership layer sees it (its
    "device"): ``id`` is the rank it had when the job started."""
    id: int


def job_ranks() -> list[Rank]:
    """Every rank of the running job (one, outside ``torch.distributed``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return [Rank(r) for r in range(world)]


class Departed(SystemExit):
    """Raised on a rank that the job's committed view no longer holds (or
    that the re-planned mesh does not use): it has left the run.  Exit code
    0, so an entry point that does not catch it ends cleanly."""

    def __init__(self, why: str):
        super().__init__(0)
        self.why = why


def file_store_regroup(store_dir: str, backend: str = "gloo"):
    """The ``regroup`` of :func:`make_elastic_trainer` for ranks joined
    through a file store: the old default group is destroyed and the
    survivors join a new one of ``world`` ranks on a new store file named
    by ``tag`` (the committed view's epoch)."""
    def regroup(tag: str, rank: int, world: int) -> None:
        dist.destroy_process_group()
        dist.init_process_group(
            backend, init_method=f"file://{store_dir}/store_{tag}",
            rank=rank, world_size=world)

    return regroup


def _moments(m, v):
    """One tree with ``{"m", "v"}`` at each leaf of two like trees."""
    if isinstance(m, dict):
        return {k: _moments(m[k], v[k]) for k in m}
    return {"m": m, "v": v}


def _moment(tree, which: str):
    """The ``which`` ("m" or "v") tree of a tree of ``{"m", "v"}`` leaves."""
    if set(tree) == {"m", "v"} and not isinstance(tree["m"], dict):
        return tree[which]
    return {k: _moment(v, which) for k, v in tree.items()}


def make_elastic_trainer(cfg, plan: ParallelPlan, opt_cfg, trainer_cfg,
                         source, *, batch: int, seq: int, membership=None,
                         recalibrate: bool = True,
                         measure=None, recalib_deadline_s: float | None = None,
                         device=None, init_params=None, seed: int = 0,
                         regroup=None):
    """Plan -> step -> fault-tolerant :class:`Trainer`, elastic end to end
    (``repro.launch.train.make_elastic_trainer``).  Every rank of the job
    calls this and runs its own Trainer; they take the same path.

    Checkpoints are the JAX package's tree ``(params, canonical_opt)``:
    the global parameters under its keys, each leaf at its own dtype, and
    the optimizer state in plain's param-shaped layout (``{"leaves": {...:
    {"m", "v"}}, "step": int32}``, plus ``"err"`` in compressed mode), so
    a checkpoint written by either package restores in the other and onto
    any plan.  Saving gathers every rank's shards on the writer, rank 0
    (zero1's banked moments first unbanked over dp); restoring reads the
    global arrays on every rank and cuts its shard.

    Recovery from a failed step (``replan_step``): the membership layer's
    converged view says which ranks survived (``membership``: a
    ``runtime.membership.MembershipRuntime`` over a fabric whose devices
    are :class:`Rank` objects, every rank running the same deterministic
    simulation, so every rank reaches the same view without messages;
    default a single observer of :func:`job_ranks`).  On an
    intact mesh the live step is kept.  After a shrink, a rank outside the
    view raises :class:`Departed`; the survivors ``regroup(tag, rank,
    world)`` (their new rank their index in the view: see
    :func:`file_store_regroup`), recalibrate on the new group
    (``recalibrate_surviving``, ``measure`` injectable, under
    ``recalib_deadline_s``), re-plan (``replan_elastic``; the plan of new
    rank 0, on the view's elected planner host, is the one every rank
    takes), and build the step anew: its ATP groups are made on the new
    default group.  Ranks that the new plan leaves unused depart too.

    ``init_params()`` gives the GLOBAL tree in the JAX package's layout
    (numpy, or torch tensors; default the port's ``lm.init_params(cfg,
    seed)`` on ``device``).  Runs on CUDA unless ``device`` names another
    device.  Returns ``(trainer, live)``: ``live`` the holder the closures
    read (plan, step, info, ctx, the mesh's ranks, this process's rank)."""
    if membership is None:
        membership = SingleObserverMembership(job_ranks)
    device = resolve_device(device)
    me = dist.get_rank() if dist.is_initialized() else 0
    devs = membership.devices()
    if plan.devices > len(devs):
        raise ValueError(f"need {plan.devices} ranks, have {len(devs)}")
    step_fn, info = build_train_step(cfg, opt_cfg=opt_cfg, device=device,
                                     plan=plan)
    live = {"plan": plan, "step": step_fn, "info": info, "ctx": info.ctx,
            "ranks": [d.id for d in devs[:plan.devices]], "rank": me}
    if init_params is None:
        def init_params():
            return lm.init_params(cfg, seed=seed, device=device)

    def layout():
        return lm.layout_context(live["plan"].topo(), live["rank"])

    def to_device(tree):
        return lm.tree_map(lambda t: t.to(device), tree)

    def cut(tree):
        """This rank's shard of a global tree (numpy or torch)."""
        tree = lm.tree_map(lambda a: a if isinstance(a, torch.Tensor)
                           else convert.to_torch(a), tree)
        return to_device(lm.shard_params(cfg, tree, layout()))

    def init_state():
        params = cut(init_params())
        return params, adamw.init_opt_state(params, live["ctx"],
                                            opt_cfg.mode)

    def put_batch(host_batch):
        ctx = live["ctx"]
        per = batch // ctx.dp
        rows = slice(ctx.dp_index() * per, (ctx.dp_index() + 1) * per)
        return {k: torch.as_tensor(v[rows], device=device)
                for k, v in host_batch.items()}

    def writer() -> bool:
        return not dist.is_initialized() or dist.get_rank() == 0

    def agree(failed: bool) -> bool:
        if not dist.is_initialized():
            return failed
        dev = device if dist.get_backend() == "nccl" else "cpu"
        flag = torch.tensor([int(failed)], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def encode_ckpt(params, opt_state):
        """The checkpoint tree on the writer (None on the other ranks):
        every rank's shards gathered and reassembled into global arrays."""
        canon = adamw.unbank_opt_state(params, opt_state, live["ctx"],
                                       opt_cfg.mode)
        host = lm.tree_map(lambda t: t.detach().cpu(), {
            "params": params,
            "m": _moment(canon["leaves"], "m"),
            "v": _moment(canon["leaves"], "v"),
            **({"err": canon["err"]} if "err" in canon else {})})
        parts = [host]
        if dist.is_initialized() and dist.get_world_size() > 1:
            parts = [None] * dist.get_world_size() if writer() else None
            dist.gather_object(host, parts, dst=0)
        if not writer():
            return None
        topo = live["plan"].topo()

        def whole(key):
            return convert.params_to_numpy(cfg, [p[key] for p in parts],
                                           topo, as_torch=True)

        out = {"leaves": _moments(whole("m"), whole("v")),
               "step": np.array(opt_state["step"], np.int32)}
        if "err" in host:
            out["err"] = whole("err")
        return whole("params"), out

    def decode_ckpt(tree):
        params, canon = tree
        params = cut(params)
        opt = {"step": int(canon["step"]),
               "leaves": _moments(cut(_moment(canon["leaves"], "m")),
                                  cut(_moment(canon["leaves"], "v")))}
        if "err" in canon:
            opt["err"] = cut(canon["err"])
        return params, adamw.rebank_opt_state(params, opt, live["ctx"],
                                              opt_cfg.mode)

    def ckpt_template():
        """Shapes and dtypes of the checkpoint tree from the config's
        global shapes: nothing is materialized."""
        meta = lm.init_params(cfg, device="meta")

        def spec(dtype):
            return lambda t: ckpt.LeafSpec(tuple(t.shape), dtype or t.dtype)

        canon = {"leaves": lm.tree_map(
                     lambda t: {"m": spec(torch.float32)(t),
                                "v": spec(torch.float32)(t)}, meta),
                 "step": ckpt.LeafSpec((), torch.int32)}
        if opt_cfg.mode == "compressed":
            canon["err"] = lm.tree_map(spec(torch.float32), meta)
        return lm.tree_map(spec(None), meta), canon

    def leave(why: str):
        log.info("rank %d leaves the run: %s", me, why)
        if dist.is_initialized():
            dist.destroy_process_group()
        raise Departed(why)

    def regroup_as(tag: str, rank: int, world: int) -> None:
        if regroup is None:
            raise RuntimeError("a shrink across processes needs regroup= "
                               "(e.g. file_store_regroup)")
        regroup(tag, rank, world)

    def replan_step():
        """Elastic restart: re-plan only if the pool changed.  A transient
        fault on an intact mesh keeps the plan the user saved; "intact" is
        membership, not a head count."""
        view = membership.converged_view()
        alive = [d.id for d in membership.devices(view)]
        if set(live["ranks"]) <= set(alive) and \
                len(alive) >= live["plan"].devices:
            return live["step"]
        if me not in alive:
            leave(f"epoch {view.epoch}: not in the committed view {alive}")
        new_rank = alive.index(me)
        if new_rank == 0 and not membership.is_planner(view):
            raise RuntimeError(
                f"epoch {view.epoch}: the first survivor is not on the "
                f"elected re-planner (view {view.alive}, planner "
                f"{view.planner})")
        log.info("membership epoch %d committed view %s: rank %d -> %d of "
                 "%d", view.epoch, view.alive, me, new_rank, len(alive))
        if dist.is_initialized():
            regroup_as(f"epoch{view.epoch}", new_rank, len(alive))
        live.update(rank=new_rank)
        old = live["plan"]
        if recalibrate:
            old = recalibrate_surviving(old, measure=measure,
                                        deadline_s=recalib_deadline_s,
                                        model=cfg, batch=batch, seq=seq)
            log.info("recalibrated on the surviving ranks: %d entries (%s)",
                     len(old.calibration), old.calibration.source)
        new_plan = replan_elastic(old, len(alive), model=cfg, batch=batch,
                                  seq=seq)
        if dist.is_initialized() and dist.get_world_size() > 1:
            box = [new_plan.to_dict()]
            dist.broadcast_object_list(box, src=0)
            new_plan = ParallelPlan.from_dict(box[0])
        log.info("elastic re-plan: %s -> %s", live["plan"].describe(),
                 new_plan.describe())
        if new_plan.devices < len(alive):
            if new_rank >= new_plan.devices:
                leave(f"the re-planned mesh uses {new_plan.devices} of "
                      f"{len(alive)} survivors")
            regroup_as(f"epoch{view.epoch}-plan", new_rank,
                       new_plan.devices)
        new_step, new_info = build_train_step(cfg, opt_cfg=opt_cfg,
                                              device=device, plan=new_plan)
        live.update(plan=new_plan, step=new_step, info=new_info,
                    ctx=new_info.ctx, ranks=alive[:new_plan.devices])
        return new_step

    trainer = Trainer(
        trainer_cfg, build_step=lambda: live["step"], source=source,
        init_state=init_state, put_batch=put_batch, replan=replan_step,
        encode_ckpt=encode_ckpt, decode_ckpt=decode_ckpt,
        ckpt_template=ckpt_template, writer=writer, agree=agree)
    return trainer, live


def _init_dist(device: torch.device) -> torch.device:
    """Join the ranks of a ``torch.distributed.run`` launch (NCCL on the
    card, gloo on the host), once; returns this rank's device."""
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device


def main(argv=None) -> list[dict]:
    """Run the loop; returns each step's metrics as floats (loss,
    grad_norm, lr, ms; with ``--ckpt-dir`` the Trainer's step, loss and
    ms of every committed step, a replayed step again)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--d1", type=int, default=1)
    ap.add_argument("--d2", type=int, default=1)
    ap.add_argument("--chunks", type=int, default=1)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (split over the dp ranks)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--opt-mode", default="zero1",
                    choices=("plain", "zero1", "compressed"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus", default=None,
                    help="a file of uint16 tokens to sample the batches "
                         "from (default: a synthetic stream)")
    ap.add_argument("--auto-atp", action="store_true",
                    help="search a ParallelPlan (paper §3.5 + overlap knobs)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="restrict --auto-atp to the seed Eq. 2 space")
    ap.add_argument("--calibrate", action="store_true",
                    help="measure (B1, B2) on the ranks of the run before "
                         "--auto-atp searches")
    ap.add_argument("--plan", default=None,
                    help="load a saved ParallelPlan JSON instead of searching")
    ap.add_argument("--save-plan", default=None,
                    help="write the executed plan JSON here")
    ap.add_argument("--topology", default="h100-sxm-8",
                    choices=list(comm_matrix.PRESETS),
                    help="comm-matrix preset for --auto-atp")
    ap.add_argument("--ckpt-dir", default=None,
                    help="train through the fault-tolerant Trainer, with "
                         "checkpoints here (default: the bare loop, nothing "
                         "written)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--keep-ckpts", type=int, default=3)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = cut_depth(cfg, args.layers)
    device = resolve_device(args.device)
    if args.calibrate and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        # the calibration measures the ranks of the run: join them first
        device = _init_dist(device)
    if args.plan:
        plan = ParallelPlan.load(args.plan)
        log.info("loaded plan %s: %s", args.plan, plan.describe())
    elif args.auto_atp:
        res = pick_plan(cfg, args.d1 * args.d2, args.seq, args.batch,
                        args.topology, dp=args.dp, calibrate=args.calibrate,
                        overlap=not args.no_overlap)
        plan = res.best
        log.info("ATP plan search on %s picked %s; top of the ranking: %s",
                 args.topology, plan.describe(),
                 [(c.d1, c.d2, c.chunks, c.seq_parallel,
                   round(c.t_exposed * 1e3, 2)) for c in res.costs[:4]])
    else:
        # manual knobs still make a plan: one artifact, one code path
        plan = ParallelPlan(d1=args.d1, d2=args.d2, dp=args.dp,
                            chunks=args.chunks,
                            provenance=(("searcher", "manual-cli"),))
    if args.save_plan:
        plan.save(args.save_plan)
        log.info("saved plan -> %s", args.save_plan)
    topo = plan.topo()
    rank = 0
    if topo.size > 1:
        device = _init_dist(device)
        rank = torch.distributed.get_rank()
    opt_cfg = adamw.AdamWConfig(lr=args.lr, mode=args.opt_mode,
                                total_steps=args.steps)
    if args.batch % (plan.dp * plan.pods):
        raise ValueError(f"--batch {args.batch} does not split over dp="
                         f"{plan.dp * plan.pods}")
    source = TokenSource(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                    seed=args.seed, corpus_path=args.corpus))
    if args.ckpt_dir:
        # the fault-tolerant loop: checkpoints in the JAX package's layout
        trainer, _ = make_elastic_trainer(
            cfg, plan, opt_cfg,
            TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every,
                          keep_ckpts=args.keep_ckpts),
            source, batch=args.batch, seq=args.seq, device=device,
            seed=args.seed)
        trainer.run()
        log.info("done: %d steps committed, %d failures recovered",
                 len(trainer.history), trainer.total_failures)
        return [{"step": h["step"], "loss": h["loss"], "ms": 1e3 * h["dt"]}
                for h in trainer.history]
    step, info = build_train_step(cfg, opt_cfg=opt_cfg, device=device,
                                  plan=plan)
    params = lm.shard_params(cfg, lm.init_params(cfg, seed=args.seed,
                                                 device=device),
                             lm.layout_context(topo, rank))
    opt_state = adamw.init_opt_state(params, info.ctx, opt_cfg.mode)
    ctx = info.ctx
    log.info("train %s: %d layers, d_model %d, vocab %d, mesh (dp, d1, d2) "
             "= (%d, %d, %d), batch %d x seq %d, %s on %s; plan %s", cfg.name,
             cfg.num_layers, cfg.d_model, cfg.vocab_size, ctx.dp, ctx.d1,
             ctx.d2, args.batch, args.seq, opt_cfg.mode, device,
             plan.describe())
    history = []
    for i in range(args.steps):
        host = source.host_batch(i, ctx.dp_index(), ctx.dp)
        batch = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # synchronises
        ms = 1e3 * (time.perf_counter() - t0)
        history.append({"loss": loss, "grad_norm": gnorm, "lr": m["lr"],
                        "ms": ms})
        log.info("step %d: loss %.4f grad norm %.4f lr %.3g, %.1f ms "
                 "(%.0f tokens/s)", i, loss, gnorm, m["lr"], ms,
                 args.batch * args.seq / (ms / 1e3))
    return history


if __name__ == "__main__":
    main()
