"""Language model: embedding -> block stack -> head, ATP-sharded
(counterpart of ``repro.models.lm``): paged serving and the training loss
(``forward`` with no caches, ``vocab_parallel_ce``, ``train_loss``) of the
dense, zamba and mamba segment kinds.

Parameters come in two forms.  ``init_params`` makes the GLOBAL tree with
the JAX package's keys (``seg0/attn/wq`` ... stacked ``[count, ...]``; a
zamba segment's Mamba2 leaves stacked ``[count, inner-1, ...]``) and
distributions; ``shard_params`` cuts one rank's shard out of it by the JAX
PartitionSpecs and fuses q/k/v, up/gate and the Mamba2 z/x per rank.  The
model functions take the sharded tree.  A Python loop over layers replaces
``lax.scan``.

Recurrent kinds (zamba, mamba) keep per-slot STATE POOLS beside the page
pools, addressed by a slot id per batch row: the SSD scan reads and writes
its pool rows in place; the small conv-state rows are gathered by slot id
and written back (``_state_take`` / ``_state_put``).  The step addresses
them through :func:`fixed_slot_map`, whose shapes do not depend on the
slot ids and which needs no host sync, so the step can be captured as a
CUDA graph; :func:`slot_map` is the host-synced form it replaced.

Each segment runs under its own view of the context,
``ctx.for_segment(kind)`` (a plan's per-segment chunks), as in the
reference; the embedding takes the first segment's view, and the final
norm and the head the context itself.  The collectives are attributed to
the reference's regions (``analysis.signature.region``): ``shell:embed``,
``seg{i}:{kind}``, ``shell:exit``, ``shell:head``, ``shell:loss`` (and
``shell:pick``, the serving step's greedy pick).  The
reference's ``shell:trans{i}`` regions issue collectives only between a
sequence-parallel segment and one that is not, and the sequence-parallel
spec is ROADMAP A8, so the port has none to open.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import torch

from repro_torch.analysis.signature import region
from repro_torch.configs.base import ModelConfig, segments
from repro_torch.core.atp import (ATPContext, all_gather, all_reduce_max,
                                  atp_boundary, conjugate, shard_slice)
from repro_torch.core.mesh import (MeshTopo, dp_axis_names, resolve_device,
                                   tp_axis_names)
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import mamba2, paging, transformer

_A10 = "segment kind {!r} is not ported yet (ROADMAP A10: other segment kinds)"

#: segment kinds the port serves
KINDS = frozenset({"dense", "zamba", "mamba"})
#: the served kinds with O(1)-per-slot recurrent state, pooled by slot id
RECURRENT_STATE_KINDS = frozenset({"mamba", "zamba"})


def _check_kinds(cfg: ModelConfig):
    for seg in segments(cfg):
        if seg.kind not in KINDS:
            raise NotImplementedError(_A10.format(seg.kind))
    if cfg.mtp:
        raise NotImplementedError("the MTP head is ROADMAP A9 (speculation)")


def is_recurrent(cfg: ModelConfig) -> bool:
    return any(s.kind in RECURRENT_STATE_KINDS for s in segments(cfg))


def _layer(tree, i: int):
    """Layer ``i`` of a layer-stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, dtype=None,
                device=None) -> dict:
    """Global parameters with the JAX ``lm.init_params`` keys, scales and
    distributions (normal * scale, norm scales 1, biases 0), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (CUDA unless
    named).  A torch generator does not draw the numbers jax.random draws:
    weights that must match the JAX package cross through
    ``convert.params_from_jax``."""
    _check_kinds(cfg)
    device = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    h = cfg.d_model
    p = {"embed": transformer._normal(gen, (cfg.vocab_size, h), 0.02, dtype,
                                      device),
         "final_norm": {k: v.to(device) for k, v in L.norm_params(cfg, h).items()}}
    if not cfg.tie_embeddings:
        p["lm_head"] = transformer._normal(gen, (h, cfg.vocab_size),
                                           1.0 / math.sqrt(h), dtype, device)

    def dense():
        return transformer.dense_block_params(gen, cfg, dtype, device)

    def mamba():
        return mamba2.mamba_params(gen, cfg, dtype, device)

    for i, seg in enumerate(segments(cfg)):
        if seg.kind == "dense":
            p[f"seg{i}"] = _stacked((seg.count,), dense)
        elif seg.kind == "zamba":
            p[f"seg{i}"] = {"mamba": _stacked((seg.count, seg.inner - 1), mamba)}
        else:
            p[f"seg{i}"] = _stacked((seg.count,), mamba)
    if any(s.kind == "zamba" for s in segments(cfg)):
        # two [h, h] in-projections of the shared block's (h, emb0) input
        s = 1.0 / math.sqrt(2 * h)
        p["shared_attn"] = {
            "w_in_h": transformer._normal(gen, (h, h), s, dtype, device),
            "w_in_e": transformer._normal(gen, (h, h), s, dtype, device),
            "block": dense()}
    return p


def _stacked(lead: tuple[int, ...], make) -> dict:
    """Blocks from ``make()`` stacked over the leading dims ``lead``, drawn
    one at a time into preallocated stacks: the fp32 draw of a single block
    is the only temporary."""
    stacked = None
    for idx in itertools.product(*map(range, lead)):
        blk = make()
        if stacked is None:
            stacked = tree_map(lambda t: t.new_empty(lead + t.shape), blk)
        _zip(lambda dst, src: dst[idx].copy_(src), stacked, blk)
    return stacked


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _zip(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _zip(fn, a[k], b[k])
    else:
        fn(a, b)


def shard_params(cfg: ModelConfig, params: dict, ctx: ATPContext) -> dict:
    """This rank's shard of the global tree (consumed: its leaves are
    popped as they are cut, so a full-size model never exists twice)."""
    _check_kinds(cfg)
    nspec = L.feat_spec(ctx)
    out = {"embed": L.cut(ctx, params.pop("embed"), L.embed_spec(ctx)),
           "final_norm": {k: L.cut(ctx, v, nspec)
                          for k, v in params.pop("final_norm").items()}}
    if not cfg.tie_embeddings:
        out["lm_head"] = L.cut(ctx, params.pop("lm_head"), L.head_spec(ctx))
    for i, seg in enumerate(segments(cfg)):
        sp = params.pop(f"seg{i}")
        if seg.kind == "dense":
            out[f"seg{i}"] = transformer.shard_dense_block(ctx, cfg, sp)
        elif seg.kind == "zamba":  # [count, inner-1, ...]: two stacked dims
            out[f"seg{i}"] = {"mamba": mamba2.shard_mamba(ctx, sp["mamba"], 2)}
        else:
            out[f"seg{i}"] = mamba2.shard_mamba(ctx, sp, 1)
    if "shared_attn" in params:
        sa = params.pop("shared_attn")
        col = L.col_w_spec(ctx)
        out["shared_attn"] = {
            "w_in_h": L.cut(ctx, sa.pop("w_in_h"), col),
            "w_in_e": L.cut(ctx, sa.pop("w_in_e"), col),
            "block": transformer.shard_dense_block(ctx, cfg, sa.pop("block"),
                                                   lead=0)}
    return out


def layout_context(topo: MeshTopo, rank: int) -> ATPContext:
    """A context that knows ``rank``'s mesh coordinates but holds no process
    group: enough to cut shards (``shard_params``) outside a running job."""
    ax1, ax2 = tp_axis_names(topo)
    return ATPContext(topo=topo, ax1=ax1, ax2=ax2, dp_axes=dp_axis_names(topo),
                      coords=topo.coords(rank))


# ---------------------------------------------------------------------------
# Paged caches.
# ---------------------------------------------------------------------------


def init_paged_caches(cfg: ModelConfig, ctx: ATPContext,
                      pcfg: paging.PagedConfig, dtype=None, device=None,
                      slots: int | None = None):
    """This rank's caches per segment, on ``device`` (CUDA unless named).

    Attention (dense segments and each zamba super-block's shared-block
    application): block-paged k/v pools ``{"k": [count, np, pg, kv_count,
    hd], "v": ...}`` — the bank dim of the JAX pools' ``[count, np, pg,
    tp*kv_count, hd]`` cut to this rank.  Recurrent kinds: per-slot state
    pools with ``slots`` rows (the scheduler's ``batch_slots``; required
    for them), ``conv_x [.., slots, k-1, d_inner/n]`` and ``conv_bc [..,
    slots, k-1, 2 ds]`` in ``dtype`` and ``ssd [.., slots, nh/n, hd, ds]``
    in fp32; a zamba segment nests them as ``{"attn": ..., "mamba": ...}``
    with the Mamba2 pools stacked ``[count, inner-1, ...]``.  ``dtype``
    defaults to the model's.  bf16 page pools only: the int8/fp8 pools are
    ROADMAP A9."""
    _check_kinds(cfg)
    device = resolve_device(device)
    if pcfg.page_dtype != "bf16":
        raise NotImplementedError(
            f"page_dtype={pcfg.page_dtype!r}: quantized page pools are "
            f"ROADMAP A9")
    if slots is None and is_recurrent(cfg):
        raise ValueError(
            "paged serving of recurrent kinds (mamba/zamba) needs "
            "slots=<scheduler batch_slots> to size the per-slot state pools")
    dtype = dtype or getattr(torch, cfg.dtype)
    plan = L.make_attn_plan(ctx, cfg.num_heads, cfg.num_kv_heads)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def attn_pool(count):
        shape = (count, pcfg.num_pages, pcfg.page_size, plan.kv_count, cfg.hd)
        return {"k": zeros(shape), "v": zeros(shape)}

    def mamba_state(lead):
        d_inner, nheads = mamba2.mamba_dims(cfg)
        sc, n = cfg.ssm, ctx.tp
        lead = lead + (slots,)
        return {"conv_x": zeros(lead + (sc.conv_kernel - 1, d_inner // n)),
                "conv_bc": zeros(lead + (sc.conv_kernel - 1, 2 * sc.d_state)),
                "ssd": zeros(lead + (nheads // n, sc.head_dim, sc.d_state),
                             torch.float32)}

    caches = {}
    for i, seg in enumerate(segments(cfg)):
        if seg.kind == "dense":
            caches[f"seg{i}"] = attn_pool(seg.count)
        elif seg.kind == "zamba":
            caches[f"seg{i}"] = {"attn": attn_pool(seg.count),
                                 "mamba": mamba_state((seg.count, seg.inner - 1))}
        else:
            caches[f"seg{i}"] = mamba_state((seg.count,))
    return caches


@dataclasses.dataclass(frozen=True)
class SlotMap:
    """How one step's batch rows address the state pools (on the device).
    Made once per step by :func:`fixed_slot_map` (``src`` and ``hit`` set,
    no ``put``) or by the host-synced :func:`slot_map` (``put`` set)."""

    slot: torch.Tensor          # int32 slot id per batch row, sentinel kept
    take: torch.Tensor          # pool row each batch row reads (clamped)
    fresh: torch.Tensor         # rows whose fed window starts at position 0
    rows: torch.Tensor | None   # batch rows that write back (None: all)
    put: torch.Tensor | None    # the pool rows they write
    src: torch.Tensor | None = None   # [slots] batch row each pool row takes
    hit: torch.Tensor | None = None   # [slots] whether a batch row writes it


def fixed_slot_map(slot: torch.Tensor, start: torch.Tensor,
                   slots: int) -> SlotMap:
    """:func:`slot_map` with no host sync and no shape that depends on the
    ids: a one-hot match of ``slot [b]`` against ``0 .. slots-1`` picks,
    for each pool row, the batch row that writes it (``src``) and whether
    one does (``hit``); the sentinel ``slots`` matches no pool row.  Live
    ids must be distinct, which the host checks where they are made
    (``launch.steps.check_slot_ids``)."""
    sid = slot.long()
    b = sid.shape[0]
    match = sid[None, :] == torch.arange(slots, device=slot.device)[:, None]
    src = (match.long() * torch.arange(b, device=slot.device)[None, :]).sum(1)
    return SlotMap(slot=slot.to(torch.int32), take=sid.clamp(0, slots - 1),
                   fresh=start == 0, rows=None, put=None, src=src,
                   hit=match.any(1))


def slot_map(slot: torch.Tensor, start: torch.Tensor, slots: int) -> SlotMap:
    """Slot ids ``slot [b]`` (the sentinel ``slots`` marks a row whose state
    must not change) and ``start [b]``.  JAX's scatter drops an
    out-of-range id where torch indexing raises, so the sentinel rows are
    filtered here, once per step (one host sync, before any layer runs);
    a live id that appears twice raises (two rows would write one pool
    row)."""
    ids = slot.tolist()
    live = [i for i, s in enumerate(ids) if s < slots]
    if len({ids[i] for i in live}) != len(live):
        raise ValueError(f"a live slot id appears twice: {ids}")
    sid = slot.long()
    if len(live) == len(ids):
        rows, put = None, sid
    else:
        rows = torch.tensor(live, dtype=torch.long, device=slot.device)
        put = sid.index_select(0, rows)
    return SlotMap(slot=slot.to(torch.int32), take=sid.clamp(0, slots - 1),
                   fresh=start == 0, rows=rows, put=put)


def _state_take(pool: dict, sm: SlotMap) -> dict:
    """Gather this step's state rows ``[b, ...]`` from one layer's pools
    ``[slots, ...]``.  A sentinel row reads row ``slots - 1`` (harmless: its
    write is dropped).  A row with ``start == 0`` is a new request in a
    possibly recycled slot and reads zeros: unlike the page table, which
    is remapped at admission, recurrent state has no per-token addressing
    to hide the previous occupant behind."""
    def take(a):
        r = a.index_select(0, sm.take)
        return r.masked_fill_(sm.fresh.view((-1,) + (1,) * (r.dim() - 1)), 0)

    return {k: take(v) for k, v in pool.items()}


def _state_put(pool: dict, rows: dict, sm: SlotMap) -> None:
    """Write the updated state rows back into the pools IN PLACE (the pools
    are views of the step's cache tensors); sentinel rows are dropped.
    From a :func:`fixed_slot_map` every pool row is rewritten, with its
    own value where no batch row writes it."""
    for k, a in pool.items():
        if sm.put is None:
            new = rows[k].index_select(0, sm.src).to(a.dtype)
            a.copy_(torch.where(sm.hit.view((-1,) + (1,) * (a.dim() - 1)),
                                new, a))
            continue
        r = rows[k] if sm.rows is None else rows[k].index_select(0, sm.rows)
        a.index_copy_(0, sm.put, r.to(a.dtype))


# ---------------------------------------------------------------------------
# Embedding / head (vocab-parallel over ax1, feature over ax2).
# ---------------------------------------------------------------------------


def embed_tokens(ctx: ATPContext, cfg: ModelConfig, emb, tokens):
    """emb local [V/d1, h/d2]; tokens [b, s] -> x [b, s, h/d2]."""
    v_loc = emb.shape[0]
    rel = tokens.long() - ctx.index1() * v_loc
    ok = (rel >= 0) & (rel < v_loc)
    x = emb[rel.clamp(0, v_loc - 1)] * ok[..., None].to(emb.dtype)
    x = atp_boundary(ctx, x, ctx.ax1)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def lm_logits(ctx: ATPContext, cfg: ModelConfig, params, x):
    """x [b, s, h/d2] -> logits [b, s, V/d1] (ax2-replicated).  A tied head
    reads the embedding transposed, without a copy.  A column-first GEMM:
    x's conjugate sums its gradient over ax1."""
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    x = conjugate(ctx, x, ctx.ax1)
    logits = atp_boundary(ctx, ops.matmul(x, w), ctx.ax2)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def vocab_parallel_ce(ctx: ATPContext, logits, labels, ignore: int = -1):
    """logits [b, s, V/d1] local; labels [b, s] global ids.  Per-token loss
    [b, s] in fp32, the same on every TP rank: the max over tp1 (no
    gradient), then the sum of exponentials and the picked logit each
    through the ax1 boundary; 0 where ``labels == ignore``."""
    lf = logits.float()
    v_loc = lf.shape[-1]
    zmax = all_reduce_max(ctx, lf.detach().amax(-1), ctx.ax1)
    sumexp = atp_boundary(ctx, torch.exp(lf - zmax[..., None]).sum(-1),
                          ctx.ax1)
    lse = torch.log(sumexp) + zmax
    rel = labels.long() - ctx.index1() * v_loc
    ok = (rel >= 0) & (rel < v_loc)
    picked = lf.gather(-1, rel.clamp(0, v_loc - 1)[..., None])[..., 0]
    picked = atp_boundary(ctx, picked * ok.float(), ctx.ax1)
    loss = lse - picked
    return torch.where(labels == ignore, torch.zeros_like(loss), loss)


# ---------------------------------------------------------------------------
# Forward.
# ---------------------------------------------------------------------------


def _window_pattern(cfg: ModelConfig, count: int) -> list[int]:
    """Per-layer sliding window sizes (0 = global) for alternating archs."""
    if not cfg.local_global_period:
        return [0] * count
    return [cfg.local_window if i % cfg.local_global_period == 0 else 0
            for i in range(count)]


def _gather_ax1(ctx: ATPContext, u):
    """An ax1-sharded feature dim gathered to full width (JAX places and
    psums instead, to type the result ax1-invariant)."""
    return all_gather(ctx, u, ctx.ax1, dim=-1) if ctx.ax1 else u


def shared_attention(ctx: ATPContext, cfg: ModelConfig, shared, x, x_emb0,
                     positions, plan, cache=None, paged=None):
    """The zamba shared block on (x, the embedding output): two
    column-first in-projections sharing one ax2 boundary, gathered back to
    the block I/O layout, then the shared dense block on ``x + u``.  Under
    autograd, each column-first input is conjugated over ax1 and the
    gathered sum, the same on every ax2 rank, over ax2 before each rank
    takes its features."""
    u = atp_boundary(
        ctx, ops.matmul(conjugate(ctx, x, ctx.ax1), shared["w_in_h"])
        + ops.matmul(conjugate(ctx, x_emb0, ctx.ax1), shared["w_in_e"]),
        ctx.ax2)
    u = shard_slice(conjugate(ctx, _gather_ax1(ctx, u), ctx.ax2),
                    ctx.index2(), ctx.d2, dim=-1)
    return transformer.dense_block(ctx, cfg, shared["block"], x + u,
                                   positions, plan, 0, cache, paged)


def _mamba(ctx, cfg, p, x, pool, sm: SlotMap):
    conv = {k: pool[k] for k in ("conv_x", "conv_bc")}
    x, rows = mamba2.mamba_block(ctx, cfg, p, x, _state_take(conv, sm),
                                 pool["ssd"], sm.slot, sm.fresh)
    _state_put(conv, rows, sm)
    return x


def check_trainable(cfg: ModelConfig):
    """Raise for what the training path does not take yet (every kind the
    port serves trains)."""
    _check_kinds(cfg)


def _embed(ctx: ATPContext, cfg: ModelConfig, params, tokens):
    """The segments' views and the embedding under the first one's."""
    seg_ctxs = [ctx.for_segment(s.kind) for s in segments(cfg)]
    with region("shell:embed"):
        x = embed_tokens(seg_ctxs[0], cfg, params["embed"], tokens)
    return seg_ctxs, x


def _final_norm(ctx: ATPContext, cfg: ModelConfig, params, x):
    with region("shell:exit"):
        return L.norm(ctx, cfg, x, params["final_norm"])


def _train_forward(ctx, cfg, params, tokens, positions, remat: bool):
    """The cache-free forward: attention over the current sequence, the
    Mamba2 blocks from a zero state.  With ``remat`` each unit of the
    reference's ``jax.checkpoint`` runs under ``torch.utils.checkpoint``
    (its activations recomputed in the backward): a dense block, a zamba
    super-block (the shared block and its Mamba2 blocks), a tail Mamba2
    block.  Each unit binds its segment's view, which its recompute runs
    under too."""
    from torch.utils.checkpoint import checkpoint

    seg_ctxs, x = _embed(ctx, cfg, params, tokens)
    x_emb0 = x
    plan = L.make_attn_plan(ctx, cfg.num_heads, cfg.num_kv_heads)
    for i, (seg, sctx) in enumerate(zip(segments(cfg), seg_ctxs)):
        sp = params[f"seg{i}"]
        units = []
        if seg.kind == "dense":
            for j, window in enumerate(_window_pattern(cfg, seg.count)):
                def unit(h, bp=_layer(sp, j), window=window, sctx=sctx):
                    return transformer.dense_block(sctx, cfg, bp, h,
                                                   positions, plan, window)
                units.append(unit)
        elif seg.kind == "zamba":
            for j in range(seg.count):
                def unit(h, mp=_layer(sp["mamba"], j), inner=seg.inner,
                         sctx=sctx):
                    h = shared_attention(sctx, cfg, params["shared_attn"], h,
                                         x_emb0, positions, plan)
                    for m in range(inner - 1):
                        h = mamba2.mamba_block(sctx, cfg, _layer(mp, m), h)[0]
                    return h
                units.append(unit)
        else:
            for j in range(seg.count):
                def unit(h, bp=_layer(sp, j), sctx=sctx):
                    return mamba2.mamba_block(sctx, cfg, bp, h)[0]
                units.append(unit)
        with region(f"seg{i}:{seg.kind}"):
            for unit in units:
                x = (checkpoint(unit, x, use_reentrant=False) if remat
                     else unit(x))
    return _final_norm(ctx, cfg, params, x)


def forward(ctx: ATPContext, cfg: ModelConfig, params, tokens, positions,
            caches: dict | None = None, paged: dict | None = None,
            remat: bool = False):
    """tokens/positions [b, s] -> the final-norm hidden [b, s, h/d2].

    Paged (serving): caches from :func:`init_paged_caches` (written in
    place); paged = dict(table [b, mp], start [b]) and, for recurrent
    kinds, ``slot [b]``.  With no caches (training) the attention runs over
    the sequence itself and the Mamba2 blocks start from zeros; ``remat``
    recomputes each block's (each zamba super-block's) activations in the
    backward."""
    if caches is None:
        check_trainable(cfg)
        return _train_forward(ctx, cfg, params, tokens, positions, remat)
    _check_kinds(cfg)
    sm = None
    if is_recurrent(cfg):
        if paged.get("slot") is None:
            raise ValueError("paged serving of recurrent kinds needs "
                             "paged['slot'], the per-row slot ids")
        sm = fixed_slot_map(paged["slot"], paged["start"],
                            _state_slots(cfg, caches))
    seg_ctxs, x = _embed(ctx, cfg, params, tokens)
    x_emb0 = x
    plan = L.make_attn_plan(ctx, cfg.num_heads, cfg.num_kv_heads)
    for i, (seg, sctx) in enumerate(zip(segments(cfg), seg_ctxs)):
        sp, sc = params[f"seg{i}"], caches[f"seg{i}"]
        with region(f"seg{i}:{seg.kind}"):
            if seg.kind == "dense":
                for j, window in enumerate(_window_pattern(cfg, seg.count)):
                    x = transformer.dense_block(sctx, cfg, _layer(sp, j), x,
                                                positions, plan, window,
                                                _layer(sc, j), paged)
            elif seg.kind == "zamba":
                for j in range(seg.count):
                    x = shared_attention(sctx, cfg, params["shared_attn"], x,
                                         x_emb0, positions, plan,
                                         _layer(sc["attn"], j), paged)
                    mp, mc = _layer(sp["mamba"], j), _layer(sc["mamba"], j)
                    for m in range(seg.inner - 1):
                        x = _mamba(sctx, cfg, _layer(mp, m), x,
                                   _layer(mc, m), sm)
            else:
                for j in range(seg.count):
                    x = _mamba(sctx, cfg, _layer(sp, j), x, _layer(sc, j), sm)
    return _final_norm(ctx, cfg, params, x)


def _state_slots(cfg: ModelConfig, caches: dict) -> int:
    """The slot count of the state pools (the sentinel slot id)."""
    for i, seg in enumerate(segments(cfg)):
        if seg.kind == "zamba":
            return caches[f"seg{i}"]["mamba"]["ssd"].shape[2]
        if seg.kind == "mamba":
            return caches[f"seg{i}"]["ssd"].shape[1]
    raise ValueError("no recurrent segment")


def _positions(tokens):
    """``0 .. s-1`` in every row of a [b, s] batch of whole sequences."""
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None, :].expand(b, s)


def train_loss(ctx: ATPContext, cfg: ModelConfig, params, batch,
               remat: bool = True):
    """batch: tokens [b, s] and labels [b, s] (this dp rank's rows).  The
    scalar mean loss over every token of every dp rank (ignored labels
    count in the denominator, as in the JAX package), the same on every
    rank: the sum goes through the dp boundary, so each rank's backward
    gives its own tokens' share of the gradient, which the optimizer sums
    over dp."""
    tokens = batch["tokens"]
    h = forward(ctx, cfg, params, tokens, _positions(tokens), remat=remat)
    with region("shell:head"):
        per_tok = vocab_parallel_ce(ctx, lm_logits(ctx, cfg, params, h),
                                    batch["labels"])
    with region("shell:loss"):
        total = atp_boundary(ctx, per_tok.sum(), ctx.dp_axes)
    return total / (per_tok.numel() * ctx.dp)


def prefill_logits(ctx: ATPContext, cfg: ModelConfig, params, batch):
    """Forward only, no caches; the last position's logits [b, V/d1]."""
    tokens = batch["tokens"]
    h = forward(ctx, cfg, params, tokens, _positions(tokens))
    with region("shell:head"):
        return lm_logits(ctx, cfg, params, h[:, -1:])[:, 0]


def _replicated(ctx):
    return ()


#: the TP axes a leaf of the sharded tree is cut over, by leaf name: the
#: dense blocks', the Mamba2 blocks' (``ln`` a feature like the block
#: norms; the per-head leaves replicated) and the zamba shared block's
#: in-projections
_LEAF_SPECS = {"embed": L.embed_spec, "lm_head": L.head_spec,
               "scale": L.feat_spec, "bias": L.feat_spec,
               "w_qkv": L.col_w_spec, "w_upgate": L.col_w_spec,
               "w_up": L.col_w_spec, "b_qkv": L.col_b_spec,
               "wo": L.row_w_spec, "w_down": L.row_w_spec,
               "q_norm": _replicated, "k_norm": _replicated,
               "w_zx": L.col_w_spec, "w_bcdt": lambda ctx: (ctx.ax2, None),
               "w_out": L.row_w_spec, "ln": L.feat_spec,
               "conv": _replicated, "A_log": _replicated, "D": _replicated,
               "dt_bias": _replicated, "gn": _replicated,
               "w_in_h": L.col_w_spec, "w_in_e": L.col_w_spec}


def replication_factors(cfg: ModelConfig, ctx: ATPContext, params) -> dict:
    """Per leaf of this rank's tree: how many TP ranks hold the same
    shard (tp over the product of the TP axes the leaf is cut over), which
    the global gradient norm divides out."""
    check_trainable(cfg)

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        spec = _LEAF_SPECS[name](ctx)
        sharded = 1
        for axis in spec:
            if axis is not None:
                sharded *= ctx.topo.axis_size(axis)
        return ctx.tp // sharded

    return walk(params)


def paged_step(ctx: ATPContext, cfg: ModelConfig, params, tokens, start,
               table, caches, slot=None):
    """One paged cache-write step — decode tick AND prefill chunk.

    tokens [b, s] (decode: b=slots, s=1; prefill chunk: b=1, s=chunk);
    start [b] per-slot absolute position of tokens[:, 0]; table [b, mp]
    page-table rows; caches from :func:`init_paged_caches`; slot [b]
    per-row slot ids (required for recurrent kinds; a masked row carries
    the sentinel id = the pools' slot count, and its state write drops).

    Returns (logits [b, s, V/d1] for every input position, caches)."""
    b, s = tokens.shape
    positions = start[:, None].long() + torch.arange(s, device=tokens.device)[None, :]
    paged = {"table": table, "start": start}
    if slot is not None:
        paged["slot"] = slot
    h = forward(ctx, cfg, params, tokens, positions, caches, paged)
    with region("shell:head"):
        return lm_logits(ctx, cfg, params, h), caches

