"""Language model: embedding -> block stack -> head, ATP-sharded
(counterpart of ``repro.models.lm``): paged serving, the wave baseline over
contiguous decode caches (``init_decode_caches``, ``decode_step``) and the
training loss (``forward`` with no caches, ``vocab_parallel_ce``,
``train_loss``, with the MoE aux term and the MTP head's term) of the
dense, moe, mla_dense, mla_moe, zamba and mamba segment kinds, and the
MTP head as the speculative server's draft proposer
(``mtp_draft_logits``).  A moe layer is a dense block's attention (and
k/v caches) followed by the MoE FFN (``models.moe``); an MLA layer
(``models.mla``) caches its latent instead of k/v, and an MLA model's MTP
head runs an ``mla_dense`` block.

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
CUDA graph; :func:`slot_map` is the host-synced form it replaced.  The
wave's contiguous caches hold the same state per batch row: the rows are
the slots (``arange(b)``), fresh where the row's window starts at 0.

Each segment runs under its own view of the context,
``ctx.for_segment(kind)`` (a plan's per-segment knobs), as in the
reference; the embedding takes the first segment's view, the final norm
the last one's, and the head the context itself.  Under the
sequence-parallel block I/O the embedding's all-reduce becomes a
reduce-scatter of the sequence over ax1, the residual stream changes
domain between a sequence-parallel segment and one that is not (a free
slice in, a gather out), and the final norm's output is gathered back to
the full sequence for the head (training and prefill; serving masks
``seq_parallel``).  The collectives are attributed to the reference's
regions (``analysis.signature.region``): ``shell:embed``, ``shell:trans{i}``,
``seg{i}:{kind}``, ``shell:exit``, ``shell:head``, ``shell:loss`` (and
``shell:pick``, the serving step's greedy pick).
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import torch

from repro_torch.analysis.signature import region
from repro_torch.configs.base import ModelConfig, segments
from repro_torch.core.atp import (ATPContext, all_gather, all_reduce_max,
                                  atp_boundary, atp_reduce_scatter, conjugate,
                                  seq_gather, seq_scatter, shard_slice)
from repro_torch.core.mesh import (MeshTopo, dp_axis_names, resolve_device,
                                   tp_axis_names)
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import mamba2, mla, moe, paging, transformer

_A10 = "segment kind {!r} is not ported yet (ROADMAP A10: other segment kinds)"

#: segment kinds the port serves
KINDS = frozenset({"dense", "moe", "mla_dense", "mla_moe", "zamba",
                   "mamba"})
#: the kinds whose layers are a dense block's attention with its k/v caches
#: (the reference's ``PAGED_CACHE_KINDS`` without MLA's)
ATTN_KINDS = frozenset({"dense", "moe"})
#: the kinds whose layers cache MLA's latent (``ckv``/``krope``)
MLA_KINDS = frozenset({"mla_dense", "mla_moe"})
#: the served kinds with O(1)-per-slot recurrent state, pooled by slot id
RECURRENT_STATE_KINDS = frozenset({"mamba", "zamba"})


def _check_kinds(cfg: ModelConfig):
    for seg in segments(cfg):
        if seg.kind not in KINDS:
            raise NotImplementedError(_A10.format(seg.kind))


def is_recurrent(cfg: ModelConfig) -> bool:
    return any(s.kind in RECURRENT_STATE_KINDS for s in segments(cfg))


def _layer(tree, i: int):
    """Layer ``i`` of a layer-stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _layers(tree, n: int) -> list:
    """The ``n`` layers of a layer-stacked parameter tree (views), each leaf
    unbound once along its leading dim.  Under autograd a leaf then has one
    ``UnbindBackward0``, which stacks the layers' gradients; binding each
    layer by ``_layer`` gives each its own ``SelectBackward0``, a
    zero-filled copy of the whole stack, and the L copies are added one by
    one (bytes that grow as L^2)."""
    if isinstance(tree, dict):
        per = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


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

    def moe_layer():
        blk = transformer.dense_block_params(gen, cfg, dtype, device,
                                             mlp=False)
        blk["moe"] = moe.moe_params(gen, cfg, dtype, device)
        return blk

    def mla_layer(kind):
        return lambda: mla.layer_params(gen, cfg, dtype, device, kind)

    for i, seg in enumerate(segments(cfg)):
        if seg.kind == "dense":
            p[f"seg{i}"] = _stacked((seg.count,), dense)
        elif seg.kind in MLA_KINDS:
            p[f"seg{i}"] = _stacked((seg.count,), mla_layer(seg.kind))
        elif seg.kind == "moe":
            p[f"seg{i}"] = _stacked((seg.count,), moe_layer)
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
    if cfg.mtp:
        # the MTP head: two [h, h] projections of (h, emb(next)), a dense
        # block (an mla_dense layer for an MLA model) and its norm
        s = 1.0 / math.sqrt(2 * h)
        p["mtp"] = {
            "proj_h": transformer._normal(gen, (h, h), s, dtype, device),
            "proj_e": transformer._normal(gen, (h, h), s, dtype, device),
            "block": mla_layer("mla_dense")() if cfg.mla else dense(),
            "norm": {k: v.to(device) for k, v in L.norm_params(cfg, h).items()}}
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
        elif seg.kind in MLA_KINDS:
            out[f"seg{i}"] = mla.shard_layer(ctx, cfg, sp)
        elif seg.kind == "moe":
            blk = transformer.shard_dense_block(ctx, cfg, sp)
            blk["moe"] = moe.shard_moe(ctx, cfg, sp.pop("moe"))
            out[f"seg{i}"] = blk
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
    if "mtp" in params:
        mp = params.pop("mtp")
        col = L.col_w_spec(ctx)
        out["mtp"] = {
            "proj_h": L.cut(ctx, mp.pop("proj_h"), col),
            "proj_e": L.cut(ctx, mp.pop("proj_e"), col),
            "block": (mla.shard_layer(ctx, cfg, mp.pop("block"), lead=0)
                      if cfg.mla else transformer.shard_dense_block(
                          ctx, cfg, mp.pop("block"), lead=0)),
            "norm": {k: L.cut(ctx, v, nspec)
                     for k, v in mp.pop("norm").items()}}
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
    defaults to the model's.  A quantized ``pcfg`` (int8/fp8) stores the
    k/v pools in 1-byte elements and adds ``k_scale``/``v_scale`` fp16
    pools ``[count, np, pg, kv_count]`` beside them (the zamba shared
    block's pools too).  MLA layers: latent pools ``{"ckv": [count, np,
    pg, kv_lora_rank], "krope": [count, np, pg, qk_rope_head_dim]}``,
    replicated over TP, with ``ckv_scale``/``krope_scale`` [count, np, pg]
    fp16 for a quantized ``pcfg``."""
    _check_kinds(cfg)
    device = resolve_device(device)
    if slots is None and is_recurrent(cfg):
        raise ValueError(
            "paged serving of recurrent kinds (mamba/zamba) needs "
            "slots=<scheduler batch_slots> to size the per-slot state pools")
    dtype = dtype or getattr(torch, cfg.dtype)
    plan = L.make_attn_plan(ctx, cfg.num_heads, cfg.num_kv_heads)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    store = paging.page_store_dtype(pcfg.page_dtype) or dtype

    def attn_pool(count):
        shape = (count, pcfg.num_pages, pcfg.page_size, plan.kv_count, cfg.hd)
        c = {"k": zeros(shape, store), "v": zeros(shape, store)}
        if pcfg.quantized:
            # parallel scale pools: the same paging, the feature dim dropped
            c["k_scale"] = zeros(shape[:-1], torch.float16)
            c["v_scale"] = zeros(shape[:-1], torch.float16)
        return c

    def mla_pool(count):
        m = cfg.mla
        c = {"ckv": zeros((count, pcfg.num_pages, pcfg.page_size,
                           m.kv_lora_rank), store),
             "krope": zeros((count, pcfg.num_pages, pcfg.page_size,
                             m.qk_rope_head_dim), store)}
        if pcfg.quantized:
            shape = (count, pcfg.num_pages, pcfg.page_size)
            c["ckv_scale"] = zeros(shape, torch.float16)
            c["krope_scale"] = zeros(shape, torch.float16)
        return c

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
        if seg.kind in ATTN_KINDS:
            caches[f"seg{i}"] = attn_pool(seg.count)
        elif seg.kind in MLA_KINDS:
            caches[f"seg{i}"] = mla_pool(seg.count)
        elif seg.kind == "zamba":
            caches[f"seg{i}"] = {"attn": attn_pool(seg.count),
                                 "mamba": mamba_state((seg.count, seg.inner - 1))}
        else:
            caches[f"seg{i}"] = mamba_state((seg.count,))
    return caches


def init_decode_caches(cfg: ModelConfig, ctx: ATPContext, B: int,
                       s_max: int, dtype=None, device=None) -> dict:
    """The wave's contiguous decode caches, this rank's shards of the JAX
    ``init_decode_caches`` (``[count, B, s_max, tp*kv_count, hd]`` k/v cut
    over the flat TP ranks), on ``device`` (CUDA unless named).

    The batch splits over the dp ranks where ``B % dp == 0`` and is
    replicated otherwise (a batch smaller than dp), so a rank holds ``b``
    rows (:func:`decode_rows`).  Attention (dense segments and each zamba
    super-block's shared block): ``{"k": [count, b, s_max, kv_count, hd],
    "v": ..., "len": [count] int32}``.  Recurrent kinds, per batch row:
    ``conv_x [.., b, k-1, d_inner/n]`` and ``conv_bc [.., b, k-1, 2 ds]`` in
    ``dtype`` and ``ssd [.., b, nh/n, hd, ds]`` in fp32; a zamba segment
    nests them as ``{"attn": ..., "mamba": ...}`` with the Mamba2 state
    stacked ``[count, inner-1, ...]``.  MLA layers: the latent ``{"ckv":
    [count, b, s_max, kv_lora_rank], "krope": [count, b, s_max,
    qk_rope_head_dim], "len": [count] int32}``, replicated over TP.
    ``dtype`` defaults to the model's.  xLSTM caches are ROADMAP A10
    (``_check_kinds`` raises)."""
    _check_kinds(cfg)
    device = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    b = decode_rows(ctx, B)
    plan = L.make_attn_plan(ctx, cfg.num_heads, cfg.num_kv_heads)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def attn_cache(count):
        shape = (count, b, s_max, plan.kv_count, cfg.hd)
        return {"k": zeros(shape), "v": zeros(shape),
                "len": zeros((count,), torch.int32)}

    def mla_cache(count):
        m = cfg.mla
        return {"ckv": zeros((count, b, s_max, m.kv_lora_rank)),
                "krope": zeros((count, b, s_max, m.qk_rope_head_dim)),
                "len": zeros((count,), torch.int32)}

    def mamba_cache(lead):
        d_inner, nheads = mamba2.mamba_dims(cfg)
        sc, n = cfg.ssm, ctx.tp
        lead = lead + (b,)
        return {"conv_x": zeros(lead + (sc.conv_kernel - 1, d_inner // n)),
                "conv_bc": zeros(lead + (sc.conv_kernel - 1, 2 * sc.d_state)),
                "ssd": zeros(lead + (nheads // n, sc.head_dim, sc.d_state),
                             torch.float32)}

    caches = {}
    for i, seg in enumerate(segments(cfg)):
        if seg.kind in ATTN_KINDS:
            caches[f"seg{i}"] = attn_cache(seg.count)
        elif seg.kind in MLA_KINDS:
            caches[f"seg{i}"] = mla_cache(seg.count)
        elif seg.kind == "zamba":
            caches[f"seg{i}"] = {"attn": attn_cache(seg.count),
                                 "mamba": mamba_cache((seg.count,
                                                       seg.inner - 1))}
        else:
            caches[f"seg{i}"] = mamba_cache((seg.count,))
    return caches


def decode_rows(ctx: ATPContext, B: int) -> int:
    """The batch rows a rank holds of a wave of ``B``: ``B / dp`` where dp
    divides it, else all ``B`` (replicated: the dp ranks repeat the work)."""
    return B // ctx.dp if ctx.dp_axes and B % ctx.dp == 0 else B


def reset_decode_caches(caches: dict) -> None:
    """Start a new wave in the same caches: every ``len`` to 0, in place
    (the recurrent state rows read as zeros at position 0, and the stale
    k/v lie beyond ``kv_len``), so a captured step stays bound to them."""
    for k, v in caches.items():
        if isinstance(v, dict):
            reset_decode_caches(v)
        elif k == "len":
            v.zero_()


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
    """emb local [V/d1, h/d2]; tokens [b, s] -> x [b, s, h/d2].  Under
    ``seq_parallel`` (the sequence-parallel entry) the vocab-parallel
    all-reduce over ax1 and the sequence slice are one reduce-scatter:
    x [b, s/d1, h/d2]."""
    v_loc = emb.shape[0]
    rel = tokens.long() - ctx.index1() * v_loc
    ok = (rel >= 0) & (rel < v_loc)
    x = emb[rel.clamp(0, v_loc - 1)] * ok[..., None].to(emb.dtype)
    if ctx.seq_parallel and ctx.ax1 is not None:
        if x.shape[1] % ctx.d1:
            raise ValueError(f"seq_parallel requires seq ({x.shape[1]}) "
                             f"divisible by d1={ctx.d1}")
        x = atp_reduce_scatter(ctx, x, ctx.ax1, dim=1)
    else:
        x = atp_boundary(ctx, x, ctx.ax1)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def lm_logits(ctx: ATPContext, cfg: ModelConfig, params, x,
              conj: bool = True):
    """x [b, s, h/d2] -> logits [b, s, V/d1] (ax2-replicated).  A tied head
    reads the embedding transposed, without a copy.  A column-first GEMM:
    x's conjugate sums its gradient over ax1 (``conj=False``: the
    sequence gather that made x reduce-scatters it)."""
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    if conj:
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


def moe_layer(ctx: ATPContext, cfg: ModelConfig, p, x, positions, plan,
              window: int, cache=None, paged=None):
    """One moe layer (the reference's ``_apply_block("moe")``): the dense
    block's attention, then the MoE FFN.  Returns (x, the aux loss)."""
    h = L.norm(ctx, cfg, x, p["ln_attn"])
    x = x + transformer.attn_block(ctx, cfg, p["attn"], h, positions, plan,
                                   window, cache, paged)
    m, aux = moe.moe_block(ctx, cfg, p["moe"], L.norm(ctx, cfg, x,
                                                      p["ln_mlp"]))
    return x + m, aux


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
    """The segments' views and the embedding under the first one's (a
    reduce-scatter of the sequence where that one is sequence-parallel)."""
    seg_ctxs = [ctx.for_segment(s.kind) for s in segments(cfg)]
    with region("shell:embed"):
        x = embed_tokens(seg_ctxs[0], cfg, params["embed"], tokens)
    return seg_ctxs, x


def _transition(i: int, prev, sctx: ATPContext, x):
    """The residual stream into segment ``i``'s block I/O spec from the
    previous segment's view ``prev``: a free slice into the
    sequence-parallel domain, an all-gather out of it."""
    with region(f"shell:trans{i}"):
        if sctx.seq_parallel and not prev.seq_parallel:
            return seq_scatter(sctx, x, dim=1)
        if prev.seq_parallel and not sctx.seq_parallel:
            return seq_gather(prev, x, dim=1)
    return x


def _exit_gathers(ctx: ATPContext, cfg: ModelConfig) -> bool:
    """Whether the forward leaves the sequence-parallel domain at its exit
    (the last segment's view runs it, on more than one ax1 rank): the
    head's input then comes from a gather whose backward reduces its
    gradient, and the head takes no conjugate."""
    last = ctx.for_segment(segments(cfg)[-1].kind)
    return last.seq_parallel and last.ax1 is not None


def _final_norm(cfg: ModelConfig, params, last: ATPContext, x):
    """The final norm under the last segment's view, then the gather back
    to the full sequence where that view is sequence-parallel."""
    with region("shell:exit"):
        x = L.norm(last, cfg, x, params["final_norm"])
        return seq_gather(last, x, dim=1, reduce_grad=True)


def _train_forward(ctx, cfg, params, tokens, positions, remat: bool):
    """The cache-free forward: attention over the current sequence, the
    Mamba2 blocks from a zero state.  With ``remat`` each unit of the
    reference's ``jax.checkpoint`` runs under ``torch.utils.checkpoint``
    (its activations recomputed in the backward): a dense block, a zamba
    super-block (the shared block and its Mamba2 blocks), a tail Mamba2
    block.  Each unit binds its segment's view, which its recompute runs
    under too.  Each stacked leaf is unbound once, outside the units
    (``_layers``; a zamba leaf once, then once a super-block), so the
    recompute reuses the same views and the backward stacks each leaf's
    gradient once.  Returns the final-norm hidden and the MoE layers' aux loss
    summed (0 without them)."""
    from torch.utils.checkpoint import checkpoint

    seg_ctxs, x = _embed(ctx, cfg, params, tokens)
    x_emb0 = x
    aux = x.new_zeros((), dtype=torch.float32)
    plan = L.make_attn_plan(ctx, cfg.num_heads, cfg.num_kv_heads)
    for i, (seg, sctx) in enumerate(zip(segments(cfg), seg_ctxs)):
        x = _transition(i, seg_ctxs[max(i - 1, 0)], sctx, x)
        sp = params[f"seg{i}"]
        units = []
        if seg.kind == "dense":
            for window, bp in zip(_window_pattern(cfg, seg.count),
                                  _layers(sp, seg.count)):
                def unit(h, bp=bp, window=window, sctx=sctx):
                    return transformer.dense_block(sctx, cfg, bp, h,
                                                   positions, plan, window)
                units.append(unit)
        elif seg.kind == "moe":
            for window, bp in zip(_window_pattern(cfg, seg.count),
                                  _layers(sp, seg.count)):
                def unit(h, bp=bp, window=window, sctx=sctx):
                    return moe_layer(sctx, cfg, bp, h, positions, plan,
                                     window)
                units.append(unit)
        elif seg.kind in MLA_KINDS:
            for bp in _layers(sp, seg.count):
                def unit(h, bp=bp, sctx=sctx):
                    return mla.mla_layer(sctx, cfg, bp, h, positions)
                units.append(unit)
        elif seg.kind == "zamba":
            for mp in _layers(sp["mamba"], seg.count):
                def unit(h, blocks=_layers(mp, seg.inner - 1), sctx=sctx):
                    h = shared_attention(sctx, cfg, params["shared_attn"], h,
                                         x_emb0, positions, plan)
                    for bp in blocks:
                        h = mamba2.mamba_block(sctx, cfg, bp, h)[0]
                    return h
                units.append(unit)
        else:
            for bp in _layers(sp, seg.count):
                def unit(h, bp=bp, sctx=sctx):
                    return mamba2.mamba_block(sctx, cfg, bp, h)[0]
                units.append(unit)
        with region(f"seg{i}:{seg.kind}"):
            for unit in units:
                x = (checkpoint(unit, x, use_reentrant=False) if remat
                     else unit(x))
                if seg.kind in ("moe", "mla_moe"):
                    x, a = x
                    aux = aux + a
                elif seg.kind == "mla_dense":
                    x = x[0]
    return _final_norm(cfg, params, seg_ctxs[-1], x), aux


def forward(ctx: ATPContext, cfg: ModelConfig, params, tokens, positions,
            caches: dict | None = None, paged: dict | None = None,
            remat: bool = False):
    """tokens/positions [b, s] -> the final-norm hidden [b, s, h/d2].

    Paged (serving): caches from :func:`init_paged_caches` (written in
    place); paged = dict(table [b, mp], start [b]) and, for recurrent
    kinds, ``slot [b]``.  Contiguous (the wave; paged None): caches from
    :func:`init_decode_caches`, written in place: the attention at each
    layer's ``len``, the recurrent state at the batch rows (fresh where the
    row's window starts at position 0).  With no caches (training) the
    attention runs over the sequence itself and the Mamba2 blocks start
    from zeros; ``remat`` recomputes each block's (each zamba
    super-block's) activations in the backward."""
    if caches is None:
        check_trainable(cfg)
        return _train_forward(ctx, cfg, params, tokens, positions, remat)[0]
    _check_kinds(cfg)
    if any(ctx.for_segment(s.kind).seq_parallel for s in segments(cfg)):
        raise NotImplementedError("seq_parallel does not apply to decode")
    sm = None
    if is_recurrent(cfg) and paged is None:
        b = tokens.shape[0]
        sm = fixed_slot_map(torch.arange(b, device=tokens.device),
                            positions[:, 0], b)
    elif is_recurrent(cfg):
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
            elif seg.kind == "moe":
                for j, window in enumerate(_window_pattern(cfg, seg.count)):
                    x = moe_layer(sctx, cfg, _layer(sp, j), x, positions,
                                  plan, window, _layer(sc, j), paged)[0]
            elif seg.kind in MLA_KINDS:
                for j in range(seg.count):
                    x = mla.mla_layer(sctx, cfg, _layer(sp, j), x, positions,
                                      _layer(sc, j), paged)[0]
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
    return _final_norm(cfg, params, seg_ctxs[-1], x)


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
    over dp.  With an MTP head, ``mtp_loss_weight`` times the head's loss
    on the token two ahead (labels rolled by one) over the same count; with
    MoE layers, ``aux_loss_weight`` times their aux loss averaged over dp,
    per layer."""
    tokens = batch["tokens"]
    positions = _positions(tokens)
    check_trainable(cfg)
    h, aux = _train_forward(ctx, cfg, params, tokens, positions, remat)
    conj = not _exit_gathers(ctx, cfg)
    with region("shell:head"):
        logits = lm_logits(ctx, cfg, params, h, conj=conj)
        per_tok = vocab_parallel_ce(ctx, logits, batch["labels"])
    with region("shell:loss"):
        total = atp_boundary(ctx, per_tok.sum(), ctx.dp_axes)
    count = per_tok.numel() * ctx.dp
    loss = total / count
    if cfg.mtp:
        # predict t+2 from (h_t, emb(t+1))
        with region("shell:mtp"):
            logits2 = _mtp_logits(ctx, cfg, params, h, positions,
                                  torch.roll(tokens, -1, dims=1), conj)
            per_tok2 = vocab_parallel_ce(
                ctx, logits2, torch.roll(batch["labels"], -1, dims=1))
            l2 = atp_boundary(ctx, per_tok2.sum(), ctx.dp_axes)
        loss = loss + cfg.mtp_loss_weight * l2 / count
    if cfg.moe is not None:
        with region("shell:loss"):
            aux = atp_boundary(ctx, aux, ctx.dp_axes) / ctx.dp
        loss = loss + cfg.moe.aux_loss_weight * aux / max(1, cfg.num_layers)
    return loss


def prefill_logits(ctx: ATPContext, cfg: ModelConfig, params, batch):
    """Forward only, no caches; the last position's logits [b, V/d1]."""
    tokens = batch["tokens"]
    h = forward(ctx, cfg, params, tokens, _positions(tokens))
    with region("shell:head"):
        return lm_logits(ctx, cfg, params, h[:, -1:])[:, 0]


def decode_step(ctx: ATPContext, cfg: ModelConfig, params, tokens, pos,
                caches: dict):
    """One step of the wave over contiguous caches (``init_decode_caches``):
    tokens [b, s] at positions ``pos .. pos + s - 1`` (``pos`` an int or a
    0-d device tensor; s > 1 is prefill into the caches).  The attention
    offset is each layer's ``cache["len"]``, as in the reference.  Returns
    (the last position's logits [b, V/d1], caches, written in place)."""
    b, s = tokens.shape
    pos = torch.as_tensor(pos, device=tokens.device).long().reshape(1, 1)
    positions = (pos + torch.arange(s, device=tokens.device)[None, :]
                 ).expand(b, s)
    h = forward(ctx, cfg, params, tokens, positions, caches)
    with region("shell:head"):
        return lm_logits(ctx, cfg, params, h[:, -1:])[:, 0], caches


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
               "w_in_h": L.col_w_spec, "w_in_e": L.col_w_spec,
               "proj_h": L.col_w_spec, "proj_e": L.col_w_spec}


#: the same for the leaves of an MoE layer's ``moe`` node (its ``shared``
#: MLP's are a dense MLP's)
_MOE_SPECS = {"router": _replicated, "w_upgate": moe.expert_spec,
              "w_down": moe.expert_spec}


def replication_factors(cfg: ModelConfig, ctx: ATPContext, params) -> dict:
    """Per leaf of this rank's tree: how many TP ranks hold the same
    shard (tp over the product of the TP axes the leaf is cut over), which
    the global gradient norm divides out."""
    check_trainable(cfg)

    def walk(tree, name=None, parent=None):
        if isinstance(tree, dict):
            return {k: walk(v, k, name) for k, v in tree.items()}
        specs = (_MOE_SPECS if parent == "moe" else mla.SPECS
                 if parent == "mla" else _LEAF_SPECS)
        sharded = 1
        for axis in specs[name](ctx):
            if axis is not None:
                sharded *= L.axis_size(ctx.topo, axis)
        return ctx.tp // sharded

    return walk(params)


def fused_pieces(cfg: ModelConfig, ctx: ATPContext, params) -> dict:
    """Per leaf of this rank's tree: the widths along its last dim of the
    JAX package's leaves it fuses (``shard_params``: q|k|v, their biases,
    up|gate, the Mamba2 z|x), or None for a leaf that is one of the
    reference's whole.  What the reference does per leaf (the compressed
    AdamW's quantization scale) the port does per piece
    (``layers.fused_widths``)."""

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return L.fused_widths(cfg, ctx, name, tree.shape[-1])

    return walk(params)


def paged_step(ctx: ATPContext, cfg: ModelConfig, params, tokens, start,
               table, caches, slot=None, with_hidden: bool = False):
    """One paged cache-write step — decode tick AND prefill chunk.

    tokens [b, s] (decode: b=slots, s=1; prefill chunk: b=1, s=chunk);
    start [b] per-slot absolute position of tokens[:, 0]; table [b, mp]
    page-table rows; caches from :func:`init_paged_caches`; slot [b]
    per-row slot ids (required for recurrent kinds; a masked row carries
    the sentinel id = the pools' slot count, and its state write drops).

    Returns (logits [b, s, V/d1] for every input position, caches);
    ``with_hidden`` adds the final-norm hidden [b, s, h/d2] in the middle
    (speculative decode feeds it to :func:`mtp_draft_logits`)."""
    positions = step_positions(tokens, start)
    paged = {"table": table, "start": start}
    page = _pool_page_size(caches)
    if page is not None:
        # where this step's k/v land: once for every layer, k and v
        paged["write"] = paging.write_plan(table, start, tokens.shape[1], page)
    if slot is not None:
        paged["slot"] = slot
    h = forward(ctx, cfg, params, tokens, positions, caches, paged)
    with region("shell:head"):
        logits = lm_logits(ctx, cfg, params, h)
    if with_hidden:
        return logits, h, caches
    return logits, caches


def _pool_page_size(caches) -> int | None:
    """The page size of the attention pools in :func:`init_paged_caches`'s
    ``caches`` (None for a model with no attention pools)."""
    for c in caches.values():
        c = c.get("attn", c)
        for key in ("k", "ckv"):
            if key in c:
                return c[key].shape[2]
    return None


def step_positions(tokens, start):
    """``start[b] + 0 .. s-1``: the positions of a step's [b, s] tokens."""
    s = tokens.shape[1]
    return (start[:, None].long()
            + torch.arange(s, device=tokens.device)[None, :])


def mtp_draft_logits(ctx: ATPContext, cfg: ModelConfig, params, h, positions,
                     next_tokens):
    """The MTP head as a decode-time draft proposer (the reference's
    ``mtp_draft_logits``): the trunk's final-norm hidden ``h [b, s, h/d2]``
    and the greedy picks made from it, ``next_tokens [b, s]``, give draft
    logits [b, s, V/d1] for the position after each pick.  Its block runs
    under the context without sequence parallelism or segment plans and
    attends only within the fed window (no cache): a weaker proposer, never
    a wrong answer, since the trunk verifies every draft."""
    with region("shell:mtp"):
        return _mtp_logits(ctx, cfg, params, h, positions, next_tokens)


def _mtp_logits(ctx: ATPContext, cfg: ModelConfig, params, h, positions,
                next_tokens, conj: bool = True):
    """The MTP head on (h, emb(next_tokens)), serving's and training's: two
    column-first projections sharing one ax2 boundary, gathered back to
    the block I/O layout, then the dense block (``mla_dense`` for an MLA
    model, cache-free), its norm and the head, all
    under the context without sequence parallelism or segment plans (h
    left the sequence-parallel domain at the forward's exit).  Under
    autograd, each column-first input is conjugated over ax1 (``conj``
    False: h's gather reduce-scatters its gradient instead) and the
    gathered sum over ax2, as in :func:`shared_attention`."""
    mctx = dataclasses.replace(ctx, seq_parallel=False, segment_plans=())
    mp = params["mtp"]
    emb_next = embed_tokens(mctx, cfg, params["embed"], next_tokens)
    if conj:
        h = conjugate(mctx, h, mctx.ax1)
    u = atp_boundary(
        mctx, ops.matmul(h, mp["proj_h"])
        + ops.matmul(conjugate(mctx, emb_next, mctx.ax1), mp["proj_e"]),
        mctx.ax2)
    # back to the [.., h/d2] block I/O layout
    u = shard_slice(conjugate(mctx, _gather_ax1(mctx, u), mctx.ax2),
                    mctx.index2(), mctx.d2, dim=-1)
    if cfg.mla:
        u = mla.mla_layer(mctx, cfg, mp["block"], u, positions)[0]
    else:
        plan = L.make_attn_plan(mctx, cfg.num_heads, cfg.num_kv_heads)
        u = transformer.dense_block(mctx, cfg, mp["block"], u, positions,
                                    plan, 0)
    u = L.norm(mctx, cfg, u, mp["norm"])
    return lm_logits(mctx, cfg, params, u)

