"""Model / run configuration system.

One frozen dataclass describes every architecture in the zoo; families are
expressed through optional sub-configs (MoE, MLA, SSM) and a block pattern.
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0          # deepseek shared experts
    capacity_factor: float = 1.0
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.001
    first_dense_layers: int = 0  # deepseek: first k layers are dense


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    conv_kernel: int = 4
    chunk: int = 64              # chunked-scan block size
    # zamba2 hybrid: apply the shared attention block every k-th layer
    shared_attn_every: int = 0
    # xlstm: one sLSTM per `slstm_every` blocks (rest mLSTM)
    slstm_every: int = 0
    proj_factor: float = 2.0     # mLSTM up-projection factor


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    max_seq_len: int = 131072

    # attention variants
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0          # gemma2: 50.0
    logit_softcap: float = 0.0         # gemma2: 30.0
    local_window: int = 0              # sliding-window size
    local_global_period: int = 0       # gemma2: 2 (alternating local/global)
    rope_theta: float = 10000.0
    use_rope: bool = True
    mrope_sections: tuple[int, ...] = ()  # qwen2-vl M-RoPE
    post_block_norms: bool = False     # gemma2 post-attn/post-ffn RMSNorm
    embed_scale: bool = False          # gemma2: x *= sqrt(d_model)

    mlp_kind: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    norm_kind: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    mtp: bool = False                  # deepseek multi-token prediction head
    mtp_loss_weight: float = 0.3

    ssm: SSMConfig | None = None

    frontend: Literal["tokens", "audio_tokens", "vision_patches"] = "tokens"
    dtype: str = "bfloat16"

    # --- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.hd

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid state-space decode)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        h, L = self.d_model, self.num_layers
        emb = self.vocab_size * h
        head = 0 if self.tie_embeddings else self.vocab_size * h
        per_layer = 0
        if self.ssm is not None and self.family in ("ssm", "hybrid"):
            d_in = self.ssm.expand * h
            nheads = d_in // self.ssm.head_dim
            if self.ssm.slstm_every:  # xlstm
                pf = self.ssm.proj_factor
                d_up = int(pf * h)
                mlstm = h * d_up * 2 + 3 * d_up * d_up // 1 + d_up * h
                slstm = 4 * h * h + 4 * h * h // self.num_heads + 2 * h * int(1.3 * h)
                n_s = L // self.ssm.slstm_every
                return emb + head + (L - n_s) * mlstm + n_s * slstm
            mamba = (
                h * (2 * d_in + 2 * self.ssm.d_state + nheads)  # in_proj
                + d_in * h                                        # out_proj
                + d_in * self.ssm.conv_kernel + 3 * nheads
            )
            attn_every = self.ssm.shared_attn_every or 0
            shared_attn = (2 * h) * h + h * (self.q_dim + 2 * self.kv_dim) + self.q_dim * h \
                + 3 * h * self.d_ff if attn_every else 0
            return emb + head + L * mamba + shared_attn
        # attention archs
        attn = h * (self.q_dim + 2 * self.kv_dim) + self.q_dim * h
        if self.mla is not None:
            m = self.mla
            attn = (
                h * m.q_lora_rank
                + m.q_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + h * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + self.num_heads * m.v_head_dim * h
            )
        ff_mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        if self.moe is not None:
            moe_ff = ff_mult * h * self.moe.d_ff_expert
            n_moe = L - self.moe.first_dense_layers
            per_layer = attn + moe_ff * (self.moe.num_experts + self.moe.num_shared) \
                + h * self.moe.num_experts
            dense_layer = attn + ff_mult * h * self.d_ff
            return emb + head + n_moe * per_layer + self.moe.first_dense_layers * dense_layer
        per_layer = attn + ff_mult * h * self.d_ff
        return emb + head + L * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        h, L = self.d_model, self.num_layers
        ff_mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        attn = h * (self.q_dim + 2 * self.kv_dim) + self.q_dim * h
        if self.mla is not None:
            m = self.mla
            attn = (
                h * m.q_lora_rank
                + m.q_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + h * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + self.num_heads * m.v_head_dim * h
            )
        moe_ff = ff_mult * h * self.moe.d_ff_expert
        n_moe = L - self.moe.first_dense_layers
        per_moe = attn + moe_ff * (self.moe.top_k + self.moe.num_shared) + h * self.moe.num_experts
        per_dense = attn + ff_mult * h * self.d_ff
        emb = self.vocab_size * h
        head = 0 if self.tie_embeddings else self.vocab_size * h
        return emb + head + n_moe * per_moe + self.moe.first_dense_layers * per_dense

    def validate_for_tp(self, d1: int, d2: int) -> list[str]:
        """Divisibility requirements for an ATP (d1, d2) mesh; returns
        human-readable issue list (empty == valid)."""
        issues = []
        n = d1 * d2
        for nm, v in (("d_model", self.d_model), ("vocab", self.vocab_size)):
            if v % n:
                issues.append(f"{nm}={v} not divisible by tp={n}")
        if self.d_ff and self.d_ff % n:
            issues.append(f"d_ff={self.d_ff} not divisible by tp={n}")
        if self.moe and (ff := self.moe.d_ff_expert) % n:
            issues.append(f"expert d_ff={ff} not divisible by tp={n}")
        return issues

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        changes: dict = dict(
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32,
            max_seq_len=256,
            local_window=16 if self.local_window else 0,
        )
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, chunk=16,
                shared_attn_every=2 if self.ssm.shared_attn_every else 0,
                slstm_every=2 if self.ssm.slstm_every else 0,
            )
            changes["num_layers"] = 4
            changes["num_heads"] = 4 if self.ssm.slstm_every else 4
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_ff_expert=64,
                first_dense_layers=min(self.moe.first_dense_layers, 1),
            )
            changes["num_layers"] = 2 + (1 if self.moe.first_dense_layers else 0)
        if self.mla is not None:
            changes["mla"] = MLAConfig(
                q_lora_rank=64, kv_lora_rank=32,
                qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
            )
        if self.mrope_sections:
            changes["mrope_sections"] = (4, 6, 6)
        if self.local_global_period:
            changes["num_layers"] = 2
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Segment plan: every architecture is a list of block segments (models.lm
# scans each segment; the strategy stack prices and plans them per kind).
# Lives here — not in models — so the cost model / plan search can derive
# per-segment workloads from a ModelConfig without importing model code.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    count: int          # scan length
    inner: int = 1      # blocks per scan step (zamba/xlstm super-blocks)


def segments(cfg: ModelConfig) -> tuple[Segment, ...]:
    if cfg.ssm is not None and cfg.ssm.slstm_every:          # xlstm
        period = cfg.ssm.slstm_every
        assert cfg.num_layers % period == 0
        return (Segment("xlstm", cfg.num_layers // period, period),)
    if cfg.ssm is not None and cfg.ssm.shared_attn_every:    # zamba2
        per = cfg.ssm.shared_attn_every  # 1 shared attn + (per-1) mamba
        n_super = cfg.num_layers // per
        tail = cfg.num_layers - n_super * per
        segs = [Segment("zamba", n_super, per)]
        if tail:
            segs.append(Segment("mamba", tail))
        return tuple(segs)
    if cfg.moe is not None:
        segs = []
        kind = "mla_moe" if cfg.mla is not None else "moe"
        dense_kind = "mla_dense" if cfg.mla is not None else "dense"
        if cfg.moe.first_dense_layers:
            segs.append(Segment(dense_kind, cfg.moe.first_dense_layers))
        # a depth cut to the dense prefix (cut_depth) leaves no MoE segment
        if cfg.num_layers > cfg.moe.first_dense_layers:
            segs.append(Segment(kind,
                                cfg.num_layers - cfg.moe.first_dense_layers))
        return tuple(segs)
    return (Segment("dense", cfg.num_layers),)


def cut_depth(cfg: ModelConfig, layers: int) -> ModelConfig:
    """``cfg`` cut to its first ``layers`` layers, widths kept: an MoE
    model's dense prefix is cut too where ``layers`` ends inside it (then
    it has no MoE layer)."""
    if cfg.moe is not None and cfg.moe.first_dense_layers > layers:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, first_dense_layers=layers))
    return dataclasses.replace(cfg, num_layers=layers)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


LM_SHAPES = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def model_flops_per_token(cfg: ModelConfig) -> float:
    """MODEL_FLOPS = 6*N(active)*  — per token, fwd+bwd (roofline §g)."""
    return 6.0 * cfg.active_param_count()


def math_flops_estimate(cfg: ModelConfig, seq: int, batch: int, kind: str) -> float:
    """Analytic useful-FLOPs estimate incl. attention quadratic term."""
    n_act = cfg.active_param_count()
    tokens = seq * batch
    mult = 6.0 if kind == "train" else 2.0
    flops = mult * n_act * tokens
    if not cfg.is_attention_free and cfg.mla is None:
        # QK^T + AV: 2 * 2 * s^2 * hd * heads per example (causal /2)
        att = 2 * 2 * seq * seq * cfg.hd * cfg.num_heads * batch / 2
        flops += att * (3 if kind == "train" else 1)
    return flops
