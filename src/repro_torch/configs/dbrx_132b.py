"""Assigned architecture config (see assignment sheet for source)."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig  # noqa: F401

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352, rope_theta=500000.0,
    norm_kind="layernorm",
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752),
)

DBRX_132B = CONFIG
