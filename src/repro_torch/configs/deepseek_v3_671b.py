"""Assigned architecture config (see assignment sheet for source)."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig  # noqa: F401

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=18432,                   # dense layers (first 3); experts use 2048
    vocab_size=129280, head_dim=192,  # qk_nope(128)+qk_rope(64) for MLA
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared=1, first_dense_layers=3),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    mtp=True,
)

DEEPSEEK_V3_671B = CONFIG
