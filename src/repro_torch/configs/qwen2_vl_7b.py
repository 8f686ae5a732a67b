"""Assigned architecture config (see assignment sheet for source)."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig  # noqa: F401

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, rope_theta=1000000.0,
    mrope_sections=(16, 24, 24), frontend="vision_patches",
)

QWEN2_VL_7B = CONFIG
