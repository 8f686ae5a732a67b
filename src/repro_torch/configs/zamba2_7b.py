"""Assigned architecture config (see assignment sheet for source)."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig  # noqa: F401

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, conv_kernel=4,
                  chunk=64, shared_attn_every=6),
)

ZAMBA2_7B = CONFIG
