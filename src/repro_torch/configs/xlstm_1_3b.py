"""Assigned architecture config (see assignment sheet for source)."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig  # noqa: F401

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    ssm=SSMConfig(d_state=0, expand=2, head_dim=512, chunk=64,
                  slstm_every=8, proj_factor=2.0),
)

XLSTM_1_3B = CONFIG
