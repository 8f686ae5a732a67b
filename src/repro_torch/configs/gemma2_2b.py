"""Assigned architecture config (see assignment sheet for source)."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig  # noqa: F401

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4,
    d_ff=9216, vocab_size=256000, head_dim=256,
    mlp_kind="geglu", attn_softcap=50.0, logit_softcap=30.0,
    local_window=4096, local_global_period=2,
    post_block_norms=True, embed_scale=True, tie_embeddings=True,
)

GEMMA2_2B = CONFIG
