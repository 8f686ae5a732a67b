"""Architecture registry: the ten assigned archs + the paper's GPT M1..M4.

Canonical definitions live in one ``configs/<id>.py`` file per architecture.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.dbrx_132b import CONFIG as DBRX_132B
from repro_torch.configs.deepseek_v3_671b import CONFIG as DEEPSEEK_V3_671B
from repro_torch.configs.gemma2_2b import CONFIG as GEMMA2_2B
from repro_torch.configs.llama3_8b import CONFIG as LLAMA3_8B
from repro_torch.configs.musicgen_medium import CONFIG as MUSICGEN_MEDIUM
from repro_torch.configs.qwen1_5_0_5b import CONFIG as QWEN1_5_0_5B
from repro_torch.configs.qwen2_vl_7b import CONFIG as QWEN2_VL_7B
from repro_torch.configs.qwen3_8b import CONFIG as QWEN3_8B
from repro_torch.configs.xlstm_1_3b import CONFIG as XLSTM_1_3B
from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2_7B


def gpt_paper_model(hidden: int, heads: int, layers: int = 4) -> ModelConfig:
    """Paper Table 2 evaluation models (GPT layers, fp16->bf16)."""
    return ModelConfig(
        name=f"gpt-h{hidden}", family="dense",
        num_layers=layers, d_model=hidden, num_heads=heads, num_kv_heads=heads,
        d_ff=4 * hidden, vocab_size=51200, mlp_kind="gelu",
        norm_kind="layernorm", use_rope=False,
    )


GPT_M1 = gpt_paper_model(2048, 16)
GPT_M2 = gpt_paper_model(4096, 32)
GPT_M3 = gpt_paper_model(8192, 64)
GPT_M4 = gpt_paper_model(12288, 96)

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        DEEPSEEK_V3_671B, DBRX_132B, LLAMA3_8B, QWEN1_5_0_5B, QWEN3_8B,
        GEMMA2_2B, MUSICGEN_MEDIUM, QWEN2_VL_7B, ZAMBA2_7B, XLSTM_1_3B,
    )
}

PAPER_MODELS = {"gpt-m1": GPT_M1, "gpt-m2": GPT_M2, "gpt-m3": GPT_M3, "gpt-m4": GPT_M4}


def get_config(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in PAPER_MODELS:
        return PAPER_MODELS[name]
    raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS) + sorted(PAPER_MODELS)}")
