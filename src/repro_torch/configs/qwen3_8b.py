"""Qwen3-8B [hf:Qwen/Qwen3-8B; hf].

36L, d_model 4096, 32 heads GQA kv 8, head_dim 128, qk-norm, d_ff 12288.
Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab=151936, head_dim=128,
    segments=(("dense", 36),),
    qk_norm=True, mlp_kind="swiglu", rope_base=1000000.0,
)
