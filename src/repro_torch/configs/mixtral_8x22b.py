"""Mixtral 8x22B [arXiv:2401.04088; hf].

56L, d_model 6144, 48 heads GQA kv 8, 8 experts top-2 (d_expert 16384),
sliding-window attention (window 4096 per the pool spec) -> SWA rolling
ring-cache makes long_500k decode runnable.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768,
    segments=(("moe_swa", 56),),
    n_experts=8, top_k=2, d_expert=16384,
    swa_window=4096, mlp_kind="swiglu", rope_base=1000000.0,
)
