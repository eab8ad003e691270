"""Hymba 1.5B [arXiv:2411.13676; hf].

32L, d_model 1600, 25 heads GQA kv 5, d_ff 5504, parallel attention+SSM
heads per block (ssm_state 16); full (global) attention at layers
{0, 15, 31}, SWA elsewhere — expressed exactly by the segment list.
Hybrid -> long_500k runs (ring KV for SWA + O(1) SSM state).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, head_dim=64,
    segments=(("hybrid_global", 1), ("hybrid", 14),
              ("hybrid_global", 1), ("hybrid", 15),
              ("hybrid_global", 1)),
    swa_window=1024, ssm_state=16, ssm_expand=2,
    mlp_kind="swiglu",
)
