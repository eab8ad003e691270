"""Qwen2-VL 2B [arXiv:2409.12191; hf] — transformer BACKBONE only.

28L, d_model 1536, 12 heads GQA kv 2, d_ff 8960, M-RoPE with (t, h, w)
sections (16, 24, 24) over the 64 rotary pairs of head_dim 128.  The
vision patch frontend is a STUB: input_specs provide patch embeddings.
Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, head_dim=128,
    segments=(("dense", 28),),
    mrope_sections=(16, 24, 24), mlp_kind="swiglu",
    tie_embeddings=True, rope_base=1000000.0,
)
