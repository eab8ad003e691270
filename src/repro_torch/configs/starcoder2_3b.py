"""StarCoder2-3B [arXiv:2402.19173; hf].

30L, d_model 3072, 24 heads GQA kv 2, d_ff 12288 (gelu MLP), RoPE.
Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab=49152,
    segments=(("dense", 30),),
    mlp_kind="gelu", rope_base=100000.0, norm_kind="layer",
)
