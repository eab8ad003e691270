"""Gemma 2B [arXiv:2403.08295; hf].

18L, d_model 2048, 8 heads MQA (kv 1), head_dim 256, GeGLU d_ff 16384,
vocab 256000, tied embeddings.  Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab=256000, head_dim=256,
    segments=(("dense", 18),),
    mlp_kind="geglu", tie_embeddings=True,
)
