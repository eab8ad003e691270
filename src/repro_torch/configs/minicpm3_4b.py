"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B; hf].

62L, d_model 2560, 40 heads, MLA (q_lora 768, kv_lora 256, nope 64,
rope 32, v 64), d_ff 6400.  Full attention -> long_500k skipped.
"""
from .base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab=73448,
    segments=(("mla", 62),),
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    mlp_kind="swiglu", tie_embeddings=True,
)
