"""DeepSeek-MoE 16B [arXiv:2401.06066; hf].

28L, d_model 2048, 16 heads (kv 16 = MHA), fine-grained MoE: 64 routed
experts (d_expert 1408) top-6 + 2 shared experts; layer 0 is a dense MLP
(d_ff 10944) per the released config.  Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab=102400,
    segments=(("dense", 1), ("moe", 27)),
    n_experts=64, top_k=6, n_shared_experts=2, d_expert=1408,
    mlp_kind="swiglu", rope_base=10000.0,
)
