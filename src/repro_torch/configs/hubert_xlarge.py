"""HuBERT X-Large [arXiv:2106.07447; unverified].

48L encoder-only, d_model 1280, 16 heads, d_ff 5120, LayerNorm, gelu.
The conv waveform frontend is a STUB: input_specs provide precomputed
frame embeddings (B, S, d_model).  No decode step (encoder-only) ->
decode_32k / long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab=504,
    segments=(("encoder", 48),),
    encoder_only=True, mlp_kind="gelu", norm_kind="layer",
)
