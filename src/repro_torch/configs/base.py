"""Model / run configuration dataclasses (a copy of the JAX package's).

One ``ModelConfig`` instance per architecture the port serves lives in
``repro_torch/configs/<arch>.py``; reduced variants for CPU tests come from
:func:`ModelConfig.reduced`.

``segments`` describes the layer stack as (block_kind, count) groups.  The
JAX package runs each group as one ``lax.scan`` over stacked parameters;
the port keeps the same description and runs one module per layer
(``models/transformer.py``).  ``BLOCK_KINDS`` lists every kind the
reference knows; ``models/registry.py`` lists the archs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

Segments = Tuple[Tuple[str, int], ...]

#: block kinds of the JAX package (the port runs every one)
BLOCK_KINDS = (
    "dense",          # full causal attention + MLP
    "swa",            # sliding-window attention + MLP
    "moe",            # full attention + MoE MLP
    "moe_swa",        # sliding-window attention + MoE MLP
    "mla",            # multi-head latent attention + MLP
    "encoder",        # bidirectional attention + MLP (no causal mask)
    "mlstm",          # xLSTM matrix-memory block (self-contained)
    "slstm",          # xLSTM scalar-memory block (self-contained)
    "hybrid",         # hymba: parallel SWA-attention + SSM heads, + MLP
    "hybrid_global",  # hymba: parallel full-attention + SSM heads, + MLP
)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    segments: Segments
    head_dim: Optional[int] = None          # defaults to d_model // n_heads
    # attention
    qk_norm: bool = False
    swa_window: int = 4096
    rope_base: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    encoder_only: bool = False
    # mlp
    mlp_kind: str = "swiglu"                # swiglu | geglu | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: Optional[int] = None
    capacity_factor: float = 1.25
    # MLA
    mla: Optional[MLAConfig] = None
    # SSM
    ssm_state: int = 16
    ssm_expand: int = 2
    conv_width: int = 4
    # misc
    norm_kind: str = "rms"                  # rms | layer
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "layer"                    # none | layer | full
    kv_cache_dtype: str = "model"           # model | int8 (quantized decode KV)

    def __post_init__(self):
        assert sum(c for _, c in self.segments) == self.n_layers, (
            f"{self.name}: segments {self.segments} != n_layers {self.n_layers}")
        for kind, _ in self.segments:
            assert kind in BLOCK_KINDS, kind

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_recurrent(self) -> bool:
        """True if decode carries recurrent state instead of a growing KV."""
        return all(k in ("mlstm", "slstm") for k, _ in self.segments)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: no block attends to unbounded context...

        SSM/hybrid/SWA stacks qualify; any 'dense'/'moe'/'mla'/'encoder'
        block makes the arch full-attention (skip long_500k, DESIGN.md §6).
        Hymba's 3 global-attention layers are the documented exception: the
        arch is hybrid by design and the pool assigns it long-context duty.
        """
        kinds = {k for k, _ in self.segments}
        full = {"dense", "moe", "mla", "encoder"}
        if self.name.startswith("hymba"):
            return True
        return not (kinds & full)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        scale: dict = dict(
            n_layers=sum(min(c, 2) for _, c in self.segments),
            segments=tuple((k, min(c, 2)) for k, c in self.segments),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            head_dim=32 if self.head_dim else None,
            swa_window=16,
        )
        if self.n_experts:
            scale.update(n_experts=4, top_k=min(self.top_k, 2),
                         d_expert=64 if self.d_expert else None)
        if self.mla is not None:
            scale.update(mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32,
                                       qk_nope_head_dim=16, qk_rope_head_dim=8,
                                       v_head_dim=16))
        if self.mrope_sections is not None:
            scale.update(mrope_sections=(4, 6, 6))
        scale.update(overrides)
        return dataclasses.replace(self, **scale)
