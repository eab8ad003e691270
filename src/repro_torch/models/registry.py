"""Architecture registry: ``--arch <id>`` -> ModelConfig, for every arch of
the JAX package.

The paged engine (``launch/serve.py``) serves the dense and swa stacks
(qwen3-8b, gemma-2b, starcoder2-3b, qwen2-vl-2b); the MoE, MLA,
recurrent and hybrid stacks decode through ``serve/steps.py``, and the
encoder-only hubert-xlarge runs its ``make_encode_step``.
"""
from __future__ import annotations

import importlib

_ARCHS = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x22b": "mixtral_8x22b",
    "xlstm-1.3b": "xlstm_1_3b",
    "starcoder2-3b": "starcoder2_3b",
    "minicpm3-4b": "minicpm3_4b",
    "qwen3-8b": "qwen3_8b",
    "gemma-2b": "gemma_2b",
    "hubert-xlarge": "hubert_xlarge",
    "hymba-1.5b": "hymba_1_5b",
    "qwen2-vl-2b": "qwen2_vl_2b",
}


def list_archs() -> list[str]:
    return sorted(_ARCHS)


def get_config(arch: str):
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")
    return mod.CONFIG


def all_configs() -> dict:
    """``{arch: ModelConfig}`` for every arch, in ``list_archs`` order."""
    return {a: get_config(a) for a in list_archs()}
