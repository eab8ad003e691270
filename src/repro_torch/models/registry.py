"""Architecture registry: ``--arch <id>`` -> ModelConfig, for the archs the
port serves.

The port serves every arch whose decode state is a KV cache: the dense
backbones (qwen3-8b, gemma-2b, starcoder2-3b), MoE (deepseek-moe-16b,
mixtral-8x22b, whose layers are sliding-window) and MLA (minicpm3-4b).
The other archs of the JAX package need block kinds or attention
variants that are not ported yet; asking for one raises and names the
ROADMAP.md item that ports it.
"""
from __future__ import annotations

import importlib

_ARCHS = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x22b": "mixtral_8x22b",
    "starcoder2-3b": "starcoder2_3b",
    "minicpm3-4b": "minicpm3_4b",
    "qwen3-8b": "qwen3_8b",
    "gemma-2b": "gemma_2b",
}

#: archs of the JAX package that the port does not serve yet: what they
#: still need and the ROADMAP.md item (queue 1) that ports it.
_NOT_PORTED = {
    "xlstm-1.3b": ("the mlstm/slstm block kinds", "9e"),
    "hymba-1.5b": ("the hybrid block kinds", "9f"),
    "hubert-xlarge": ("the encoder block kind and embeds input", "9g"),
    "qwen2-vl-2b": ("M-RoPE", "10"),
}


def list_archs() -> list[str]:
    return sorted(_ARCHS)


def get_config(arch: str):
    if arch in _NOT_PORTED:
        needs, item = _NOT_PORTED[arch]
        raise NotImplementedError(
            f"{arch!r} is not ported to repro_torch yet: it needs {needs} "
            f"(ROADMAP.md, queue 1, item {item}); the port serves "
            f"{list_archs()}")
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")
    return mod.CONFIG
