"""Architecture registry: ``--arch <id>`` -> ModelConfig, for the archs the
port serves.

The port serves the dense attention backbone (``qwen3-8b``).  The other
archs of the JAX package need block kinds, attention variants or configs
that are not ported yet; asking for one raises and names the ROADMAP.md
item that ports it.
"""
from __future__ import annotations

import importlib

_ARCHS = {
    "qwen3-8b": "qwen3_8b",
}

#: archs of the JAX package that the port does not serve yet, with what
#: they still need (ROADMAP.md, queue 1, items 9 and 10).
_NOT_PORTED = {
    "deepseek-moe-16b": "the moe block kind",
    "mixtral-8x22b": "the moe_swa block kind",
    "xlstm-1.3b": "the mlstm/slstm block kinds",
    "starcoder2-3b": "its config (a dense stack)",
    "minicpm3-4b": "the mla block kind",
    "gemma-2b": "its config (a dense stack)",
    "hubert-xlarge": "the encoder block kind and embeds input",
    "hymba-1.5b": "the hybrid block kinds",
    "qwen2-vl-2b": "M-RoPE",
}


def list_archs() -> list[str]:
    return sorted(_ARCHS)


def get_config(arch: str):
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported to repro_torch yet: it needs "
            f"{_NOT_PORTED[arch]} (ROADMAP.md, queue 1, items 9-10); the "
            f"port serves {list_archs()}")
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")
    return mod.CONFIG
