"""Assigned input shapes and per-(arch x shape) applicability.

The port's copy of ``repro/configs/shapes.py``.  Four shapes per LM arch:
  train_4k     seq 4096,   global_batch 256  -> the train step
  prefill_32k  seq 32768,  global_batch 32   -> prefill (forward)
  decode_32k   kv 32768,   global_batch 128  -> serve_step (1 token)
  long_500k    kv 524288,  global_batch 1    -> serve_step, sub-quadratic only
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_status(cfg, shape: ShapeSpec) -> str:
    """'run' or a skip reason for an (arch, shape) dry-run cell."""
    if shape.kind == "decode" and cfg.encoder_only:
        return "skip: encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "skip: full-attention arch (needs sub-quadratic attention)"
    return "run"


def all_cells(configs: dict) -> list:
    """All (arch, shape) cells with their status (40 over the registry)."""
    out = []
    for arch, cfg in configs.items():
        for sname, spec in SHAPES.items():
            out.append((arch, sname, cell_status(cfg, spec)))
    return out
