"""splitmix64 finalizer (vectorized, uint64 wraparound arithmetic).

The port's own copy of ``repro/core/splitmix.py``: the workload generator
scatters zipfian ranks over the key space with it, and must reproduce the
JAX package's streams bit for bit.
"""
from __future__ import annotations

import numpy as np


def splitmix64(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x).astype(np.uint64)
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))
