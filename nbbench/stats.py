"""Small statistics the metric readers share."""
from __future__ import annotations

import math

import numpy as np


def nearest_rank(samples, q: float) -> float | None:
    """The ``q``-quantile by nearest rank: the smallest sample with at least
    a share ``q`` of the samples at or below it; None without samples."""
    x = np.sort(np.asarray(samples, np.float64))
    if not len(x):
        return None
    return float(x[max(0, math.ceil(q * len(x)) - 1)])
