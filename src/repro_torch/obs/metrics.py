"""Bounded log-bucket latency histogram (the port's copy of
``repro/obs/metrics.py::LogBucketHistogram``).

4 buckets per decade across 1 ns .. 1000 s plus exact running count, sum,
min and max: memory is O(#buckets) whatever the sample count, p100 and the
mean are exact, and p50/p99/p99.9 are interpolated within the owning
bucket (within one bucket of the exact sample quantile).
"""
from __future__ import annotations

import math

import numpy as np

#: 4 buckets/decade, 1 ns .. 1000 s (the JAX package's edges, so report
#: shapes stay comparable).
BUCKET_EDGES_S = np.logspace(-9, 3, 49)


class LogBucketHistogram:
    """Bounded-memory latency histogram with exact extremes."""

    __slots__ = ("counts", "count", "total", "min", "max", "_edges")

    def __init__(self, edges: np.ndarray = BUCKET_EDGES_S):
        self._edges = np.asarray(edges, dtype=np.float64)
        self.counts = np.zeros(len(self._edges) - 1, dtype=np.int64)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0

    def add(self, x: float) -> None:
        i = int(np.searchsorted(self._edges, x, side="right")) - 1
        i = min(max(i, 0), len(self.counts) - 1)  # clamp, never drop
        self.counts[i] += 1
        self.count += 1
        self.total += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x

    def add_many(self, xs) -> None:
        xs = np.asarray(xs, dtype=np.float64)
        if xs.size == 0:
            return
        idx = np.clip(np.searchsorted(self._edges, xs, side="right") - 1,
                      0, len(self.counts) - 1)
        np.add.at(self.counts, idx, 1)
        self.count += int(xs.size)
        self.total += float(xs.sum())
        self.min = min(self.min, float(xs.min()))
        self.max = max(self.max, float(xs.max()))

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile; exact at q=0 and q=1."""
        if self.count == 0:
            return 0.0
        if q <= 0.0:
            return self.min
        if q >= 1.0:
            return self.max
        rank = q * (self.count - 1)
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c > rank:
                # linear interpolation inside the bucket, clamped to the
                # exact extremes so p-anything never exceeds the true max
                lo, hi = self._edges[i], self._edges[i + 1]
                frac = (rank - cum) / c
                v = lo + frac * (hi - lo)
                return float(min(max(v, self.min), self.max))
            cum += c
        return self.max

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> dict:
        """JSON block: count/mean/p50/p99/p999/p100 and the buckets."""
        if self.count == 0:
            return {"count": 0, "mean_s": 0.0, "p50_s": 0.0, "p99_s": 0.0,
                    "p999_s": 0.0, "p100_s": 0.0,
                    "bucket_edges_s": [float(e) for e in self._edges],
                    "bucket_counts": [0] * len(self.counts)}
        return {
            "count": int(self.count),
            "mean_s": float(self.mean),
            "p50_s": self.quantile(0.50),
            "p99_s": self.quantile(0.99),
            "p999_s": self.quantile(0.999),
            "p100_s": float(self.max),
            "bucket_edges_s": [float(e) for e in self._edges],
            "bucket_counts": [int(c) for c in self.counts],
        }
