"""Windowed metrics: log-bucket histograms and fixed-width timelines (the
port's copy of ``repro/obs/metrics.py``).

:class:`LogBucketHistogram`: 4 buckets per decade across 1 ns .. 1000 s
plus exact running count, sum, min and max.  Memory is O(#buckets)
whatever the sample count; p100 and the mean are exact, and p50/p99/p99.9
are interpolated within the owning bucket (within one bucket of the exact
sample quantile).  The closed-loop driver's per-kind histograms and the
device engine's maintain-unit times use it.

:class:`WindowedMetrics` turns per-commit observations into fixed-width
timeline rows on the frontend's clock: ops/s, p50/p99/p99.9, queue-depth
and maintenance-debt gauges per window.  Windows close deterministically (a
clock jump emits the empty windows it skips), so on a sim clock a timeline
is a pure function of (trace, engine config).

:class:`ObsConfig` switches the layer on for a frontend; off, every hook is
one attribute check.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .stall import detect_stalls

#: 4 buckets/decade, 1 ns .. 1000 s: the JAX package's edges (and
#: ``ingest.slo.BUCKET_EDGES_S``), so report shapes stay comparable.
BUCKET_EDGES_S = np.logspace(-9, 3, 49)

#: A window whose p99 exceeds ``stall_k`` x the trailing-median p99 is a
#: stall window (see obs/stall.py).
DEFAULT_STALL_K = 4.0


@dataclasses.dataclass
class ObsConfig:
    """Observability switches threaded through frontends and engines.

    Default-off: every hot-path hook is behind ``if obs is None`` (or an
    equivalent attribute check), so timings are untouched unless a caller
    opts in.
    """

    enabled: bool = True
    #: fixed window width on the owning clock (sim seconds for cost-model
    #: tiers, wall seconds for the device tier)
    window_s: float = 1.0
    #: write Chrome trace_event JSON here at end of run (None = keep the
    #: ring buffer in memory only)
    trace_path: str | None = None
    #: ring-buffer capacity, in events; oldest spans are dropped first
    trace_capacity: int = 1 << 16
    #: stalled-window threshold multiplier over the trailing-median p99
    stall_k: float = DEFAULT_STALL_K
    #: windows of history for the trailing median
    stall_trailing: int = 16


class LogBucketHistogram:
    """Bounded-memory latency histogram with exact extremes.

    ``summary()`` has the JSON shape of ``slo._tail_summary``
    (count/mean/p50/p99/p999/p100/bucket edges+counts).
    """

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

    def merge(self, other: "LogBucketHistogram") -> None:
        self.counts += other.counts
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

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
        """JSON block shaped like ``slo._tail_summary``."""
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

    def reset(self) -> None:
        self.counts[:] = 0
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0


class WindowedMetrics:
    """Fixed-width timeline rollover on an externally supplied clock.

    Feed it per-commit observations via :meth:`record`; it closes windows
    whenever the clock crosses a window boundary, including emitting the
    empty windows a clock jump skips over (an idle second is a real
    second of the timeline — dropping it would hide stalls).  ``finish``
    flushes the trailing partial window and computes run-level scores:

    * **stall-free %** — share of non-empty windows whose p99 stays under
      ``stall_k`` x the trailing-median p99 (obs/stall.py's detector);
    * **fluctuation score** — coefficient of variation (std/mean) of
      per-window throughput over non-empty windows: 0 is perfectly
      flat, a saw-tooth pushes it up.
    """

    def __init__(self, window_s: float = 1.0, *, t0: float = 0.0,
                 stall_k: float = DEFAULT_STALL_K, stall_trailing: int = 16):
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        self.window_s = float(window_s)
        self.stall_k = float(stall_k)
        self.stall_trailing = int(stall_trailing)
        self._t0 = float(t0)
        self._win = 0          # index of the currently open window
        self._ops = 0
        self._hist = LogBucketHistogram()
        self._queue_peak = 0
        self._debt_peak = 0
        self._shed = 0
        self.windows: list[dict] = []

    # -- feeding -----------------------------------------------------------
    def _win_of(self, t: float) -> int:
        return int((t - self._t0) / self.window_s)

    def _close_through(self, win: int) -> None:
        """Close every window strictly before ``win`` (emitting empties)."""
        while self._win < win:
            self._emit()
            self._win += 1

    def _emit(self) -> None:
        h = self._hist
        w = {
            "t_start_s": self._t0 + self._win * self.window_s,
            "t_end_s": self._t0 + (self._win + 1) * self.window_s,
            "ops": int(self._ops),
            "ops_per_s": self._ops / self.window_s,
            "p50_s": h.quantile(0.50),
            "p99_s": h.quantile(0.99),
            "p999_s": h.quantile(0.999),
            "p100_s": float(h.max) if h.count else 0.0,
            "queue_peak": int(self._queue_peak),
            "debt_peak": int(self._debt_peak),
            "shed": int(self._shed),
        }
        self.windows.append(w)
        self._ops = 0
        self._hist.reset()
        self._queue_peak = 0
        self._debt_peak = 0
        self._shed = 0

    def record(self, t: float, latency_s, *, ops: int = 1,
               queue_depth: int = 0, debt: int = 0) -> None:
        """Record ``ops`` operations completing at sim time ``t``.

        ``latency_s`` may be a scalar or an array of per-op latencies.
        """
        self._close_through(self._win_of(t))
        self._ops += int(ops)
        if np.ndim(latency_s) == 0:
            self._hist.add(float(latency_s))
        else:
            self._hist.add_many(latency_s)
        if queue_depth > self._queue_peak:
            self._queue_peak = int(queue_depth)
        if debt > self._debt_peak:
            self._debt_peak = int(debt)

    def record_shed(self, t: float, n: int = 1) -> None:
        self._close_through(self._win_of(t))
        self._shed += int(n)

    # -- finishing ---------------------------------------------------------
    def finish(self, t_end: float | None = None) -> dict:
        """Close out the timeline and return the summary block.

        ``t_end`` extends the timeline with trailing empty windows up to
        that instant (e.g. the drain-complete time).
        """
        if t_end is not None:
            self._close_through(self._win_of(t_end))
        # flush the open (possibly partial) window if it saw anything
        if self._ops or self._hist.count or self._shed:
            self._emit()
        return self.summary()

    def summary(self) -> dict:
        active = [w for w in self.windows if w["ops"] > 0]
        n_active = len(active)
        stalled = detect_stalls(self.windows, k=self.stall_k,
                                trailing=self.stall_trailing)
        rates = np.asarray([w["ops_per_s"] for w in active], dtype=np.float64)
        if n_active >= 2 and rates.mean() > 0:
            fluctuation = float(rates.std() / rates.mean())
        else:
            fluctuation = 0.0
        stall_free_pct = (100.0 * (1.0 - len(stalled) / n_active)
                          if n_active else 100.0)
        return {
            "window_s": self.window_s,
            "n_windows": len(self.windows),
            "n_active_windows": n_active,
            "stall_k": self.stall_k,
            "stalled_windows": [w["index"] for w in stalled],
            "stall_free_pct": stall_free_pct,
            "fluctuation_score": fluctuation,
            "timeline": self.windows,
        }
