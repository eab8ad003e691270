"""Per-kind SLO accounting for the open-loop ingest frontend (the port's copy
of ``repro/ingest/slo.py``).

End-to-end latency (queueing + service), queue occupancy, shed (admission
rejection) counters and stall attribution are recorded per op kind while
:class:`~repro_torch.ingest.frontend.IngestFrontend` runs, then summarized into a
JSON-ready report.

Stall attribution: the frontend snapshots the engine's pending maintenance
debt (``maintain(0)``) at every commit.  A commit whose *service* time
exceeds ``stall_factor`` times the run's typical commit service time (the
larger of the median and the mean — buffered writes make the median
degenerate to ~0 between avalanches) is a *stall* — the open-loop
signature of a compaction avalanche — and the ops
queued behind it at that moment are the ops whose latency it explains.
The factor is a per-run knob (``FrontendConfig.stall_factor``; module
default :data:`STALL_FACTOR`) and the value used is recorded in the
report's ``stalls`` section, so sweeps run at different thresholds stay
self-describing.
``debt_max`` over the same timeline is the deamortization ledger: a
deamortized engine's debt stays at its per-step bound (0/1 for the refimpl
NB-tree) no matter the offered load, while its queue may still grow; an
amortized engine shows no debt at all because it pays the whole avalanche
synchronously inside one service time.

Percentiles are exact (computed from retained raw samples, not bucket
edges); p99.9 is included because open-loop tails are the whole point.
"""
from __future__ import annotations

import numpy as np

#: default stall threshold: a commit is a "stall" when its service time
#: exceeds this multiple of the run's typical commit service time —
#: max(median, mean), post-hoc, so the threshold is deterministic and
#: scale-free across tiers/devices.  Per-run override:
#: ``FrontendConfig.stall_factor`` -> ``SLOTracker(stall_factor=...)``.
STALL_FACTOR = 8.0

#: log-spaced bucket edges, 1 ns .. ~1000 s, 4 buckets/decade (JSON-sized).
BUCKET_EDGES_S = np.logspace(-9, 3, 49)


def _tail_summary(samples: np.ndarray) -> dict:
    """Exact mean/p50/p99/p99.9/p100 + log-bucket histogram of seconds."""
    a = np.asarray(samples, np.float64)
    if a.size == 0:
        counts = np.zeros(len(BUCKET_EDGES_S) - 1, int)
        pct = {q: 0.0 for q in (50.0, 99.0, 99.9, 100.0)}
        mean = 0.0
    else:
        counts = np.histogram(
            np.clip(a, BUCKET_EDGES_S[0], BUCKET_EDGES_S[-1]),
            BUCKET_EDGES_S)[0]
        pct = {q: float(np.percentile(a, q)) for q in (50.0, 99.0, 99.9, 100.0)}
        mean = float(a.mean())
    return {
        "count": int(a.size),
        "mean_s": mean,
        "p50_s": pct[50.0],
        "p99_s": pct[99.0],
        "p999_s": pct[99.9],
        "p100_s": pct[100.0],
        "bucket_edges_s": [float(e) for e in BUCKET_EDGES_S],
        "bucket_counts": [int(c) for c in counts],
    }


class SLOTracker:
    """Accumulates open-loop measurements; one instance per serving stream.

    The single-stream frontend runs one tracker.
    """

    def __init__(self, kinds: tuple = ("insert", "delete", "query", "range"),
                 *, stall_factor: float = STALL_FACTOR):
        assert stall_factor > 1.0
        self.stall_factor = float(stall_factor)
        self._kinds = kinds
        self._e2e: dict = {k: [] for k in kinds}      # end-to-end seconds
        self._queue_delay: list = []                  # admission -> commit
        self._shed: dict = {k: 0 for k in kinds}
        self._commits: list = []   # (t, n_ops, qdepth, service_s, maintain_s, debt)
        self.max_queue_depth = 0

    # ------------------------------------------------------------- recording
    def record_shed(self, kind: str, n: int = 1) -> None:
        self._shed[kind] += int(n)

    def record_queue_depth(self, depth: int) -> None:
        if depth > self.max_queue_depth:
            self.max_queue_depth = int(depth)

    def record_commit(self, *, t_commit: float, kinds, e2e_s, queue_delay_s,
                      qdepth_after: int, service_s: float, maintain_s: float,
                      debt: int) -> None:
        """One group commit: per-op latencies plus the server-side snapshot."""
        for k, lat in zip(kinds, np.asarray(e2e_s, np.float64)):
            self._e2e[k].append(float(lat))
        self._queue_delay.extend(np.asarray(queue_delay_s, np.float64).tolist())
        self._commits.append((float(t_commit), len(kinds), int(qdepth_after),
                              float(service_s), float(maintain_s), int(debt)))

    # ------------------------------------------------------------- reporting
    def report(self, *, offered: dict, t_end: float) -> dict:
        """JSON-ready summary.  ``offered`` maps kind -> ops offered
        (admitted + shed); ``t_end`` is the simulated completion time of the
        last commit (the run's makespan on the open-loop clock)."""
        com = np.asarray(self._commits, np.float64).reshape(-1, 6)
        service_s = com[:, 3] if len(com) else np.zeros(0)
        maintain_s = com[:, 4] if len(com) else np.zeros(0)
        debts = com[:, 5] if len(com) else np.zeros(0)
        qdepths = com[:, 2] if len(com) else np.zeros(0)

        # ---- stall attribution (see module docstring) ---------------------
        med = float(np.median(service_s)) if len(service_s) else 0.0
        typical = max(med, float(service_s.mean())) if len(service_s) else 0.0
        stall_mask = (service_s > self.stall_factor * typical) \
            if typical > 0.0 else np.zeros(len(service_s), bool)
        n_done = int(sum(len(v) for v in self._e2e.values()))
        n_shed = int(sum(self._shed.values()))
        total_busy = float(service_s.sum() + maintain_s.sum())
        return {
            "duration_s": float(t_end),
            "n_offered": int(sum(offered.values())),
            "n_done": n_done,
            "n_shed": n_shed,
            "shed_rate": n_shed / max(1, n_shed + n_done),
            "shed_per_kind": dict(self._shed),
            "offered_per_kind": {k: int(v) for k, v in offered.items()},
            "per_kind_e2e": {k: _tail_summary(v)
                             for k, v in self._e2e.items() if v},
            "queue_delay": _tail_summary(self._queue_delay),
            "queue": {
                "max_depth": int(self.max_queue_depth),
                "mean_depth_at_commit": (float(qdepths.mean())
                                         if len(qdepths) else 0.0),
            },
            "server": {
                "n_commits": int(len(com)),
                "mean_commit_ops": (float(com[:, 1].mean())
                                    if len(com) else 0.0),
                "service_s": float(service_s.sum()),
                "maintain_s": float(maintain_s.sum()),
                "utilization": total_busy / max(t_end, 1e-12),
            },
            "stalls": {
                "stall_factor": self.stall_factor,
                "median_commit_service_s": med,
                "typical_commit_service_s": typical,
                "n_stall_commits": int(stall_mask.sum()),
                "stall_service_s": float(service_s[stall_mask].sum()),
                # ops that were sitting in queue behind a stalled commit —
                # the population whose tail latency the stall explains.
                "ops_queued_behind_stalls": int(qdepths[stall_mask].sum()),
                "debt_max": int(debts.max()) if len(debts) else 0,
                "debt_mean": float(debts.mean()) if len(debts) else 0.0,
            },
        }
