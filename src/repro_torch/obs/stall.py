"""Stalled-window detection and span-category attribution (the port's copy
of ``repro/obs/stall.py``).

A *stall window* is a timeline window whose p99 latency exceeds ``k``
times the trailing median p99 of the preceding non-empty windows — the
windowed analogue of the per-op ``slo.STALL_FACTOR`` rule, and the form
Luo & Carey use to quantify LSM write-stall behaviour.  The trailing
median (rather than the run-wide median) makes the detector causal: a
diurnal rate swing moves the baseline slowly, while a compaction stall
spikes a window far above its own recent history.

Attribution then answers *why*: for each stalled window, the span
category (from ``obs.trace.SPAN_CATEGORIES``) with the largest total
overlapping duration is the dominant concurrent activity.  On the
NB-tree tier that is typically ``commit`` (service time itself), on a
saw-toothing LSM it is ``cascade`` (a forced multi-level merge), and
after a crash it is ``recovery`` — which is exactly the narrative the
stability figure needs to tell.
"""
from __future__ import annotations

import statistics


def detect_stalls(windows: list[dict], *, k: float = 4.0,
                  trailing: int = 16, min_history: int = 4) -> list[dict]:
    """Return stalled windows as ``[{index, t_start_s, t_end_s, p99_s,
    baseline_p99_s}]``.

    ``windows`` are timeline rows from
    :class:`~repro_torch.obs.metrics.WindowedMetrics` (need ``ops``, ``p99_s``, ``t_start_s``,
    ``t_end_s``).  Empty windows never stall and never enter the
    baseline.  The first ``min_history`` non-empty windows are exempt
    (no meaningful baseline yet).
    """
    out = []
    history: list[float] = []
    for i, w in enumerate(windows):
        if w["ops"] <= 0:
            continue
        if len(history) >= min_history:
            base = statistics.median(history[-trailing:])
            if base > 0 and w["p99_s"] > k * base:
                out.append({"index": i, "t_start_s": w["t_start_s"],
                            "t_end_s": w["t_end_s"], "p99_s": w["p99_s"],
                            "baseline_p99_s": base})
                # a stalled window is excluded from the baseline so a
                # long stall does not normalise itself away
                continue
        history.append(w["p99_s"])
    return out


def _overlap_s(ev: dict, t0_s: float, t1_s: float) -> float:
    """Seconds of an X-span event overlapping [t0_s, t1_s)."""
    s0 = ev["ts"] / 1e6
    s1 = s0 + ev.get("dur", 0.0) / 1e6
    return max(0.0, min(s1, t1_s) - max(s0, t0_s))


def attribute_stalls(stalls: list[dict], events: list[dict]) -> list[dict]:
    """Annotate each stall with its dominant concurrent span category.

    ``events`` are Chrome trace events (e.g. ``Tracer.events()``); only
    complete ("X") spans participate.  Each stall gains ``cause`` (the
    category with the most overlapping busy time, or ``"unknown"`` when
    no span overlaps) and ``cause_overlap_s`` breakdowns.
    """
    xs = [e for e in events if e.get("ph") == "X"]
    out = []
    for st in stalls:
        t0, t1 = st["t_start_s"], st["t_end_s"]
        by_cat: dict[str, float] = {}
        for e in xs:
            ov = _overlap_s(e, t0, t1)
            if ov > 0.0:
                by_cat[e["cat"]] = by_cat.get(e["cat"], 0.0) + ov
        if by_cat:
            # deterministic tie-break: largest overlap, then category name
            cause = max(sorted(by_cat), key=lambda c: by_cat[c])
        else:
            cause = "unknown"
        out.append({**st, "cause": cause,
                    "cause_overlap_s": {c: round(v, 9)
                                        for c, v in sorted(by_cat.items())}})
    return out
