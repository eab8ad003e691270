"""Structured event tracer emitting Chrome ``trace_event`` JSON (the port's
copy of ``repro/obs/trace.py``).

Spans use the Trace Event Format's "X" (complete) and "i" (instant)
phases with microsecond timestamps, wrapped in ``{"traceEvents": [...]}``
— the object form Perfetto and ``chrome://tracing`` both load directly.
Memory is a bounded ring buffer (``collections.deque(maxlen=...)``): a
multi-hour run keeps the most recent ``capacity`` events instead of
growing without bound, and ``dropped_events`` records how many fell off
the head so a truncated trace is never mistaken for a complete one.

The tracer is clock-agnostic: callers pass explicit timestamps in
*seconds* on whichever clock owns the component (sim seconds in the
ingest frontends, wall seconds in the device engine), so sim-tier traces
are byte-deterministic.  There is no global "now" — determinism would die
the moment a span implicitly read ``time.time()``.

Span categories are a closed vocabulary (:data:`SPAN_CATEGORIES`) so the
stall attributor and trace consumers can rely on the set.
"""
from __future__ import annotations

import collections
import json

#: Closed span-category vocabulary.  ``pid`` in the emitted JSON is the
#: category's index here, giving each category its own named process row
#: in Perfetto's timeline without per-event metadata lookups.
SPAN_CATEGORIES = (
    "commit",          # group-commit service (admission -> applied)
    "wal_fsync",       # WAL append + fsync barrier
    "flush_unit",      # one device-side maintenance unit (flush/split)
    "cascade",         # emptying-cascade maintenance budget within a step
    "shard_split",     # ensemble shard split (instant)
    "checkpoint",      # LSN-keyed snapshot write
    "recovery",        # WAL replay at startup
    "shed",            # admission-queue overflow drop (instant)
    "tenant_throttle", # DRR deferral of a backlogged tenant (instant)
    "dispatch",        # one host->device kernel dispatch (device tier)
    "chaos",           # injected fault event (instant; wal.faults)
    "failover",        # primary death -> writes restored (replication)
    "catchup",         # replica rebuild: snapshot ship + WAL tail replay
)

_CAT_INDEX = {c: i for i, c in enumerate(SPAN_CATEGORIES)}


class Tracer:
    """Bounded ring-buffer span recorder.

    All times are seconds; the emitted JSON converts to the format's
    microseconds.  ``enabled=False`` turns every method into an immediate
    no-op so a disabled tracer can be threaded unconditionally.
    """

    def __init__(self, capacity: int = 1 << 16, *, enabled: bool = True):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._events: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._seen = 0  # total events ever recorded (>= len(_events))

    # -- recording ---------------------------------------------------------
    def complete(self, cat: str, name: str, t0_s: float, dur_s: float,
                 **args) -> None:
        """Record a completed span [t0_s, t0_s + dur_s)."""
        if not self.enabled:
            return
        ev = {"ph": "X", "cat": cat, "name": name,
              "pid": _CAT_INDEX.get(cat, len(SPAN_CATEGORIES)), "tid": 0,
              "ts": round(t0_s * 1e6, 3), "dur": round(dur_s * 1e6, 3)}
        if args:
            ev["args"] = args
        self._events.append(ev)
        self._seen += 1

    def instant(self, cat: str, name: str, t_s: float, **args) -> None:
        """Record a zero-duration event at ``t_s``."""
        if not self.enabled:
            return
        ev = {"ph": "i", "cat": cat, "name": name,
              "pid": _CAT_INDEX.get(cat, len(SPAN_CATEGORIES)), "tid": 0,
              "ts": round(t_s * 1e6, 3), "s": "g"}
        if args:
            ev["args"] = args
        self._events.append(ev)
        self._seen += 1

    # -- reading -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    @property
    def dropped_events(self) -> int:
        return self._seen - len(self._events)

    def events(self) -> list[dict]:
        """Snapshot of buffered events, oldest first."""
        return list(self._events)

    def spans(self, cat: str | None = None) -> list[dict]:
        """Complete ("X") spans, optionally filtered by category."""
        return [e for e in self._events
                if e["ph"] == "X" and (cat is None or e["cat"] == cat)]

    def categories(self) -> set[str]:
        return {e["cat"] for e in self._events}

    def to_chrome(self) -> dict:
        """Chrome trace_event JSON object (Perfetto-loadable)."""
        meta = [
            {"ph": "M", "name": "process_name", "pid": i, "tid": 0,
             "args": {"name": cat}}
            for i, cat in enumerate(SPAN_CATEGORIES)
        ]
        return {
            "traceEvents": meta + list(self._events),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped_events,
                          "capacity": self.capacity},
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=None,
                      separators=(",", ":"))

    def clear(self) -> None:
        self._events.clear()
        self._seen = 0


def validate_chrome_trace(obj: dict) -> list[str]:
    """Return a list of schema violations (empty = valid).

    Checks the subset of the Trace Event Format that Perfetto's JSON
    importer requires: a ``traceEvents`` array whose entries carry a
    ``ph`` and, for X/i phases, numeric ``ts`` (and ``dur`` for X).
    """
    errs = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["missing traceEvents array"]
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        return ["traceEvents is not a list"]
    for i, e in enumerate(evs):
        if not isinstance(e, dict) or "ph" not in e:
            errs.append(f"event {i}: missing ph")
            continue
        ph = e["ph"]
        if ph in ("X", "i"):
            if not isinstance(e.get("ts"), (int, float)):
                errs.append(f"event {i}: non-numeric ts")
            if not isinstance(e.get("name"), str):
                errs.append(f"event {i}: missing name")
        if ph == "X" and not isinstance(e.get("dur"), (int, float)):
            errs.append(f"event {i}: X span without numeric dur")
        if ph == "i" and e.get("s") not in ("g", "p", "t", None):
            errs.append(f"event {i}: bad instant scope {e.get('s')!r}")
    return errs
