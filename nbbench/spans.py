"""The program's own spans in a traced run, for the readers of
``program_span`` metrics that need more than ``Observation.flush_unit_s``.

A reader gets the tracer's events (``obs.trace_events``) and the window's
per-iteration host stamps ``(a, b, c)`` (``obs.phases``: ``apply`` ran in
``[a, b)``, its ``maintain(1)`` in ``[b, c)``), both in
``time.perf_counter()`` seconds, the clock the program stamps its spans
with.  Where the ``Observation`` does not carry them, they are taken from
the harness's ``Run`` that is reading the metrics: its ``tracer`` and its
window's ``phases``, found as the locals of the caller's frame that holds
this very ``obs``.
"""
from __future__ import annotations

import sys


def window_spans(obs):
    """``(events, phases)`` of a traced run, or None where neither the
    ``Observation`` nor a reading ``Run`` has them."""
    events = getattr(obs, "trace_events", None)
    phases = getattr(obs, "phases", None)
    if events is not None and phases is not None:
        return events, phases
    frame = sys._getframe(1)
    try:
        while frame is not None:
            loc = frame.f_locals
            run, w = loc.get("self"), loc.get("w")
            tracer = getattr(run, "tracer", None)
            if (loc.get("obs") is obs and tracer is not None
                    and isinstance(w, dict) and "phases" in w):
                return tracer.events(), w["phases"]
            frame = frame.f_back
    finally:
        del frame
    return None


def complete(events, name: str) -> list:
    """The complete ("X") spans named ``name``."""
    return [e for e in events if e.get("ph") == "X" and e["name"] == name]
