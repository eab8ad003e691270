"""index.backpressure_ms_p99: the 99th percentile (nearest rank), over the
window's iterations, of the summed durations of the index's
backpressure_unit spans that start inside the iteration's apply (0 where
none does); a split's re-insert runs in maintain and is left out.  Nothing
when the tracer dropped events, or where apply ran units and the program
recorded no such span."""
import numpy as np

from nbbench.spans import complete, window_spans
from nbbench.stats import nearest_rank


def read(obs):
    found = window_spans(obs)
    if found is None or obs.dropped_events or not found[1]:
        return None
    events, phases = found
    spans = complete(events, "backpressure_unit")
    units = obs.backpressure_units
    if not spans and (units is None or units.sum() > 0):
        return None
    starts = np.array([e["ts"] / 1e6 for e in spans], np.float64)
    order = np.argsort(starts, kind="stable")
    starts = starts[order]
    cum = np.concatenate([[0.0], np.cumsum(
        np.array([e["dur"] / 1e6 for e in spans], np.float64)[order])])
    a = np.array([p[0] for p in phases], np.float64)
    b = np.array([p[1] for p in phases], np.float64)
    per = (cum[np.searchsorted(starts, b, "left")]
           - cum[np.searchsorted(starts, a, "left")])
    return nearest_rank(per, 0.99) * 1e3
