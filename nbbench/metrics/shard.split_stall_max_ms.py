"""shard.split_stall_max_ms: the longest hot-shard split in the window, by
the ensemble's complete shard_split spans (drain, extraction and re-insert
of the hot shard's pairs, inside one maintain(1)).  Nothing when the window
held no split or the tracer dropped events."""
from nbbench.spans import complete, window_spans


def read(obs):
    found = window_spans(obs)
    if found is None or obs.dropped_events or not found[1]:
        return None
    events, phases = found
    lo, hi = phases[0][0] * 1e6, phases[-1][2] * 1e6
    durs = [e["dur"] for e in complete(events, "split")
            if e["cat"] == "shard_split" and lo <= e["ts"] < hi]
    return max(durs) / 1e3 if durs else None
