"""engine.maintain_unit_p99_ms: the 99th percentile (nearest rank) of the
engine's own flush_unit spans in the window (each maintain unit ends in a
device-to-host read); nothing when the tracer dropped events."""
from nbbench.stats import nearest_rank


def read(obs):
    if not obs.flush_unit_s or obs.dropped_events:
        return None
    return nearest_rank(obs.flush_unit_s, 0.99) * 1e3
