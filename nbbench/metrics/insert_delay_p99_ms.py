"""insert_delay_p99_ms: the 99th percentile (nearest rank) over the window's
iterations, each one batch of writes, of apply (backpressure units and table
growth inside it) plus its maintain(1)."""
from nbbench.stats import nearest_rank


def read(obs):
    if not obs.total("insert", "update"):
        return None
    return nearest_rank(obs.iter_s, 0.99) * 1e3
