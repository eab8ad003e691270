"""served_batch_p99_ms: the 99th percentile (nearest rank) over the window's
batches of the time from issuing a batch to its answers on the host, plus
its maintain(1)."""
from nbbench.stats import nearest_rank


def read(obs):
    return nearest_rank(obs.iter_s, 0.99) * 1e3
