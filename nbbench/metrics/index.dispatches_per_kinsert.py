"""index.dispatches_per_kinsert: index impl calls (dispatch_count, every shard
the window used) gained in the window, per thousand writes."""


def read(obs):
    writes = obs.total("insert", "update")
    if not obs.counters or not writes:
        return None
    return obs.counters["device_dispatches"] * 1e3 / writes
