"""insert_ops_per_s: writes acknowledged in the window over the window's wall
seconds, every maintain(1) of the loop included."""


def read(obs):
    writes = obs.total("insert", "update")
    return writes / obs.window_s if writes else None
