"""served_ops_per_s: ops of the mix answered in the window over the window's
wall seconds."""


def read(obs):
    return obs.total("insert", "update", "read", "scan") / obs.window_s
