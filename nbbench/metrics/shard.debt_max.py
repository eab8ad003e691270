"""shard.debt_max: the largest ensemble debt (pending maintenance units over
all shards) that maintain(1) returned in the window; a sharded engine only."""


def read(obs):
    if not obs.sharded or not len(obs.debts):
        return None
    return float(obs.debts.max())
