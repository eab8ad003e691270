"""index.backpressure_units_per_batch: NBTreeIndex.units_done gained inside
apply (the insert path's own maintenance), over the window's write batches."""


def read(obs):
    bp = obs.backpressure_units
    if bp is None or not len(bp) or not obs.total("insert", "update"):
        return None
    return float(bp.sum()) / len(bp)
