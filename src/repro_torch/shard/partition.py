"""Key-space partitioners of the sharded layer (DESIGN.md §6); the port's
copy of ``repro/shard/partition.py``.

A partitioner maps every key to exactly one shard id and every inclusive
range ``[lo, hi]`` to the set of shards it may touch.  Two strategies:

* :class:`RangePartitioner` — contiguous key intervals separated by sorted
  pivots, shard ``i`` serving ``[pivot[i-1], pivot[i])`` (the first/last
  intervals are open toward 0 / key-max).  Pivots are sampled as quantiles
  of the first observed insert keys (:meth:`RangePartitioner.from_sample`),
  so the initial split mirrors the ingest distribution; skew that develops
  later is fixed by :meth:`split` (hot-shard splitting — the engine decides
  *when*, the partitioner implements *where*).  Range ops touch only the
  shards whose intervals intersect, which is what keeps the sharded range
  fan-out narrow.
* :class:`HashPartitioner` — splitmix64-scattered modulo placement.  Ideal
  balance under any key distribution, but every range op must fan out to
  all shards and the layout cannot be rebalanced (``can_split`` is False).

Both are pure routing tables: no engine state, no I/O cost — which is what
makes them unit-testable in isolation and reusable by the driver and the
scaling benchmark.
"""
from __future__ import annotations

import numpy as np

from ..core.sorted_run import KEY_DTYPE
from ..core.splitmix import splitmix64 as _splitmix64


class RangePartitioner:
    """Sorted-pivot range partitioning with dynamic shard splitting."""

    can_split = True

    def __init__(self, pivots):
        self.pivots = np.asarray(sorted(int(p) for p in pivots), KEY_DTYPE)
        assert len(np.unique(self.pivots)) == len(self.pivots), \
            "pivots must be distinct"

    @staticmethod
    def from_sample(keys, n_shards: int) -> "RangePartitioner":
        """Quantile pivots from a key sample; duplicates collapse, so the
        effective shard count is ``len(pivots) + 1 <= n_shards``."""
        assert n_shards >= 1
        keys = np.unique(np.asarray(keys, KEY_DTYPE))
        if n_shards == 1 or len(keys) < 2:
            return RangePartitioner([])
        qs = (np.arange(1, n_shards) * len(keys)) // n_shards
        return RangePartitioner(np.unique(keys[np.minimum(qs, len(keys) - 1)]))

    @staticmethod
    def even(n_shards: int, key_hi: int) -> "RangePartitioner":
        """Evenly spaced pivots over ``[0, key_hi)`` — the distribution-free
        bootstrap the replication layer uses when no preload sample exists
        (replica groups need their key intervals before the first batch)."""
        assert n_shards >= 1 and key_hi >= n_shards
        return RangePartitioner(sorted({(i * key_hi) // n_shards
                                        for i in range(1, n_shards)}))

    @property
    def n_shards(self) -> int:
        return len(self.pivots) + 1

    def shard_of(self, keys) -> np.ndarray:
        """Vectorized key -> shard id (#pivots <= key)."""
        keys = np.asarray(keys, KEY_DTYPE)
        return np.searchsorted(self.pivots, keys, side="right")

    def shards_for_range(self, lo: int, hi: int) -> range:
        """Ids of every shard whose interval intersects ``[lo, hi]``."""
        if lo > hi:
            return range(0)
        s0 = int(np.searchsorted(self.pivots, np.uint64(lo), side="right"))
        s1 = int(np.searchsorted(self.pivots, np.uint64(hi), side="right"))
        return range(s0, s1 + 1)

    def interval(self, sid: int) -> tuple[int, int]:
        """Shard ``sid``'s inclusive key interval ``[lo, hi]``."""
        lo = 0 if sid == 0 else int(self.pivots[sid - 1])
        hi = (int(np.iinfo(KEY_DTYPE).max) if sid == len(self.pivots)
              else int(self.pivots[sid]) - 1)
        return lo, hi

    def split(self, sid: int, new_pivot: int) -> None:
        """Split shard ``sid`` at ``new_pivot``: keys ``< new_pivot`` stay in
        ``sid``, keys ``>= new_pivot`` move to the new shard ``sid + 1``."""
        lo, hi = self.interval(sid)
        assert lo < new_pivot <= hi, (lo, new_pivot, hi)
        self.pivots = np.insert(self.pivots, sid, np.uint64(new_pivot))


class HashPartitioner:
    """Splitmix64-scattered modulo placement (static, range-oblivious)."""

    can_split = False

    def __init__(self, n_shards: int):
        assert n_shards >= 1
        self._n = int(n_shards)

    @property
    def n_shards(self) -> int:
        return self._n

    def shard_of(self, keys) -> np.ndarray:
        keys = np.asarray(keys, KEY_DTYPE)
        return (_splitmix64(keys) % np.uint64(self._n)).astype(np.int64)

    def shards_for_range(self, lo: int, hi: int) -> range:
        return range(0) if lo > hi else range(self._n)
