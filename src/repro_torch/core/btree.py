"""B+-tree baselines (paper Sec. 6.1, algorithms (5)/(6)); the port's copy
of ``repro/core/btree.py``, a host sim-clock tier.

Two variants, matching the paper's experimental setup:

* ``BPlusTreeBulk`` — bottom-up bulk-loaded, all nodes full; the paper's
  query-performance yardstick (``B+-tree(bulk)``).  Internal levels are
  cached in memory, so a point query costs one seek + one leaf page —
  the optimal disk query the paper says NB-trees approach.
* ``BPlusTree`` — incremental inserts; every insert seeks, reads and
  rewrites a leaf page.  This is the variant the paper *excludes* from the
  large experiments because its average insertion time exceeds 100 us; the
  benchmark harness reproduces that exclusion rule.
"""
from __future__ import annotations

import numpy as np

from .cost_model import PAIR_BYTES, CostModel, Device, HDD
from .sorted_run import KEY_DTYPE, TOMBSTONE, VAL_DTYPE


class BPlusTreeBulk:
    """Bulk-loaded B+-tree over a static sorted array.

    The sorted leaf file is the array; internal nodes are implicit (cached
    in memory).  Point query = 1 seek + 1 page.
    """

    def __init__(self, keys, vals, *, device: Device = HDD, cost: CostModel | None = None):
        order = np.argsort(keys)
        self.keys = np.asarray(keys, KEY_DTYPE)[order]
        self.vals = np.asarray(vals, VAL_DTYPE)[order]
        self.cm = cost or CostModel(device)
        # bulk-load cost: one sequential write of the whole file.
        self.cm.seek()
        self.cm.write_pairs(len(self.keys))

    def get(self, key):
        key = np.uint64(key)
        with self.cm.measure() as t:
            self.cm.page_read()
            i = int(np.searchsorted(self.keys, key))
            found = i < len(self.keys) and self.keys[i] == key
        self._last_query_time = t.seconds
        return self.vals[i] if found else None

    def query(self, key):
        v = self.get(key)
        return v, self._last_query_time

    def range_query(self, lo, hi):
        """Inclusive range scan [lo, hi]: one descent + one sequential leaf
        scan of the matching span — the optimal disk range query every other
        index is measured against.  Returns (keys, vals) numpy arrays."""
        lo, hi = np.uint64(lo), np.uint64(hi)
        with self.cm.measure() as t:
            i0 = int(np.searchsorted(self.keys, lo, side="left"))
            i1 = int(np.searchsorted(self.keys, hi, side="right"))
            self.cm.page_read()                  # locate the first leaf
            if i1 > i0:
                self.cm.read_pairs(i1 - i0)      # sequential span scan
            out = self.keys[i0:i1].copy(), self.vals[i0:i1].copy()
        self._last_query_time = t.seconds
        return out

    def drain(self) -> None:  # API parity with the dynamic engines
        pass

    def total_pairs(self) -> int:
        return len(self.keys)


class BPlusTree:
    """Incremental B+-tree: per-insert leaf read-modify-write.

    Leaf granularity is one page.  Internal levels cached in memory (their
    updates are free); each insert pays seek + page read + page write, each
    query seek + page read.
    """

    def __init__(self, *, device: Device = HDD, cost: CostModel | None = None):
        self.cm = cost or CostModel(device)
        self._store: dict = {}
        self.n_inserted = 0

    def insert(self, key, value) -> float:
        with self.cm.measure() as t:
            self.cm.page_read()                       # fetch the target leaf
            self.cm.seek()
            self.cm.seq_write(self.cm.device.page_bytes)  # rewrite it
            self._store[np.uint64(key)] = np.int64(value)
            self.n_inserted += 1
        return t.seconds

    def delete(self, key) -> float:
        return self.insert(key, TOMBSTONE)

    def get(self, key):
        key = np.uint64(key)
        with self.cm.measure() as t:
            self.cm.page_read()
            v = self._store.get(key)
        self._last_query_time = t.seconds
        return None if v is None or v == TOMBSTONE else v

    def query(self, key):
        v = self.get(key)
        return v, self._last_query_time

    def range_query(self, lo, hi):
        """Inclusive range scan [lo, hi]: descent + sequential leaf-chain
        scan (leaves are sibling-linked).  Returns (keys, vals) arrays."""
        lo, hi = np.uint64(lo), np.uint64(hi)
        with self.cm.measure() as t:
            ks = sorted(int(k) for k, v in self._store.items()
                        if lo <= k <= hi and v != TOMBSTONE)
            self.cm.page_read()                  # locate the first leaf
            if ks:
                self.cm.read_pairs(len(ks))      # sequential leaf-chain scan
            out = (np.asarray(ks, KEY_DTYPE),
                   np.asarray([int(self._store[np.uint64(k)]) for k in ks],
                              VAL_DTYPE))
        self._last_query_time = t.seconds
        return out

    def drain(self) -> None:
        pass

    def total_pairs(self) -> int:
        return len(self._store)
