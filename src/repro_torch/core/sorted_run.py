"""Sorted-run primitives of the host (numpy) NB-tree (the port's copy of
``repro/core/sorted_run.py``).

A *run* is the on-disk representation of a d-tree (paper Sec. 4.1): the leaf
level of a B+-tree written sequentially in key order.  Internal d-nodes
degenerate to binary search over the sorted array (same asymptotics,
``log_B sigma`` with B = page fanout), which is also the device tier's
layout (DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses

import numpy as np

KEY_DTYPE = np.uint64
VAL_DTYPE = np.int64

#: sentinel for padded key slots (sorts after every real key).
KEY_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)

#: value tombstone bit — delta record that deletes its key (paper Sec. 3.2.2).
TOMBSTONE = np.int64(-1)


@dataclasses.dataclass
class Run:
    """An immutable sorted run with a lazy-removal watermark (paper Sec. 5.1).

    ``keys[:wm]`` have already been flushed to children and are dead; they
    remain on disk until the run is rewritten ("lazy removal").
    """

    keys: np.ndarray
    vals: np.ndarray
    wm: int = 0

    def __post_init__(self):
        assert self.keys.dtype == KEY_DTYPE, self.keys.dtype
        assert len(self.keys) == len(self.vals)

    @staticmethod
    def empty() -> "Run":
        return Run(np.empty(0, KEY_DTYPE), np.empty(0, VAL_DTYPE))

    @property
    def live_keys(self) -> np.ndarray:
        return self.keys[self.wm:]

    @property
    def live_vals(self) -> np.ndarray:
        return self.vals[self.wm:]

    def __len__(self) -> int:  # number of *live* pairs
        return len(self.keys) - self.wm

    @property
    def disk_pairs(self) -> int:  # pairs physically on disk (incl. dead prefix)
        return len(self.keys)

    def lookup(self, key: np.uint64):
        """Binary search among live pairs; returns value or None."""
        k = self.live_keys
        i = int(np.searchsorted(k, key))
        if i < len(k) and k[i] == key:
            return self.live_vals[i]
        return None

    def range(self, lo, hi):
        """Live pairs with lo <= key <= hi (inclusive), in key order.

        ``lo > hi`` is an empty range.  Returns (keys, vals) copies — the
        sequential leaf scan between the two d-tree descents.
        """
        k = self.live_keys
        i0 = int(np.searchsorted(k, lo, side="left"))
        i1 = int(np.searchsorted(k, hi, side="right"))
        if i1 <= i0:
            return np.empty(0, KEY_DTYPE), np.empty(0, VAL_DTYPE)
        return k[i0:i1].copy(), self.live_vals[i0:i1].copy()


def merge_runs(a_keys, a_vals, b_keys, b_vals):
    """Merge two sorted (keys, vals) streams; on duplicate keys *a wins*.

    ``a`` is the newer data (flushed down from the parent), so its delta
    records supersede the child's older pairs — the resolution rule of
    paper Sec. 3.2.2.  Pure numpy; the device tier's ``merge_sorted``
    kernel has the same semantics (``kernels/ref.py``).
    """
    if len(a_keys) == 0:
        return b_keys.copy(), b_vals.copy()
    if len(b_keys) == 0:
        return a_keys.copy(), a_vals.copy()
    keys = np.concatenate([a_keys, b_keys])
    vals = np.concatenate([a_vals, b_vals])
    # stable sort with 'a' entries first so that on ties the 'a' copy leads.
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    keep = np.ones(len(keys), bool)
    keep[1:] = keys[1:] != keys[:-1]  # drop the older duplicate (it follows)
    return keys[keep], vals[keep]


def drop_tombstones(keys, vals):
    """Resolve delete-deltas at the last level (paper Sec. 3.2.2)."""
    keep = vals != TOMBSTONE
    return keys[keep], vals[keep]


def partition_by_pivots(keys, vals, pivots):
    """Split a sorted stream into len(pivots)+1 key-disjoint slices.

    Slice i holds keys in [pivots[i-1], pivots[i]) — the cross-s-node
    linkage property (paper Sec. 3.1.1).
    """
    cuts = np.searchsorted(keys, np.asarray(pivots, dtype=keys.dtype), side="left")
    bounds = [0, *cuts.tolist(), len(keys)]
    return [
        (keys[bounds[i]:bounds[i + 1]], vals[bounds[i]:bounds[i + 1]])
        for i in range(len(bounds) - 1)
    ]
