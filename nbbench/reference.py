"""The plain reference: a last-writer-wins map of every acknowledged write.

Written in NumPy alone, independent of the program under test: it imports
nothing of ``repro_torch`` and takes nothing the program made.  It is worked
out again from the same generated ops, the load and the window's batches,
and answers what the program should have answered: every read and scan at
the moment it was served, and the visible table at the end.  A reworking of
``chip_smoke.py::Oracle`` (a sorted key/value map with last-writer-wins
writes) that keeps each write's time, so that one pass after the window
answers every op of it.

Times: every op has one, increasing through the stream, and an op sees
every write with an earlier time.  Keys are below 2^32 and times below
2^32, so ``key << 32 | time`` orders the writes by key, then by time.
"""
from __future__ import annotations

import numpy as np

_SHIFT = np.uint64(32)


def _pack(keys, times) -> np.ndarray:
    keys = np.asarray(keys, np.uint64)
    times = np.asarray(times, np.uint64)
    if keys.size and (int(keys.max()) >> 32 or int(times.max()) >> 32):
        raise ValueError("keys and times must stay below 2^32")
    return (keys << _SHIFT) | times


def segments(counts) -> np.ndarray:
    """Segment id of each element of segments of the given lengths."""
    counts = np.asarray(counts, np.int64)
    return np.repeat(np.arange(len(counts)), counts)


class LastWriterWins:
    """Every write as ``(key, time, value)``; reads resolve the newest write
    older than the reader."""

    def __init__(self):
        self._parts: list = []
        self._packed = None

    def write(self, keys, vals, times) -> None:
        self._parts.append((_pack(keys, times), np.asarray(vals, np.int64)))
        self._packed = None

    def _freeze(self) -> None:
        if self._packed is not None:
            return
        if self._parts:
            packed = np.concatenate([p for p, _ in self._parts])
            vals = np.concatenate([v for _, v in self._parts])
        else:
            packed, vals = np.zeros(0, np.uint64), np.zeros(0, np.int64)
        order = np.argsort(packed, kind="stable")
        self._packed, self._vals = packed[order], vals[order]
        keys = self._packed >> _SHIFT
        last = np.ones(len(keys), bool)
        last[:-1] = keys[1:] != keys[:-1]
        self._keys = keys[last]              # distinct written keys, sorted
        self._last_vals = self._vals[last]   # each key's newest value

    def read(self, keys, times) -> tuple:
        """``(found, value)`` of each key as seen at its time (-1 absent)."""
        self._freeze()
        keys = np.asarray(keys, np.uint64)
        pos = np.searchsorted(self._packed, _pack(keys, times)) - 1
        ok = pos >= 0
        ok[ok] = (self._packed[pos[ok]] >> _SHIFT) == keys[ok]
        vals = np.full(len(keys), -1, np.int64)
        vals[ok] = self._vals[pos[ok]]
        return ok, vals

    def scan(self, los, his, times) -> tuple:
        """``(keys, vals, counts)``: each scan's visible pairs in
        ``[lo, hi]``, key order, concatenated scan after scan."""
        self._freeze()
        a = np.searchsorted(self._keys, np.asarray(los, np.uint64), "left")
        b = np.searchsorted(self._keys, np.asarray(his, np.uint64), "right")
        n = np.maximum(b - a, 0)
        seg = segments(n)
        start = np.repeat(a - np.concatenate([[0], np.cumsum(n)[:-1]]), n)
        cand = self._keys[start + np.arange(len(seg))]
        found, vals = self.read(cand, np.asarray(times, np.uint64)[seg])
        counts = np.bincount(seg[found], minlength=len(n))
        return cand[found], vals[found], counts

    def table(self) -> tuple:
        """``(keys, vals)`` of the visible table after every write."""
        self._freeze()
        return self._keys, self._last_vals


def table_mismatches(keys, vals, ref_keys, ref_vals) -> int:
    """Keys present on one side only, plus keys whose values differ."""
    keys = np.asarray(keys, np.uint64)
    ref_keys = np.asarray(ref_keys, np.uint64)
    if len(keys) == len(ref_keys) and np.array_equal(keys, ref_keys):
        return int((np.asarray(vals, np.int64)
                    != np.asarray(ref_vals, np.int64)).sum())
    common, i, j = np.intersect1d(keys, ref_keys, assume_unique=True,
                                  return_indices=True)
    differ = int((np.asarray(vals, np.int64)[i]
                  != np.asarray(ref_vals, np.int64)[j]).sum())
    return len(keys) + len(ref_keys) - 2 * len(common) + differ


def scan_mismatches(keys, vals, counts, ref_keys, ref_vals,
                    ref_counts) -> int:
    """Scans whose answer differs from the reference's in count, a key or a
    value; answers come concatenated, with a count per scan."""
    counts = np.asarray(counts, np.int64)
    ref_counts = np.asarray(ref_counts, np.int64)
    bad = counts != ref_counts
    if not bad.any():
        differ = ((np.asarray(keys, np.uint64)
                   != np.asarray(ref_keys, np.uint64))
                  | (np.asarray(vals, np.int64)
                     != np.asarray(ref_vals, np.int64)))
        return int(np.unique(segments(counts)[differ]).size)
    same = ~bad
    mine = np.repeat(same, counts)
    theirs = np.repeat(same, ref_counts)
    differ = ((np.asarray(keys, np.uint64)[mine]
               != np.asarray(ref_keys, np.uint64)[theirs])
              | (np.asarray(vals, np.int64)[mine]
                 != np.asarray(ref_vals, np.int64)[theirs]))
    return int(bad.sum()) + int(
        np.unique(segments(counts)[mine][differ]).size)
