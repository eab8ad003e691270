"""Leveling LSM-tree baseline (paper Secs. 1.2, 7; benchmarked in Figs. 6-9);
the port's copy of ``repro/core/lsm.py``, a host sim-clock tier.

Models the LevelDB/RocksDB family: an in-memory memtable of ``mem_pairs``
pairs, on-disk levels of geometrically growing capacity (``ratio`` T), full
level-rewrite merges (leveling policy), and optional per-level Bloom
filters.  ``max_levels`` caps the number of levels to emulate bLSM [42]
(better queries, unbounded component-size ratio => worse inserts).

The worst-case insertion behaviour the paper highlights — a single insert
triggering a cascade that rewrites nearly the whole database, linear in n —
emerges naturally from this implementation and is what Fig. 7 measures
against NB-tree's deamortized logarithmic bound.
"""
from __future__ import annotations

import numpy as np

from .bloom import BloomFilter
from .cost_model import PAIR_BYTES, CostModel, Device, HDD
from .sorted_run import (KEY_DTYPE, TOMBSTONE, VAL_DTYPE, drop_tombstones,
                         merge_runs)


class _Level:
    __slots__ = ("keys", "vals", "bloom")

    def __init__(self):
        self.keys = np.empty(0, KEY_DTYPE)
        self.vals = np.empty(0, VAL_DTYPE)
        self.bloom: BloomFilter | None = None

    def __len__(self):
        return len(self.keys)


class LSMTree:
    def __init__(
        self,
        mem_pairs: int = 4096,
        ratio: int = 10,
        *,
        device: Device = HDD,
        use_bloom: bool = True,
        bits_per_key: int = 10,
        max_levels: int | None = None,
        cost: CostModel | None = None,
    ):
        self.mem_pairs, self.ratio = mem_pairs, ratio
        self.use_bloom, self.bits_per_key = use_bloom, bits_per_key
        self.max_levels = max_levels
        self.cm = cost or CostModel(device)
        self._buf: dict = {}
        self.levels: list[_Level] = []
        self.n_inserted = 0
        # per-level Bloom effectiveness (probes / negative skips / misses
        # after a positive), surfaced through EngineStats like the NB-tree's.
        self.bloom_probes = 0
        self.bloom_negative_skips = 0
        self.bloom_false_positives = 0

    # ---------------------------------------------------------------- inserts
    def insert(self, key, value) -> float:
        with self.cm.measure() as t:
            self._buf[np.uint64(key)] = np.int64(value)
            self.n_inserted += 1
            if len(self._buf) >= self.mem_pairs:
                self._compact()
        return t.seconds

    def delete(self, key) -> float:
        return self.insert(key, TOMBSTONE)

    def _capacity(self, i: int) -> int:
        if self.max_levels is not None and i == self.max_levels - 1:
            return 1 << 62  # bLSM-style last level: unbounded
        return self.mem_pairs * self.ratio ** (i + 1)

    def _compact(self) -> None:
        """Memtable -> L0; cascade full levels downward (leveling merge)."""
        keys = np.fromiter(self._buf.keys(), KEY_DTYPE, len(self._buf))
        vals = np.fromiter(self._buf.values(), VAL_DTYPE, len(self._buf))
        order = np.argsort(keys)
        keys, vals = keys[order], vals[order]
        self._buf = {}

        i = 0
        while True:
            if i >= len(self.levels):
                self.levels.append(_Level())
            lvl = self.levels[i]
            # leveling: read the whole target level, rewrite the merged run.
            self.cm.seek()
            self.cm.read_pairs(len(lvl))
            last = i == len(self.levels) - 1 and (
                self.max_levels is None or i == self.max_levels - 1
            )
            keys, vals = merge_runs(keys, vals, lvl.keys, lvl.vals)
            if last:
                keys, vals = drop_tombstones(keys, vals)
            self.cm.seek()
            self.cm.write_pairs(len(keys))
            lvl.keys, lvl.vals = keys, vals
            if self.use_bloom:
                lvl.bloom = BloomFilter.build(lvl.keys, self.bits_per_key)
            if len(lvl) <= self._capacity(i):
                break
            # level overflows: push its entire contents one level down.
            keys, vals = lvl.keys, lvl.vals
            self.cm.seek()
            self.cm.read_pairs(len(lvl))
            lvl.keys = np.empty(0, KEY_DTYPE)
            lvl.vals = np.empty(0, VAL_DTYPE)
            lvl.bloom = None
            i += 1
            if self.max_levels is not None and i >= self.max_levels:
                i = self.max_levels - 1

    # ---------------------------------------------------------------- queries
    def get(self, key):
        key = np.uint64(key)
        with self.cm.measure() as t:
            val = self._get(key)
        self._last_query_time = t.seconds
        return val

    def query(self, key):
        v = self.get(key)
        return v, self._last_query_time

    def _get(self, key):
        if key in self._buf:
            v = self._buf[key]
            return None if v == TOMBSTONE else v
        for lvl in self.levels:
            if len(lvl) == 0:
                continue
            positive = True
            if self.use_bloom and lvl.bloom is not None:
                self.bloom_probes += 1
                positive = bool(lvl.bloom.contains(np.asarray([key]))[0])
                if not positive:
                    self.bloom_negative_skips += 1
            if positive:
                # fence pointers cached in memory: one seek + one leaf page.
                self.cm.page_read()
                i = int(np.searchsorted(lvl.keys, key))
                if i < len(lvl.keys) and lvl.keys[i] == key:
                    v = lvl.vals[i]
                    return None if v == TOMBSTONE else v
                if self.use_bloom and lvl.bloom is not None:
                    self.bloom_false_positives += 1
        return None

    def range_query(self, lo, hi):
        """Inclusive range scan [lo, hi]; returns (keys, vals) numpy arrays.

        Every level must be scanned (newest first — freshest copy wins, the
        LSM range-query sort-merge): per non-empty overlapping level one
        seek + the sequential transfer of its matching span.  Fence pointers
        are cached in memory, so levels with no overlap cost nothing.
        Bloom filters cannot prune range scans — the LSM read amplification
        the paper's baselines pay on this workload class.
        """
        lo, hi = np.uint64(lo), np.uint64(hi)
        with self.cm.measure() as t:
            result: dict = {}
            if lo <= hi:
                for k, v in self._buf.items():      # keys unique: no order dep
                    if lo <= k <= hi:
                        result[int(k)] = int(v)
                for lvl in self.levels:          # level 0 first = newest
                    if len(lvl) == 0:
                        continue
                    i0 = int(np.searchsorted(lvl.keys, lo, side="left"))
                    i1 = int(np.searchsorted(lvl.keys, hi, side="right"))
                    if i1 <= i0:
                        continue
                    self.cm.seek()
                    self.cm.read_pairs(i1 - i0)
                    for k, v in zip(lvl.keys[i0:i1].tolist(),
                                    lvl.vals[i0:i1].tolist()):
                        if k not in result:
                            result[k] = v
            ks = sorted(k for k, v in result.items() if v != TOMBSTONE)
            out = (np.asarray(ks, KEY_DTYPE),
                   np.asarray([result[k] for k in ks], VAL_DTYPE))
        self._last_query_time = t.seconds
        return out

    def drain(self) -> None:  # API parity with NBTree
        pass

    def total_pairs(self) -> int:
        return len(self._buf) + sum(len(l) for l in self.levels)
