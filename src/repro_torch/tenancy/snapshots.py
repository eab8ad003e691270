"""Consistent snapshot reads across shards mid-cascade (DESIGN.md §10); the
port's copy of ``repro/tenancy/snapshots.py``.

A snapshot is a read view frozen at a *commit-LSN watermark*: every write
acked at or below the watermark is visible, nothing later is, no matter
how many group commits, emptying cascades, or hot-shard splits happen
while the snapshot is held.

Why this is cheap on this stack: ``dump_live()`` is maintenance-invariant
— cascades, merges and shard splits move pairs between physical levels
but never change the logical live table, which always equals the applied
prefix of the commit history.  So a snapshot pinned on the group-commit
boundary (after ``apply``, before the next commit) is exactly the prefix
``<= watermark`` — *including across shards*, because the sharded
engine's ``dump_live`` stitches per-shard tables that all sit at the same
applied prefix.  The pin therefore just materializes the key-sorted live
table (optionally one tenant's interval of it) into immutable arrays; no
coordination with maintenance is needed, and maintenance proceeds freely
underneath — the differential tests in ``tests/test_torch_tenancy.py`` drive
cascades between pin and read to check exactly that.

Reads against a pinned :class:`Snapshot` are binary searches over the
frozen arrays; the engine is never touched after the pin.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.sorted_run import KEY_DTYPE


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """An immutable read view frozen at ``watermark_lsn``."""

    snap_id: int
    watermark_lsn: int
    pinned_at_s: float            # sim-clock instant of the pin
    keys: np.ndarray              # uint64, key-sorted, frozen
    vals: np.ndarray              # int64
    key_range: tuple | None = None   # inclusive scope (None = whole keyspace)

    def __post_init__(self):
        self.keys.setflags(write=False)
        self.vals.setflags(write=False)

    def __len__(self) -> int:
        return len(self.keys)

    def query(self, keys) -> tuple:
        """Point reads: ``(found: bool[n], vals: int64[n])`` at the pin."""
        q = np.asarray(keys, KEY_DTYPE)
        if len(self.keys) == 0:
            return np.zeros(len(q), bool), np.zeros(len(q), np.int64)
        idx = np.searchsorted(self.keys, q, "left")
        idx_c = np.minimum(idx, len(self.keys) - 1)
        found = (idx < len(self.keys)) & (self.keys[idx_c] == q)
        vals = np.where(found, self.vals[idx_c], 0).astype(np.int64)
        return found, vals

    def range(self, lo: int, hi: int) -> tuple:
        """Inclusive range scan ``[lo, hi]`` at the pin: ``(keys, vals)``."""
        a = int(np.searchsorted(self.keys, np.asarray(lo, KEY_DTYPE), "left"))
        b = int(np.searchsorted(self.keys, np.asarray(hi, KEY_DTYPE),
                                "right"))
        return self.keys[a:b], self.vals[a:b]


class SnapshotManager:
    """Pin/release ledger over one engine; see module docstring.

    The caller (the multi-tenant frontend) must invoke :meth:`pin` only on
    a group-commit boundary — that placement, not anything this class
    does, is what makes the watermark exact.
    """

    def __init__(self, engine):
        self.engine = engine
        self._next_id = 1
        self._active: dict[int, Snapshot] = {}
        self.pins = 0
        self.releases = 0
        self.pinned_pairs_max = 0

    def pin(self, watermark_lsn: int, now_s: float = 0.0, *,
            key_range: tuple | None = None) -> Snapshot:
        """Freeze the live table (or one key interval of it) right now."""
        if key_range is None:
            keys, vals = self.engine.dump_live()
        else:
            lo, hi = int(key_range[0]), int(key_range[1])
            assert 0 <= lo <= hi
            keys, vals = self.engine.dump_live_range(lo, hi)
        snap = Snapshot(self._next_id, int(watermark_lsn), float(now_s),
                        np.ascontiguousarray(keys, KEY_DTYPE),
                        np.ascontiguousarray(vals, np.int64), key_range)
        self._active[snap.snap_id] = snap
        self._next_id += 1
        self.pins += 1
        self.pinned_pairs_max = max(
            self.pinned_pairs_max,
            sum(len(s) for s in self._active.values()))
        return snap

    def release(self, snap: Snapshot | int) -> None:
        sid = snap if isinstance(snap, int) else snap.snap_id
        assert sid in self._active, f"snapshot {sid} not active"
        del self._active[sid]
        self.releases += 1

    @property
    def active(self) -> list[Snapshot]:
        return [self._active[k] for k in sorted(self._active)]

    def stats(self) -> dict:
        return {
            "pins": self.pins,
            "releases": self.releases,
            "active": len(self._active),
            "active_pairs": sum(len(s) for s in self._active.values()),
            "pinned_pairs_max": self.pinned_pairs_max,
        }
