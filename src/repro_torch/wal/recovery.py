"""Crash recovery: latest snapshot + WAL-tail replay (DESIGN.md §9); the
port's copy of ``repro/wal/recovery.py``.

A durable ingest directory has the layout the durable frontend writes::

    <dir>/wal/wal_<first_lsn>.log          redo log segments
    <dir>/checkpoints/step_<lsn>/...       engine-table snapshots + manifest

:func:`recover` rebuilds a storage engine from it:

1. load the newest *provable* snapshot (``EngineCheckpointer``
   atomicity means a half-written one is invisible) and bulk-insert its
   live table into a fresh engine;
2. open the WAL — which truncates any garbage tail (torn, never-acked
   group commits) as a side effect of validation;
3. replay every record with LSN > snapshot LSN, in LSN order, through the
   normal ``apply`` path (replay is idempotent against the snapshot
   because inserts are blind newest-wins writes and deletes of absent
   keys are no-ops on every tier).

The recovered engine's live table then equals exactly the acked prefix of
the ingest history — zero lost acked writes, zero resurrected unacked
ones — which ``tests/test_torch_durability.py`` checks against a
sorted-dict oracle at every crash point.

On the device tier the snapshot goes in as one ``OpBatch``: the engine
pads it to the next power of two (repeating its last pair, as the JAX
engine pads) and splits it into ``sigma``-sized merges with backpressure
maintenance between them, so the replay cost grows with the padded size.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from ..core.engine_api import OpBatch, StorageEngine
from ..core.sorted_run import KEY_DTYPE

from .log import WriteAheadLog

#: subdirectory names the durable frontend and recover() agree on.
WAL_SUBDIR = "wal"
CHECKPOINT_SUBDIR = "checkpoints"


@dataclasses.dataclass
class RecoveryResult:
    """What :func:`recover` rebuilt and how much work it took."""

    engine: StorageEngine
    last_lsn: int               # highest durable commit LSN after recovery
    snapshot_lsn: int           # 0 = recovered from WAL alone
    snapshot_pairs: int
    replayed_commits: int
    replayed_ops: int
    truncated_tail_bytes: int   # torn garbage discarded while opening
    recover_wall_s: float
    #: inclusive encoded-key interval this recovery was scoped to
    #: (None = the whole keyspace; see :func:`recover`'s ``key_range``).
    key_range: tuple | None = None


def recover(directory: str, engine_factory, *,
            key_range: tuple | None = None,
            tracer=None) -> RecoveryResult:
    """Rebuild an engine from ``directory``; see module docstring.

    ``tracer`` (an ``obs.trace.Tracer``) records one wall-clock
    ``recovery`` span covering the whole rebuild — snapshot load + WAL
    replay — with the replay counts in its args.

    ``engine_factory`` must build a *fresh, empty* engine configured like
    the one that crashed (same tier/knobs — recovery restores logical
    content, not physical layout).

    ``key_range = (lo, hi)`` (inclusive) scopes recovery to one encoded-key
    interval: the snapshot's live table is filtered to it and WAL replay
    skips every op outside it.  A tenant namespace (``tenancy``) is
    exactly such an interval, so this is single-namespace recovery — one
    tenant's data rebuilt from the shared log without paying for its
    co-tenants' history.  ``last_lsn`` still reports the *global* durable
    watermark (the LSN chain is shared).
    """
    # imported here, not at module top: the checkpointer imports
    # wal.faults, and a module-level import would close the cycle.
    from ..checkpoint.checkpointer import EngineCheckpointer

    t0 = time.perf_counter()
    lo = hi = None
    if key_range is not None:
        lo, hi = (int(key_range[0]), int(key_range[1]))
        assert 0 <= lo <= hi
    ckpt = EngineCheckpointer(os.path.join(directory, CHECKPOINT_SUBDIR))
    snap = ckpt.load_latest_snapshot()
    engine = engine_factory()
    snap_lsn, snap_pairs = 0, 0
    if snap is not None:
        snap_lsn, keys, vals = snap
        if key_range is not None:
            m = (keys >= np.uint64(lo)) & (keys <= np.uint64(hi))
            keys, vals = keys[m], vals[m]
        snap_pairs = len(keys)
        if snap_pairs:
            engine.apply(OpBatch.inserts(keys, vals))
            engine.drain()
    wal = WriteAheadLog(os.path.join(directory, WAL_SUBDIR))
    n_commits = n_ops = 0
    for rec in wal.replay(after_lsn=snap_lsn, key_lo=lo, key_hi=hi):
        batch = OpBatch(rec.kinds, rec.keys, rec.vals,
                        np.zeros(len(rec), KEY_DTYPE))
        engine.apply(batch)
        engine.note_applied(rec.lsn)
        n_commits += 1
        n_ops += len(rec)
    engine.note_applied(max(snap_lsn, wal.last_lsn))
    torn = wal.truncated_tail_bytes
    last = max(snap_lsn, wal.last_lsn)
    wal.close()
    wall = time.perf_counter() - t0
    if tracer is not None:
        tracer.complete("recovery", "recover", 0.0, wall,
                        snapshot_lsn=int(snap_lsn), last_lsn=int(last),
                        replayed_commits=int(n_commits),
                        replayed_ops=int(n_ops),
                        truncated_tail_bytes=int(torn))
    return RecoveryResult(
        engine=engine, last_lsn=last, snapshot_lsn=snap_lsn,
        snapshot_pairs=snap_pairs, replayed_commits=n_commits,
        replayed_ops=n_ops, truncated_tail_bytes=torn,
        recover_wall_s=wall, key_range=key_range)
