"""Durability layer of the port: group-commit WAL, crash points, recovery.

DESIGN.md §9.  Every acked write survives a crash: the ingest frontend
(``ingest.frontend``) appends each group commit's write ops to a
segment-based write-ahead log (:mod:`.log`) and acks only after fsync;
periodic engine-table snapshots (``checkpoint.EngineCheckpointer``)
keyed by commit LSN bound the replay tail; :func:`~.recovery.recover`
rebuilds an engine as snapshot + WAL-tail replay.  :mod:`.faults` is the
crash-point injection harness the fault-injection test matrix kills with.
"""
from .faults import (ChaosEvent, ChaosKind, CrashPoint, FaultInjector,
                     FaultSchedule, SimulatedCrash, flip_wal_byte,
                     tear_wal_tail)
from .log import WalRecord, WriteAheadLog
from .recovery import (CHECKPOINT_SUBDIR, WAL_SUBDIR, RecoveryResult,
                       recover)

__all__ = [
    "ChaosEvent", "ChaosKind", "CrashPoint", "FaultInjector",
    "FaultSchedule", "SimulatedCrash", "flip_wal_byte", "tear_wal_tail",
    "WalRecord", "WriteAheadLog",
    "CHECKPOINT_SUBDIR", "WAL_SUBDIR", "RecoveryResult", "recover",
]
