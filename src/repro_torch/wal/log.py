"""Segment-based group-commit write-ahead log (DESIGN.md §9); the port's
copy of ``repro/wal/log.py``, byte for byte in its format.

Durability layer under :class:`~repro_torch.ingest.frontend.IngestFrontend`: one
WAL record per *group commit*, holding the commit's write ops (INSERT /
DELETE rows; reads are not logged) and its commit LSN.  An op is acked only
after its commit's record is fsynced — the ack instant *is* fsync return.

On-disk format (little-endian), one directory of segment files::

    wal_<first_lsn:016d>.log        records, appended in LSN order

    record := header ‖ payload
    header := magic:u32 ‖ payload_len:u32 ‖ lsn:u64 ‖ crc32(payload):u32
    payload := n_ops:u32 ‖ kinds:int8[n] ‖ keys:u64[n] ‖ vals:i64[n]

Properties the recovery path relies on:

* **Per-record checksums.**  A record is valid iff its header parses, its
  payload is fully present, its CRC matches, and its LSN is exactly
  ``previous + 1``.  Anything else is garbage.
* **Garbage-tail truncation on open.**  Opening the log scans every
  segment in LSN order and physically truncates the file at the first
  invalid record (a torn group commit from a crash between append and
  fsync); all bytes past it — and any later segments — are discarded.
  A torn commit was by construction never acked, so truncation is exactly
  the "no resurrected unacked writes" invariant.
* **Segment rotation.**  A segment is closed once it exceeds
  ``segment_bytes``; the next segment's filename carries the first LSN it
  will contain, which is what makes checkpoint garbage collection
  (:meth:`WriteAheadLog.truncate_upto`) a pure file unlink.
* **Checkpoint truncation.**  ``truncate_upto(lsn)`` unlinks every
  *closed* segment whose records all have LSN ≤ ``lsn`` (the newest
  segment is always kept so the next-LSN counter survives restarts with
  an empty tail).

Key and value widths: a record carries uint64 keys and int64 values, as
the JAX package's log does, while the device tier holds uint32 keys and
int32 values.  The workload generator keeps keys and values below 2^31, so
a record replayed into the device tier loses nothing.

Besides the JAX package's counters (``stats()``), ``fsync_s`` keeps a
log-bucket histogram of the wall time of each record's ``fsync``.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import time as _time
import zlib

import numpy as np

from ..obs.metrics import LogBucketHistogram
from .faults import CrashPoint, FaultInjector, reach as _reach

_MAGIC = 0x314C4157                      # "WAL1"
_HEADER = struct.Struct("<IIQI")         # magic, payload_len, lsn, crc
_COUNT = struct.Struct("<I")
_OP_BYTES = 1 + 8 + 8                    # kind + key + val per op
_MAX_OPS = 1 << 24                       # sanity bound on a parsed header


@dataclasses.dataclass(frozen=True)
class WalRecord:
    """One durable group commit: LSN + the commit's write ops."""

    lsn: int
    kinds: np.ndarray        # int8  (n,)
    keys: np.ndarray         # uint64 (n,)
    vals: np.ndarray         # int64 (n,)

    def __len__(self) -> int:
        return len(self.kinds)


def _encode_payload(kinds, keys, vals) -> bytes:
    kinds = np.ascontiguousarray(kinds, np.int8)
    keys = np.ascontiguousarray(keys, np.uint64)
    vals = np.ascontiguousarray(vals, np.int64)
    n = len(kinds)
    assert keys.shape == vals.shape == (n,)
    return (_COUNT.pack(n) + kinds.tobytes() + keys.tobytes()
            + vals.tobytes())


def _decode_payload(buf: bytes):
    (n,) = _COUNT.unpack_from(buf, 0)
    if len(buf) != _COUNT.size + n * _OP_BYTES:
        raise ValueError("payload length mismatch")
    o = _COUNT.size
    kinds = np.frombuffer(buf, np.int8, n, o)
    keys = np.frombuffer(buf, np.uint64, n, o + n)
    vals = np.frombuffer(buf, np.int64, n, o + 9 * n)
    return kinds.copy(), keys.copy(), vals.copy()


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _segment_name(first_lsn: int) -> str:
    return f"wal_{first_lsn:016d}.log"


@dataclasses.dataclass
class _Segment:
    path: str
    first_lsn: int           # LSN the segment was opened at (may hold none)
    last_lsn: int            # last valid record inside (first_lsn-1 if empty)
    size: int                # valid byte length


class WriteAheadLog:
    """Append-only segmented redo log; see module docstring.

    ``append_commit`` is the only mutator on the hot path: one buffered
    write + one ``fsync`` per group commit.  ``injector`` threads the
    crash-point harness through the append path (production passes None).
    """

    def __init__(self, directory: str, *, segment_bytes: int = 1 << 20,
                 injector: FaultInjector | None = None, tracer=None):
        assert segment_bytes >= 4096
        self.dir = directory
        self.segment_bytes = int(segment_bytes)
        self.injector = injector
        # optional obs tracer: one wall-clock "wal_fsync" span per
        # append_commit (standalone/device use; the sim-clock frontend
        # emits its own charged spans instead and passes no tracer here).
        self.tracer = tracer
        self._t_origin = _time.perf_counter()
        os.makedirs(directory, exist_ok=True)
        # counters (cumulative since open; JSON-ready via stats()).
        self.appends = 0
        self.syncs = 0
        self.bytes_appended = 0
        self.truncated_tail_bytes = 0     # garbage discarded on open
        self.gc_segments = 0              # segments unlinked by truncate_upto
        self.fsync_s = LogBucketHistogram()   # wall time of each record fsync
        self._fh = None                   # append handle on the last segment
        self._segments: list[_Segment] = []
        self._recover()

    # ------------------------------------------------------------------ open
    def _recover(self) -> None:
        """Scan segments in order, truncate the garbage tail, set last LSN."""
        names = sorted(n for n in os.listdir(self.dir)
                       if n.startswith("wal_") and n.endswith(".log"))
        prev_lsn = 0
        dirty = False
        for k, name in enumerate(names):
            path = os.path.join(self.dir, name)
            first = int(name[4:-4])
            seg = _Segment(path, first, first - 1, 0)
            valid_end, last = self._scan(path, expect_next=first)
            size = os.path.getsize(path)
            if valid_end < size:
                # torn tail: physically truncate, drop all later segments
                # (they were appended after the torn record and cannot be
                # trusted to continue the LSN chain).
                with open(path, "r+b") as f:
                    f.truncate(valid_end)
                    f.flush()
                    os.fsync(f.fileno())
                self.truncated_tail_bytes += size - valid_end
                dirty = True
            seg.last_lsn = last if last is not None else first - 1
            seg.size = valid_end
            self._segments.append(seg)
            prev_lsn = seg.last_lsn
            if dirty:
                for later in names[k + 1:]:
                    lp = os.path.join(self.dir, later)
                    self.truncated_tail_bytes += os.path.getsize(lp)
                    os.unlink(lp)
                break
        if dirty:
            _fsync_dir(self.dir)
        self.last_lsn = prev_lsn if self._segments else 0

    def _scan(self, path: str, *, expect_next: int):
        """Return (valid_end_offset, last_valid_lsn|None) for one segment."""
        last = None
        nxt = expect_next
        end = 0
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off + _HEADER.size <= len(data):
            magic, plen, lsn, crc = _HEADER.unpack_from(data, off)
            if magic != _MAGIC or plen > _MAX_OPS * _OP_BYTES + _COUNT.size:
                break
            if off + _HEADER.size + plen > len(data):
                break                           # torn payload
            payload = data[off + _HEADER.size: off + _HEADER.size + plen]
            if zlib.crc32(payload) != crc or lsn != nxt:
                break
            off += _HEADER.size + plen
            end = off
            last = lsn
            nxt = lsn + 1
        return end, last

    # ---------------------------------------------------------------- append
    def _open_segment(self, first_lsn: int) -> None:
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None
        seg = _Segment(os.path.join(self.dir, _segment_name(first_lsn)),
                       first_lsn, first_lsn - 1, 0)
        self._segments.append(seg)
        self._fh = open(seg.path, "ab")
        _fsync_dir(self.dir)

    def _ensure_segment(self, nbytes: int, lsn: int):
        if not self._segments:
            self._open_segment(lsn)
        elif self._fh is None:
            # reopened log: append to the recovered tail segment.
            self._fh = open(self._segments[-1].path, "ab")
        tail = self._segments[-1]
        if (tail.size and tail.size + nbytes > self.segment_bytes) or \
                lsn != tail.last_lsn + 1:
            # rotation on size, or on an LSN discontinuity: the chain check
            # is per segment (anchored at the filename's first LSN), so a
            # caller that must skip LSNs — a primary whose corrupted tail
            # was rolled back but whose applied state is ahead, or a fresh
            # replica starting at a snapshot LSN — gets a new segment whose
            # name re-anchors the chain.
            self._open_segment(lsn)
        return self._fh, self._segments[-1]

    def append_commit(self, kinds, keys, vals, *,
                      lsn: int | None = None) -> tuple[int, int]:
        """Durably log one group commit; returns ``(lsn, bytes_written)``.

        Blocks until the record is fsynced — the caller's ack instant.
        ``lsn`` overrides the self-assigned ``last_lsn + 1`` for logs that
        mirror an external chain (replication ships the *group's* LSN to
        every replica WAL); it must still advance monotonically.
        """
        t_span0 = _time.perf_counter()
        lsn = self.last_lsn + 1 if lsn is None else int(lsn)
        assert lsn > self.last_lsn, "WAL LSNs must advance"
        payload = _encode_payload(kinds, keys, vals)
        rec = _HEADER.pack(_MAGIC, len(payload), lsn,
                           zlib.crc32(payload)) + payload
        _reach(self.injector, CrashPoint.BEFORE_WAL_APPEND)
        f, seg = self._ensure_segment(len(rec), lsn)
        pos = seg.size
        f.write(rec)
        f.flush()
        self.appends += 1
        self.bytes_appended += len(rec)

        def tear():
            # crash between append and fsync: the OS may persist any prefix
            # of the unsynced bytes — emulate the adversarial torn write.
            f.truncate(pos + max(1, len(rec) // 2))
            f.flush()
            os.fsync(f.fileno())
            f.close()

        _reach(self.injector, CrashPoint.AFTER_WAL_APPEND, on_crash=tear)
        t_sync0 = _time.perf_counter()
        os.fsync(f.fileno())
        self.fsync_s.add(_time.perf_counter() - t_sync0)
        self.syncs += 1
        seg.size = pos + len(rec)
        seg.last_lsn = lsn
        self.last_lsn = lsn
        if self.tracer is not None:
            self.tracer.complete("wal_fsync", "append_commit",
                                 t_span0 - self._t_origin,
                                 _time.perf_counter() - t_span0,
                                 lsn=int(lsn), nbytes=len(rec))
        return lsn, len(rec)

    # ---------------------------------------------------------------- replay
    def replay(self, after_lsn: int = 0, *, key_lo: int | None = None,
               key_hi: int | None = None):
        """Yield :class:`WalRecord` for every record with LSN > ``after_lsn``.

        ``key_lo``/``key_hi`` (inclusive) restrict replay to ops whose key
        falls inside the interval: records are filtered row-wise and
        records left empty are skipped entirely.  A tenant namespace
        is one contiguous encoded-key interval, so this is what lets
        recovery rebuild a single namespace without replaying every
        co-tenant's writes.

        Reads through independent handles, so replaying an open log (tests,
        live verification) is safe.
        """
        lo = np.uint64(0 if key_lo is None else key_lo)
        hi = np.uint64(np.iinfo(np.uint64).max if key_hi is None else key_hi)
        filtered = key_lo is not None or key_hi is not None
        for seg in self._segments:
            if seg.last_lsn <= after_lsn or seg.size == 0:
                continue
            with open(seg.path, "rb") as f:
                data = f.read(seg.size)
            off = 0
            while off + _HEADER.size <= len(data):
                _, plen, lsn, _ = _HEADER.unpack_from(data, off)
                payload = data[off + _HEADER.size: off + _HEADER.size + plen]
                off += _HEADER.size + plen
                if lsn <= after_lsn:
                    continue
                kinds, keys, vals = _decode_payload(payload)
                if filtered:
                    m = (keys >= lo) & (keys <= hi)
                    if not m.any():
                        continue
                    kinds, keys, vals = kinds[m], keys[m], vals[m]
                yield WalRecord(lsn, kinds, keys, vals)

    # -------------------------------------------------------------- truncate
    def truncate_upto(self, lsn: int) -> int:
        """Unlink closed segments fully covered by a checkpoint at ``lsn``.

        Returns the number of segments removed.  The newest segment is
        always kept (even if fully covered) so the LSN counter survives a
        restart with an empty tail.
        """
        removed = 0
        while len(self._segments) > 1 and self._segments[0].last_lsn <= lsn:
            seg = self._segments.pop(0)
            os.unlink(seg.path)
            removed += 1
        if removed:
            _fsync_dir(self.dir)
            self.gc_segments += removed
        return removed

    # ----------------------------------------------------------------- misc
    @property
    def n_segments(self) -> int:
        return len(self._segments)

    def stats(self) -> dict:
        return {
            "last_lsn": int(self.last_lsn),
            "appends": int(self.appends),
            "syncs": int(self.syncs),
            "bytes_appended": int(self.bytes_appended),
            "segments": int(self.n_segments),
            "gc_segments": int(self.gc_segments),
            "truncated_tail_bytes": int(self.truncated_tail_bytes),
        }

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None
