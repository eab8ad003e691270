"""Replica nodes and replica groups: WAL shipping, promotion, rebuild; the
port's copy of ``repro/replication/replica.py``.

DESIGN.md §12.  A :class:`ReplicaGroup` is one range-partition of the key
space served by a *primary* plus ``R - 1`` replicas, all running the same
storage engine.  Group commits ship the commit's WAL record (the exact
``wal.log`` on-disk format, same LSN) to every in-sync replica;
each replica fsyncs into its **own** segment directory and acks at its own
charged fsync return.  The group acks the commit per the configured mode:

* ``"quorum"`` — primary fsync + enough replica fsyncs that a majority of
  the R copies hold the record (``R // 2 + 1`` total).  A commit is only
  *attempted* when the quorum is currently reachable, so an acked record
  always exists on a majority and a never-acked record exists nowhere
  (commits are atomic at group scope — the chaos harness fires between
  commits, never inside one).
* ``"primary"`` — ack at the primary's fsync alone.  Replicas still
  receive every record, but a primary lost before any replica existed
  (e.g. during a rebuild window) takes acked records with it; the report
  counts those as ``lost_acked_rows`` — the measurable price of the mode.

Replicas append + fsync synchronously but *apply* lazily (every
``apply_lag_commits`` commits), so promotion genuinely replays a WAL
tail.  Promotion picks the live replica with the highest **validated**
durable LSN (each candidate re-scans its segments first, so a corrupted
tail never inflates a claim), replays its pending tail into its engine,
and restarts the group LSN chain there.  Any other surviving replica not
exactly at the new chain head is retired and rebuilt — the invariant
``in-sync ⇒ durable_lsn == group chain head`` is what makes the quorum
arithmetic sound.

Rebuild = snapshot (``dump_live`` of the primary, charged at device
write bandwidth) + WAL catch-up (primary's records past the snapshot
LSN).  Catch-up verifies LSN contiguity; a gap (the primary's own tail
was corrupted and its chain re-anchored mid-rebuild) restarts the rebuild
from a fresh snapshot rather than admitting a hole.

Everything here runs on the deterministic sim clock: fsync and snapshot
costs are charged from the engine's device constants, so a whole
replicated run (chaos included) is a pure function of (trace, config,
schedule seed).  A wall-clock engine (the device tier, ``torch-nbtree``)
is refused, as in the JAX package, whose replicas are sim-clock only.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..core.cost_model import PAIR_BYTES, SSD
from ..core.engine_api import OpBatch, StorageEngine
from ..wal.faults import (ChaosEvent, ChaosKind, flip_wal_byte,
                          tear_wal_tail)
from ..wal.log import WriteAheadLog


@dataclasses.dataclass(frozen=True)
class ReplicationConfig:
    """Knobs of the replication layer (DESIGN.md §12).

    ``replicas`` is the TOTAL copy count R (primary included): ``R = 1``
    is the unreplicated baseline (a dead primary fails its range
    permanently), ``R = 2`` the cheapest configuration that survives a
    primary kill with zero acked-write loss under quorum acks.
    """

    replicas: int = 2
    ack_mode: str = "quorum"            # or "primary"
    heartbeat_timeout_s: float = 0.05   # silence before declared dead
    apply_lag_commits: int = 8          # replica apply laziness (tail size)
    retry_backoff_s: float = 0.005      # parked-op first retry delay
    retry_backoff_max_s: float = 0.08   # exponential backoff cap
    retry_deadline_s: float = 1.5       # parked longer than this -> shed
    segment_bytes: int = 1 << 20        # per-node WAL segment size

    def __post_init__(self):
        assert self.replicas >= 1
        assert self.ack_mode in ("quorum", "primary")
        assert self.heartbeat_timeout_s > 0 and self.apply_lag_commits >= 1
        assert 0 < self.retry_backoff_s <= self.retry_backoff_max_s
        assert self.retry_deadline_s > 0 and self.segment_bytes >= 4096

    @property
    def quorum(self) -> int:
        """Copies (primary included) that must hold a record before ack."""
        return self.replicas // 2 + 1 if self.ack_mode == "quorum" else 1


class ReplicaNode:
    """One engine + one private WAL directory; primary or replica role.

    The node's WAL mirrors the *group's* LSN chain (records arrive with
    explicit LSNs).  ``_pending`` buffers durable-but-unapplied records in
    LSN order; it is always a faithful image of the WAL tail past
    ``applied_lsn`` — :meth:`rescan` re-derives the durable horizon from
    disk and drops buffered records the scan rejected, so a corrupted
    tail can never be replayed into the engine.
    """

    def __init__(self, node_id: str, engine: StorageEngine, wal_dir: str,
                 *, segment_bytes: int = 1 << 20):
        assert engine.stats().clock == "sim", \
            "replication runs on the deterministic sim clock only"
        self.node_id = node_id
        self.engine = engine
        self.wal_dir = wal_dir
        self._segment_bytes = int(segment_bytes)
        os.makedirs(wal_dir, exist_ok=True)
        self.wal = WriteAheadLog(wal_dir, segment_bytes=self._segment_bytes)
        cm = getattr(engine, "cm", None)
        self.device = cm.device if cm is not None else SSD
        self.alive = True
        self.synced = True
        self.dead_since: float | None = None
        self.stall_s = 0.0             # one-shot chaos fsync debit
        self.applied_lsn = 0
        self._pending: list = []       # (lsn, kinds, keys, vals), durable

    @property
    def durable_lsn(self) -> int:
        return self.wal.last_lsn

    # ---------------------------------------------------------------- append
    def append(self, kinds, keys, vals, lsn: int, *,
               buffer: bool = True) -> float:
        """Durably log one shipped record; returns charged fsync seconds.

        ``buffer=False`` is the primary's path (it applies synchronously,
        so nothing waits in ``_pending``).
        """
        _, nbytes = self.wal.append_commit(kinds, keys, vals, lsn=lsn)
        if buffer:
            self._pending.append((lsn, np.asarray(kinds, np.int8).copy(),
                                  np.asarray(keys, np.uint64).copy(),
                                  np.asarray(vals, np.int64).copy()))
        dev = self.device
        sec = dev.seek_s + nbytes / dev.write_bw + self.stall_s
        self.stall_s = 0.0
        return sec

    # ----------------------------------------------------------------- apply
    def apply_pending(self, upto: int | None = None) -> tuple[int, float]:
        """Apply buffered records with LSN <= ``upto`` (default: all).

        Returns ``(ops_applied, charged_engine_seconds)`` — promotion's
        replay cost comes straight from here.
        """
        upto = self.durable_lsn if upto is None else int(upto)
        io0 = self.engine.io_time_s()
        n = 0
        while self._pending and self._pending[0][0] <= upto:
            lsn, kinds, keys, vals = self._pending.pop(0)
            self.engine.apply(OpBatch(kinds, keys, vals,
                                      np.zeros(len(kinds), np.uint64)))
            self.engine.note_applied(lsn)
            self.engine.maintain(len(kinds))
            self.applied_lsn = lsn
            n += len(kinds)
        return n, self.engine.io_time_s() - io0

    def maybe_apply(self, lag: int) -> None:
        """Lazy replica apply: only when the tail exceeds ``lag`` commits."""
        if len(self._pending) >= lag:
            self.apply_pending()

    # ---------------------------------------------------------------- faults
    def crash(self, t: float) -> None:
        self.alive = False
        self.dead_since = t

    def rescan(self) -> int:
        """Re-derive the durable horizon from disk (post-corruption).

        Re-opens the WAL — the open scan truncates any invalid tail — and
        drops buffered records past the validated LSN.  Returns the LSNs
        lost (0 when the log was intact).
        """
        before = self.wal.last_lsn
        self.wal.close()
        self.wal = WriteAheadLog(self.wal_dir,
                                 segment_bytes=self._segment_bytes)
        self._pending = [r for r in self._pending
                         if r[0] <= self.wal.last_lsn]
        return before - self.wal.last_lsn

    def describe(self) -> dict:
        return {"id": self.node_id, "alive": self.alive,
                "synced": self.synced, "durable_lsn": int(self.durable_lsn),
                "applied_lsn": int(self.applied_lsn)}


class ReplicaGroup:
    """Primary + replicas for one key-range partition; see module doc."""

    def __init__(self, gid: int, directory: str, engine_factory, config:
                 ReplicationConfig, *, key_lo: int = 0, key_hi: int = 0):
        self.gid = int(gid)
        self.dir = directory
        self._factory = engine_factory
        self.config = config
        self.key_lo, self.key_hi = int(key_lo), int(key_hi)
        self._seq = 0
        self.nodes: list[ReplicaNode] = []
        self.primary: ReplicaNode | None = None
        self.last_lsn = 0                 # group commit chain head
        self.failed = False               # unrecoverable (no copy left)
        self.write_blocked_until = 0.0    # promotion-replay completion gate
        self.spike_factor = 1.0
        self.spike_until = -np.inf
        self.rebuilds: list[dict] = []    # in-flight snapshot+catch-up
        self.retired = 0                  # nodes replaced over the run
        self.failovers: list[dict] = []
        self.downtime_s = 0.0
        self.pending_down_t: float | None = None  # exact crash instant
        self.acked_rows = 0
        for k in range(config.replicas):
            node = self._new_node()
            self.nodes.append(node)
            if k == 0:
                self.primary = node

    # ------------------------------------------------------------ membership
    def _new_node(self) -> ReplicaNode:
        node_id = f"g{self.gid}/n{self._seq}"
        wal_dir = os.path.join(self.dir, f"n{self._seq}")
        self._seq += 1
        return ReplicaNode(node_id, self._factory(), wal_dir,
                           segment_bytes=self.config.segment_bytes)

    def replicas(self) -> list[ReplicaNode]:
        return [n for n in self.nodes if n is not self.primary]

    def synced_replicas(self) -> list[ReplicaNode]:
        return [n for n in self.replicas() if n.alive and n.synced]

    # ---------------------------------------------------------- availability
    def write_available(self, now: float) -> bool:
        """True when a commit attempted now would reach its ack quorum."""
        if self.failed or self.primary is None or not self.primary.alive:
            return False
        if now < self.write_blocked_until:
            return False
        return 1 + len(self.synced_replicas()) >= self.config.quorum

    def read_available(self, now: float) -> bool:
        """Reads are primary-only: alive primary past its promotion gate."""
        return (not self.failed and self.primary is not None
                and self.primary.alive and now >= self.write_blocked_until)

    def spike(self, now: float) -> float:
        return self.spike_factor if now < self.spike_until else 1.0

    # ---------------------------------------------------------------- commit
    def commit(self, kinds, keys, vals) -> tuple[int, float]:
        """Ship one group commit's writes to every in-sync copy.

        Only call when :meth:`write_available` — the caller-side gate is
        what makes commits atomic (a record is either on every in-sync
        copy and acked, or was never attempted).  Returns ``(lsn,
        charged_ack_seconds)``: the primary's fsync plus, under quorum
        acks, the ``quorum - 1``-th fastest replica fsync (the slower
        replicas finish in parallel, off the ack path).
        """
        lsn = self.last_lsn + 1
        sec = self.primary.append(kinds, keys, vals, lsn, buffer=False)
        rep_costs = sorted(r.append(kinds, keys, vals, lsn)
                           for r in self.synced_replicas())
        extra = self.config.quorum - 1
        if extra > 0:
            sec += rep_costs[extra - 1]
        self.last_lsn = lsn
        self.acked_rows += len(kinds)
        for r in self.synced_replicas():
            r.maybe_apply(self.config.apply_lag_commits)
        return lsn, sec

    def apply_primary(self, batch: OpBatch):
        """Synchronous primary apply (the serving-path engine work)."""
        res = self.primary.engine.apply(batch)
        self.primary.engine.note_applied(self.last_lsn)
        self.primary.applied_lsn = self.last_lsn
        return res

    # -------------------------------------------------------------- failover
    def promote(self, now: float) -> dict | None:
        """Primary declared dead: promote the most-caught-up live replica.

        Returns the failover record (appended to ``self.failovers``), or
        None when no live replica exists — the group is then failed for
        good (the unreplicated baseline's fate).
        """
        dead = self.primary
        t_crash = dead.dead_since if dead.dead_since is not None else now
        self.nodes = [n for n in self.nodes if n is not dead]
        self.retired += 1
        candidates = [n for n in self.nodes if n.alive]
        if not candidates:
            self.failed = True
            self.primary = None
            self.failovers.append({
                "gid": self.gid, "t_crash": float(t_crash),
                "t_detected": float(now), "outcome": "failed",
                "new_primary": None, "replayed_ops": 0,
                "promote_s": 0.0, "t_write_restored": None, "rto_s": None,
            })
            return None
        for n in candidates:
            n.rescan()                     # durable claims must be provable
        best = max(candidates, key=lambda n: n.durable_lsn)
        replayed, promote_s = best.apply_pending()
        self.primary = best
        best.synced = True
        self.last_lsn = best.durable_lsn
        self.write_blocked_until = now + promote_s
        # survivors not exactly at the new chain head cannot stay in-sync
        # (their next shipped record would leave a hole); rebuild them.
        for r in list(self.replicas()):
            if not r.alive or r.durable_lsn != self.last_lsn:
                self.nodes.remove(r)
                self.retired += 1
                self.begin_rebuild(now + promote_s)
            else:
                r.synced = True
        # replacement for the dead primary itself
        self.begin_rebuild(now + promote_s)
        ev = {
            "gid": self.gid, "t_crash": float(t_crash),
            "t_detected": float(now), "outcome": "promoted",
            "new_primary": best.node_id, "replayed_ops": int(replayed),
            "promote_s": float(promote_s),
            "t_promoted": float(now + promote_s),
            "t_write_restored": None, "rto_s": None,
        }
        self.failovers.append(ev)
        return ev

    def replace_replica(self, node: ReplicaNode, now: float) -> None:
        """A (non-primary) replica died or diverged: retire + rebuild."""
        if node in self.nodes:
            self.nodes.remove(node)
            self.retired += 1
        if not self.failed:
            self.begin_rebuild(now)

    # --------------------------------------------------------------- rebuild
    def begin_rebuild(self, t_start: float) -> dict | None:
        """Spawn a fresh replica: snapshot ship now, catch-up at ready.

        The snapshot (primary ``dump_live`` at the current chain head) is
        applied to the new engine immediately — host-side state motion —
        while the charged transfer time (device write bandwidth over the
        snapshot bytes) sets ``ready_at``; the node joins the in-sync set
        only after catch-up at that instant.  Commits meanwhile do not
        ship to it.
        """
        if self.failed or self.primary is None or not self.primary.alive:
            return None
        if len(self.nodes) + len(self.rebuilds) >= self.config.replicas:
            return None                  # already at full strength
        keys, vals = self.primary.engine.dump_live()
        node = self._new_node()
        if len(keys):
            node.engine.apply(OpBatch.inserts(keys, vals))
            node.engine.drain()
        node.engine.note_applied(self.last_lsn)
        node.applied_lsn = self.last_lsn
        node.synced = False
        dev = node.device
        transfer_s = dev.seek_s + len(keys) * PAIR_BYTES / dev.write_bw
        rb = {"node": node, "snap_lsn": int(self.last_lsn),
              "t_start": float(t_start), "snapshot_pairs": int(len(keys)),
              "ready_at": float(t_start + transfer_s)}
        self.rebuilds.append(rb)
        return rb

    def _catch_up(self, node: ReplicaNode, after_lsn: int) -> bool:
        """Replay the primary's records past ``after_lsn`` into ``node``.

        Verifies the replayed chain is contiguous through the current
        head; False (rebuild must restart) when the primary's own log has
        a hole in that span (its tail was corrupted and re-anchored after
        the snapshot was taken).
        """
        expect = after_lsn + 1
        for rec in self.primary.wal.replay(after_lsn=after_lsn):
            if rec.lsn != expect:
                return False
            node.append(rec.kinds, rec.keys, rec.vals, rec.lsn)
            expect = rec.lsn + 1
        if expect != self.last_lsn + 1:
            return False
        node.apply_pending()
        return True

    def poll_rebuilds(self, now: float) -> list[dict]:
        """Finish every rebuild whose snapshot transfer has completed."""
        done = []
        for rb in list(self.rebuilds):
            if rb["ready_at"] > now:
                continue
            self.rebuilds.remove(rb)
            if self.failed or self.primary is None or not self.primary.alive:
                continue                 # group died mid-rebuild
            if self._catch_up(rb["node"], rb["snap_lsn"]):
                rb["node"].synced = True
                self.nodes.append(rb["node"])
                done.append(rb)
            else:                        # hole in the primary's log: restart
                self.begin_rebuild(now)
        return done

    # ----------------------------------------------------------------- chaos
    def handle_event(self, ev: ChaosEvent, slot: str) -> None:
        """Apply one chaos event addressed to this group.

        ``slot`` is the stable address (``g<gid>`` = group scope /
        primary, ``g<gid>/primary``, ``g<gid>/r<k>``): it resolves to the
        *current* occupant at fire time, so a schedule written before any
        failover keeps naming meaningful victims afterwards.
        """
        if self.failed:
            return
        if ev.kind is ChaosKind.LATENCY_SPIKE:
            self.spike_factor = max(float(ev.arg), 1.0)
            self.spike_until = ev.t + max(ev.dur_s, 0.0)
            return
        node = self._resolve(slot)
        if node is None or not node.alive:
            return
        if ev.kind is ChaosKind.CRASH:
            node.crash(ev.t)
            if node is self.primary and self.pending_down_t is None:
                self.pending_down_t = ev.t
        elif ev.kind is ChaosKind.FSYNC_STALL:
            node.stall_s += float(ev.arg)
        elif ev.kind in (ChaosKind.TORN_SEGMENT, ChaosKind.BIT_FLIP):
            if ev.kind is ChaosKind.TORN_SEGMENT:
                tear_wal_tail(node.wal_dir)
            else:
                flip_wal_byte(node.wal_dir)
            lost = node.rescan()
            if node is not self.primary and lost > 0:
                # a rolled-back replica can no longer extend the chain
                # without a hole; it leaves the in-sync set and the next
                # tick retires + rebuilds it.  The primary's applied state
                # is unaffected by its own log damage (it applies
                # synchronously); its chain re-anchors on the next append.
                node.synced = False

    def _resolve(self, slot: str) -> ReplicaNode | None:
        part = slot.partition("/")[2]
        if part in ("", "primary"):
            return self.primary
        if part.startswith("r"):
            reps = sorted(self.replicas(), key=lambda n: n.node_id)
            k = int(part[1:])
            return reps[k] if k < len(reps) else None
        return None

    # ---------------------------------------------------------------- report
    def describe(self) -> dict:
        return {
            "gid": self.gid, "failed": self.failed,
            "chain_lsn": int(self.last_lsn),
            "acked_rows": int(self.acked_rows),
            "retired_nodes": int(self.retired),
            "rebuilds_in_flight": len(self.rebuilds),
            "downtime_s": float(self.downtime_s),
            "n_failovers": len(self.failovers),
            "primary": None if self.primary is None
            else self.primary.node_id,
            "nodes": [n.describe() for n in self.nodes],
        }
