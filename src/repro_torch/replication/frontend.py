"""Replicated open-loop frontend: partitioned serving with failover; the
port's copy of ``repro/replication/frontend.py``.

The replicated sibling of :class:`repro_torch.ingest.frontend.IngestFrontend`
(DESIGN.md §12): the key space is range-partitioned into replica groups
(:class:`~repro_torch.replication.replica.ReplicaGroup`), each a primary +
R−1 replicas kept in sync by WAL shipping.  The serving loop runs the
same deterministic sim clock, group commit, and admission control as the
single-engine frontend, plus the failure machinery:

* **Heartbeats** — every live node beats the shared
  :class:`~repro_torch.distributed.fault_tolerance.HeartbeatMonitor` at each
  loop tick (sim time, float).  A node silent past the timeout is
  declared dead exactly once; a dead primary triggers promotion, a dead
  replica a rebuild.
* **Graceful degradation** — ops routed to a group that cannot currently
  commit (dead primary awaiting detection, quorum short a replica,
  promotion replay in flight) are *parked*: retried with exponential
  backoff and shed at a deadline, while every other group keeps serving
  untouched — an unavailable range never head-of-line-blocks the rest.
* **Chaos** — a :class:`~repro_torch.wal.faults.FaultSchedule` fires between
  commits against stable slot addresses (``g0/primary``, ``g1/r0``,
  ``g2`` for group-wide latency spikes), so runs under chaos stay a pure
  function of (trace, config, schedule seed).

Per-group :class:`~repro_torch.obs.metrics.WindowedMetrics` timelines are
always on (they are the availability measurement: the failover benchmark
reads windowed p99.9 through a kill), and the report carries every
failover's RTO decomposition: crash → detected (heartbeat timeout) →
promoted (tail replay) → writes restored (quorum whole again).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..core.engine_api import OpBatch, OpKind
from ..distributed.fault_tolerance import HeartbeatMonitor
from ..ingest.arrivals import ArrivalTrace
from ..ingest.frontend import FrontendConfig
from ..ingest.slo import SLOTracker
from ..obs.metrics import ObsConfig, WindowedMetrics
from ..obs.trace import Tracer
from ..shard.partition import RangePartitioner
from ..wal.faults import FaultSchedule

from .replica import ReplicaGroup, ReplicationConfig

_KIND_NAMES = {int(k): k.name.lower() for k in OpKind}
_WRITE_KINDS = (int(OpKind.INSERT), int(OpKind.DELETE))
_RANGE = int(OpKind.RANGE)


class ReplicatedFrontend:
    """Open-loop serving over replicated range partitions; see module doc."""

    def __init__(self, engine_factory, directory: str, *, groups: int = 4,
                 replication: ReplicationConfig | None = None,
                 config: FrontendConfig | None = None,
                 chaos: FaultSchedule | None = None,
                 obs: ObsConfig | None = None,
                 window_s: float = 0.05, key_hi: int = 1 << 20):
        self._factory = engine_factory
        self.dir = directory
        self.n_groups_requested = int(groups)
        self.rep = replication or ReplicationConfig()
        self.config = config or FrontendConfig()
        self.chaos = chaos
        self.obs = obs if (obs is not None and obs.enabled) else None
        self.tracer = Tracer(capacity=self.obs.trace_capacity) \
            if self.obs is not None else None
        self.window_s = float(window_s)
        self.key_hi = int(key_hi)
        self.monitor = HeartbeatMonitor(
            timeout=self.rep.heartbeat_timeout_s)
        self.partitioner: RangePartitioner | None = None
        self.groups: list[ReplicaGroup] = []
        self._node_of: dict = {}       # node_id -> (group, node)
        #: every acked group commit as ``(gid, lsn, kinds, keys, vals)`` in
        #: ack order — the chaos soak test's oracle feed (a write row is in
        #: here iff its quorum fsync returned, i.e. iff it was acked).
        self.acked: list = []
        self.shed_unavailable = 0

    # -------------------------------------------------------------- topology
    def _bootstrap(self, trace: ArrivalTrace) -> None:
        """Fix the routing table and spawn every group's initial nodes."""
        if len(trace.preload):
            self.partitioner = RangePartitioner.from_sample(
                trace.preload.keys, self.n_groups_requested)
        else:
            ins = trace.ops.keys[np.asarray(trace.ops.kinds)
                                 == int(OpKind.INSERT)]
            if len(ins) >= 2 * self.n_groups_requested:
                self.partitioner = RangePartitioner.from_sample(
                    ins[:4096], self.n_groups_requested)
            else:
                self.partitioner = RangePartitioner.even(
                    self.n_groups_requested, self.key_hi)
        for gid in range(self.partitioner.n_shards):
            lo, hi = self.partitioner.interval(gid)
            g = ReplicaGroup(gid, os.path.join(self.dir, f"g{gid}"),
                             self._factory, self.rep, key_lo=lo, key_hi=hi)
            self.groups.append(g)
            for node in g.nodes:
                self._register_node(g, node)
            if self.chaos is not None:
                for slot in ([f"g{gid}", f"g{gid}/primary"]
                             + [f"g{gid}/r{k}"
                                for k in range(self.rep.replicas - 1)]):
                    self.chaos.register(
                        slot, lambda ev, g=g, s=slot: g.handle_event(ev, s))
        if len(trace.preload):
            gids = self.partitioner.shard_of(trace.preload.keys)
            for gid, g in enumerate(self.groups):
                m = gids == gid
                if not m.any():
                    continue
                sub = OpBatch.inserts(trace.preload.keys[m],
                                      trace.preload.vals[m])
                for node in g.nodes:
                    node.engine.apply(sub)
                    node.engine.drain()

    def _register_node(self, group: ReplicaGroup, node) -> None:
        self._node_of[node.node_id] = (group, node)
        self.monitor.add_host(node.node_id)

    # ------------------------------------------------------------ event pump
    def _tick(self, now: float) -> None:
        """Advance all failure machinery to ``now`` (between commits)."""
        if self.chaos is not None:
            for ev in self.chaos.fire_due(now):
                if self.tracer is not None:
                    self.tracer.instant("chaos", ev.kind.value, ev.t,
                                        target=ev.target, arg=ev.arg)
        for g in self.groups:
            for node in g.nodes:
                if node.alive:
                    self.monitor.beat(node.node_id, now)
        for host in self.monitor.advance(now):
            entry = self._node_of.get(host)
            if entry is None:
                continue
            g, node = entry
            if g.failed or node not in g.nodes:
                continue
            if node is g.primary:
                g.promote(now)
            else:
                g.replace_replica(node, now)
        for g in self.groups:
            # corruption-diverged replicas (alive, out of sync): replace.
            for r in list(g.replicas()):
                if r.alive and not r.synced:
                    g.replace_replica(r, now)
            for rb in g.poll_rebuilds(now):
                self._register_node(g, rb["node"])
                self.monitor.revive(rb["node"].node_id, now)
                if self.tracer is not None:
                    self.tracer.complete(
                        "catchup", "rebuild", rb["t_start"],
                        now - rb["t_start"], gid=g.gid,
                        node=rb["node"].node_id,
                        snapshot_pairs=rb["snapshot_pairs"])
        # write-availability transitions close out failover RTOs.
        for g in self.groups:
            wa = g.write_available(now)
            if not wa and g.pending_down_t is None and not g.failed \
                    and (g.primary is None or not g.primary.alive):
                g.pending_down_t = now
            if wa and g.pending_down_t is not None:
                t0 = g.pending_down_t
                g.pending_down_t = None
                g.downtime_s += now - t0
                for ev in reversed(g.failovers):
                    if ev["t_write_restored"] is None:
                        ev["t_write_restored"] = float(now)
                        ev["rto_s"] = float(now - ev["t_crash"])
                        if self.tracer is not None:
                            self.tracer.complete(
                                "failover", "primary_failover",
                                ev["t_crash"], ev["rto_s"], gid=g.gid,
                                new_primary=ev["new_primary"],
                                replayed_ops=ev["replayed_ops"])
                    break

    def _next_event_time(self, now: float, parked, t_arr, n) -> float | None:
        """Earliest instant anything can change while the queue is empty."""
        cands = []
        if self._i < n:
            cands.append(float(t_arr[self._i]))
        cands.extend(p[1] for p in parked)
        if self.chaos is not None and self.chaos.next_time is not None:
            cands.append(self.chaos.next_time)
        for g in self.groups:
            cands.extend(rb["ready_at"] for rb in g.rebuilds)
            if g.write_blocked_until > now:
                cands.append(g.write_blocked_until)
            for node in g.nodes:
                if not node.alive and node.node_id not in self.monitor.dead:
                    beat = self.monitor.last_beat.get(node.node_id, 0.0)
                    cands.append(beat + self.monitor.timeout)
        future = [c for c in cands if c > now]
        return min(future) if future else None

    # --------------------------------------------------------------- routing
    def _gids_of(self, i: int, kinds, keys, his) -> list[int]:
        if int(kinds[i]) == _RANGE:
            return list(self.partitioner.shards_for_range(int(keys[i]),
                                                          int(his[i])))
        return [int(self._point_gid[i])]

    def _admissible(self, i: int, now: float, kinds, keys, his) -> bool:
        write = int(kinds[i]) in _WRITE_KINDS
        for gid in self._gids_of(i, kinds, keys, his):
            g = self.groups[gid]
            ok = g.write_available(now) if write else g.read_available(now)
            if not ok:
                return False
        return True

    def _doomed(self, i: int, kinds, keys, his) -> bool:
        """True when the op targets a permanently failed group."""
        return any(self.groups[gid].failed
                   for gid in self._gids_of(i, kinds, keys, his))

    # ----------------------------------------------------------------- serve
    def run(self, trace: ArrivalTrace, *, drain: bool = True) -> dict:
        cfg, rep = self.config, self.rep
        self._bootstrap(trace)
        tracker = SLOTracker(stall_factor=cfg.stall_factor)
        gwm = [WindowedMetrics(self.window_s) for _ in self.groups]
        wm = WindowedMetrics(self.obs.window_s, stall_k=self.obs.stall_k,
                             stall_trailing=self.obs.stall_trailing) \
            if self.obs is not None else None

        kinds = np.asarray(trace.ops.kinds)
        keys_a, vals_a, his_a = (trace.ops.keys, trace.ops.vals,
                                 trace.ops.his)
        t_arr = np.asarray(trace.t_arrive, np.float64)
        n = len(kinds)
        self._point_gid = self.partitioner.shard_of(keys_a)
        queue: list[int] = []
        parked: list[list] = []     # [idx, next_t, backoff, park_deadline]
        self._i = 0
        t_free = 0.0

        def admit_until(t: float) -> None:
            i = self._i
            while i < n and t_arr[i] <= t:
                if len(queue) < cfg.max_queue:
                    queue.append(i)
                    tracker.record_queue_depth(len(queue))
                else:
                    tracker.record_shed(_KIND_NAMES[int(kinds[i])])
                i += 1
            self._i = i

        def park(i: int, now: float) -> None:
            parked.append([i, now + rep.retry_backoff_s,
                           rep.retry_backoff_s,
                           now + rep.retry_deadline_s])

        def shed_parked(i: int, now: float) -> None:
            kname = _KIND_NAMES[int(kinds[i])]
            tracker.record_shed(kname)
            self.shed_unavailable += 1
            for gid in self._gids_of(i, kinds, keys_a, his_a):
                gwm[gid].record_shed(now)
            if self.tracer is not None:
                self.tracer.instant("shed", f"unavailable_{kname}", now)

        def retry_parked(now: float) -> None:
            for p in list(parked):
                i, next_t, backoff, deadline = p
                if self._doomed(i, kinds, keys_a, his_a) or \
                        (next_t <= now and now >= deadline):
                    parked.remove(p)
                    shed_parked(i, now)
                elif next_t <= now:
                    if self._admissible(i, now, kinds, keys_a, his_a):
                        parked.remove(p)
                        queue.append(i)
                    else:
                        p[2] = min(backoff * 2, rep.retry_backoff_max_s)
                        p[1] = min(now + p[2], deadline)

        while queue or parked or self._i < n:
            now = t_free
            self._tick(now)
            admit_until(now)
            retry_parked(now)
            if not queue:
                nxt = self._next_event_time(now, parked, t_arr, n)
                if nxt is None:
                    break               # nothing left can ever happen
                t_free = nxt
                continue
            t0 = max(t_free, t_arr[queue[0]])

            # group commit: size or linger deadline, whichever first.
            if len(queue) >= cfg.commit_ops or self._i >= n:
                t_commit = t0
            else:
                deadline = t0 + cfg.linger_s
                need = cfg.commit_ops - len(queue)
                j, got = self._i, 0
                while j < n and t_arr[j] <= deadline and got < need:
                    j, got = j + 1, got + 1
                t_commit = max(t0, t_arr[j - 1]) if got == need else deadline
            admit_until(t_commit)
            self._tick(t_commit)

            # take admissible ops in order; park the rest (their range is
            # down — the queue must not head-of-line-block other ranges).
            take: list[int] = []
            for i in list(queue):
                if len(take) >= cfg.commit_ops:
                    break
                queue.remove(i)
                if self._doomed(i, kinds, keys_a, his_a):
                    shed_parked(i, t_commit)
                elif self._admissible(i, t_commit, kinds, keys_a, his_a):
                    take.append(i)
                else:
                    park(i, t_commit)
            if not take:
                t_free = max(t_commit, self._next_event_time(
                    t_commit, parked, t_arr, n) or t_commit)
                if t_free == t_commit:
                    t_free = t_commit + cfg.linger_s  # no event: idle-spin guard
                continue

            idx = np.asarray(take, np.int64)
            legs: dict[int, list[int]] = {}
            for pos, i in enumerate(take):
                for gid in self._gids_of(i, kinds, keys_a, his_a):
                    legs.setdefault(gid, []).append(pos)
            done = np.full(len(take), t_commit)
            leg_totals, debt_max = [], 0
            for gid, members in legs.items():
                g = self.groups[gid]
                sub_idx = idx[members]
                sub = OpBatch(kinds[sub_idx], keys_a[sub_idx],
                              vals_a[sub_idx], his_a[sub_idx])
                wmask = np.isin(np.asarray(sub.kinds), _WRITE_KINDS)
                wal_s = 0.0
                if wmask.any():
                    lsn, wal_s = g.commit(sub.kinds[wmask],
                                          sub.keys[wmask], sub.vals[wmask])
                    self.acked.append((gid, lsn, sub.kinds[wmask].copy(),
                                       sub.keys[wmask].copy(),
                                       sub.vals[wmask].copy()))
                res = g.apply_primary(sub)
                spike = g.spike(t_commit)
                op_service = np.asarray(res.latency_s, np.float64)
                leg_done = t_commit + spike * (wal_s + np.cumsum(op_service))
                for pos, d in zip(members, leg_done):
                    done[pos] = max(done[pos], d)
                io0 = g.primary.engine.io_time_s()
                debt = g.primary.engine.maintain(cfg.maintain_budget)
                maintain_s = g.primary.engine.io_time_s() - io0
                leg_totals.append(spike * (wal_s + float(op_service.sum()))
                                  + maintain_s)
                debt_max = max(debt_max, int(debt))
                gwm[gid].record(t_commit, done[members] - t_arr[sub_idx],
                                ops=len(members), queue_depth=len(queue),
                                debt=int(debt))
            service_s = max(leg_totals)
            e2e = done - t_arr[idx]
            tracker.record_commit(
                t_commit=t_commit,
                kinds=[_KIND_NAMES[int(k)] for k in kinds[idx]],
                e2e_s=e2e, queue_delay_s=t_commit - t_arr[idx],
                qdepth_after=len(queue), service_s=service_s,
                maintain_s=0.0, debt=debt_max)
            if self.obs is not None:
                self.tracer.complete("commit", "group_commit", t_commit,
                                     service_s, ops=len(idx),
                                     legs=len(legs))
                wm.record(t_commit, e2e, ops=len(idx),
                          queue_depth=len(queue), debt=debt_max)
            t_free = t_commit + service_s

        t_end = t_free
        self._tick(t_end)
        if drain:
            for g in self.groups:
                if g.primary is not None and g.primary.alive:
                    g.primary.engine.drain()

        offered = {name: int((kinds == k).sum())
                   for k, name in _KIND_NAMES.items()}
        report = tracker.report(offered=offered, t_end=t_end)
        report["service_model"] = "charged"
        report["config"] = dataclasses.asdict(cfg)
        failovers = [ev for g in self.groups for ev in g.failovers]
        report["replication"] = {
            "config": dataclasses.asdict(rep),
            "n_groups": len(self.groups),
            "acked_commits": len(self.acked),
            "acked_rows": int(sum(g.acked_rows for g in self.groups)),
            "shed_unavailable": int(self.shed_unavailable),
            "failovers": failovers,
            "failed_groups": [g.gid for g in self.groups if g.failed],
            "lost_acked_rows_failed_groups": int(sum(
                g.acked_rows for g in self.groups if g.failed)),
            "groups": [g.describe() for g in self.groups],
            "availability": [
                {"gid": g.gid, "downtime_s": float(g.downtime_s),
                 "timeline": gwm[g.gid].finish(t_end)}
                for g in self.groups],
        }
        if self.chaos is not None:
            report["replication"]["chaos"] = self.chaos.describe()
        if self.obs is not None:
            block = wm.finish(t_end)
            block["trace"] = {"events": len(self.tracer),
                              "dropped_events": self.tracer.dropped_events,
                              "categories": sorted(
                                  self.tracer.categories())}
            if self.obs.trace_path:
                self.tracer.save(self.obs.trace_path)
                block["trace"]["path"] = self.obs.trace_path
            report["obs"] = block
        return report


def run_replicated(engine_factory, trace: ArrivalTrace, directory: str, *,
                   groups: int = 4,
                   replication: ReplicationConfig | None = None,
                   config: FrontendConfig | None = None,
                   chaos: FaultSchedule | None = None,
                   obs: ObsConfig | None = None,
                   window_s: float = 0.05) -> dict:
    """One-call harness: serve ``trace`` on a replicated ensemble."""
    fe = ReplicatedFrontend(engine_factory, directory, groups=groups,
                            replication=replication, config=config,
                            chaos=chaos, obs=obs, window_s=window_s)
    return fe.run(trace)
