"""Multi-tenant serving front door (DESIGN.md §10); the port's copy of
``repro/tenancy/frontend.py``.

:class:`MultiTenantFrontend` serves several tenants' open-loop arrival
traces against ONE shared storage engine on the same deterministic clock
as the single-stream :class:`~repro_torch.ingest.frontend.IngestFrontend` it
extends.  What changes is everything between arrival and group commit:

* each tenant's keys are rewritten into its :class:`NamespaceMap`
  interval, so one engine (any tier, sharded included) holds every
  namespace with zero cross-tenant key collisions and per-tenant RANGE
  stays a contiguous scan;
* admission runs through a :class:`WeightedFairQueue` — per-tenant
  bounded queues, per-tenant shed accounting, deficit-round-robin pick —
  so an aggressor overflows *its own* queue instead of starving
  co-tenants (``fair=False`` swaps back the single shared FIFO, the
  noisy-neighbor baseline the tenancy benchmark measures against);
* one :class:`~repro_torch.ingest.slo.SLOTracker` runs per tenant plus one
  aggregate, all at the run's ``stall_factor``, and each tenant's report
  carries its own p99.9 and an SLO verdict against its target;
* group commits mix tenants, and the WAL path is inherited unchanged —
  encoded keys carry tenant identity into the shared log, so
  ``wal.recovery.recover`` restores every namespace at once and
  ``key_range=namespace.tenant_interval(tid)`` restores exactly one;
* :meth:`pin_snapshot` freezes a cross-shard-consistent read view at the
  current commit watermark (``tenancy.snapshots``) that stays
  valid while ingest and emptying cascades proceed underneath.

Determinism carries over: on sim tiers the whole multi-tenant run is a
pure function of (traces, tenant configs, engine config) — byte-identical
reports across runs, and equal to the JAX package's field for field.  As
in the single-tenant frontend, the measured wall time of the load phase
is kept beside the report (``preload_wall_s``), and so are the run's live
per-tenant SLO trackers (``trackers``): a run killed mid-flight returns no
report, but its latencies up to the kill can still be summarized.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from ..core.engine_api import OpBatch, OpKind, StorageEngine
from ..ingest.arrivals import ArrivalTrace, multiplex
from ..ingest.frontend import (DurabilityConfig, FrontendConfig,
                               IngestFrontend)
from ..ingest.slo import SLOTracker
from ..wal.faults import CrashPoint, FaultInjector, reach as _reach

from .fair_queue import WeightedFairQueue
from .namespace import NamespaceMap
from .snapshots import SnapshotManager

_KIND_NAMES = {int(k): k.name.lower() for k in OpKind}


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant's identity, fair-share weight, bound and SLO target."""

    tenant_id: int
    name: str = ""
    weight: float = 1.0            # DRR share relative to peers
    max_queue: int = 4096          # this tenant's own admission bound (ops)
    #: insert end-to-end p99.9 target in seconds (None = no target); the
    #: per-tenant report carries ``slo.met`` against it.
    slo_p999_s: float | None = None

    def __post_init__(self):
        assert self.tenant_id >= 0 and self.weight > 0 and self.max_queue >= 1
        assert self.slo_p999_s is None or self.slo_p999_s > 0

    @property
    def label(self) -> str:
        return self.name or f"tenant{self.tenant_id}"


class _SharedFifo:
    """The unfair baseline: one global FIFO, one global bound.

    Same offer/take/heads/backlog/stats surface as
    :class:`WeightedFairQueue` so the frontend is agnostic; shed is
    charged to whichever tenant's op hit the full shared queue — exactly
    the cross-tenant interference fairness removes.
    """

    def __init__(self, max_queue: int):
        self.max_queue = int(max_queue)
        self._q: collections.deque = collections.deque()
        self._counters: dict[int, dict] = {}
        self._depth: dict[int, int] = {}

    def add_tenant(self, tenant_id: int, *, weight: float = 1.0,
                   max_queue: int = 0) -> None:
        self._counters[int(tenant_id)] = {
            "weight": float(weight), "offered": 0, "shed": 0, "served": 0}
        self._depth[int(tenant_id)] = 0

    def offer(self, tenant_id: int, item) -> bool:
        c = self._counters[int(tenant_id)]
        c["offered"] += 1
        if len(self._q) >= self.max_queue:
            c["shed"] += 1
            return False
        self._q.append((int(tenant_id), item))
        self._depth[int(tenant_id)] += 1
        return True

    def take(self, max_ops: int) -> list:
        out = []
        while self._q and len(out) < max_ops:
            tid, item = self._q.popleft()
            self._counters[tid]["served"] += 1
            self._depth[tid] -= 1
            out.append((tid, item))
        return out

    def heads(self) -> list:
        return [self._q[0]] if self._q else []

    def backlog(self, tenant_id: int | None = None) -> int:
        if tenant_id is None:
            return len(self._q)
        return self._depth[int(tenant_id)]

    def stats(self) -> dict:
        return {str(tid): dict(c, max_queue=self.max_queue,
                               backlog=self.backlog(tid), depth_max=None)
                for tid, c in self._counters.items()}


class MultiTenantFrontend(IngestFrontend):
    """Serve several tenants' traces on one engine; see module docstring.

    The durability plumbing (WAL group commit, periodic checkpoints,
    crash points, ``acked`` oracle) is inherited verbatim — a multi-tenant
    commit is just a group commit whose keys happen to span namespaces.
    """

    def __init__(self, engine: StorageEngine, tenants: list,
                 config: FrontendConfig | None = None,
                 durability: DurabilityConfig | None = None,
                 injector: FaultInjector | None = None, *,
                 namespace: NamespaceMap | None = None, fair: bool = True,
                 obs=None):
        super().__init__(engine, config, durability, injector, obs=obs)
        assert tenants, "at least one tenant required"
        self.tenants = {int(t.tenant_id): t for t in tenants}
        assert len(self.tenants) == len(tenants), "duplicate tenant ids"
        self.namespace = namespace or NamespaceMap()
        for t in tenants:
            self.namespace._check_tenant(t.tenant_id)
        self.fair = bool(fair)
        if self.fair:
            # quantum = commit size: one round's credit for a weight-1
            # tenant is one full commit — the finest granularity at which
            # the server can reorder service anyway.
            self.queue = WeightedFairQueue(quantum=self.config.commit_ops)
        else:
            self.queue = _SharedFifo(self.config.max_queue)
        for t in tenants:
            self.queue.add_tenant(t.tenant_id, weight=t.weight,
                                  max_queue=t.max_queue)
        self.snapshots = SnapshotManager(engine)
        self._n_commits = 0
        self.trackers: dict = {}        # tenant id -> SLOTracker of run()

    # ------------------------------------------------------------- snapshots
    def pin_snapshot(self, tenant_id: int | None = None,
                     now_s: float = 0.0):
        """Freeze a consistent read view at the current commit watermark.

        Call on a group-commit boundary (e.g. from ``run``'s ``on_commit``
        callback, or before/after ``run``).  ``tenant_id`` scopes the view
        to that namespace's interval; None pins the whole keyspace.  The
        watermark is the durable commit LSN when a WAL is attached, else
        the commit ordinal — either way the applied prefix the view equals.
        """
        wm = self.last_acked_lsn if self._wal is not None else self._n_commits
        kr = None if tenant_id is None \
            else self.namespace.tenant_interval(tenant_id)
        return self.snapshots.pin(wm, now_s, key_range=kr)

    # ----------------------------------------------------------------- running
    def run(self, traces: dict, *, drain: bool = True,
            on_commit=None) -> dict:
        """Serve every tenant's :class:`ArrivalTrace`; JSON-ready report.

        ``traces`` maps tenant id -> trace in that tenant's *local*
        keyspace (encoding is this frontend's job).  ``on_commit``, if
        given, is called as ``on_commit(frontend, t_commit)`` after every
        group commit fully lands — a commit boundary, i.e. a legal instant
        to :meth:`pin_snapshot` (how the differential snapshot tests drive
        pins mid-run, cascades still pending).
        """
        cfg = self.config
        eng = self.engine
        ns = self.namespace
        q = self.queue
        assert set(traces) == set(self.tenants), \
            "traces and tenant configs must cover the same tenant ids"

        agg = SLOTracker(stall_factor=cfg.stall_factor)
        trackers = {tid: SLOTracker(stall_factor=cfg.stall_factor)
                    for tid in self.tenants}
        self.trackers = trackers
        obs, tracer = self.obs, self.tracer
        wm = None
        if obs is not None:
            from ..obs.metrics import WindowedMetrics
            wm = WindowedMetrics(obs.window_s, stall_k=obs.stall_k,
                                 stall_trailing=obs.stall_trailing)

        # encode every tenant's ops/preload into its namespace up front —
        # one vectorized pass per tenant, and the per-commit gather below
        # stays index arithmetic.
        enc = {tid: ns.encode_batch(tid, traces[tid].ops)
               for tid in self.tenants}
        tr_t = {tid: np.asarray(traces[tid].t_arrive, np.float64)
                for tid in self.tenants}

        # load phase: closed-loop, before the clock starts.
        pre = [ns.encode_batch(tid, traces[tid].preload)
               for tid in sorted(self.tenants) if len(traces[tid].preload)]
        if pre:
            t_load0 = time.perf_counter()
            eng.apply(OpBatch.concat(pre))
            eng.drain()
            self.preload_wall_s = time.perf_counter() - t_load0
            if self._ckpt is not None:
                self._checkpoint()
                self._ckpt_service_s = 0.0

        mt, msid, mloc = multiplex(traces)
        n = len(mt)
        self._i = 0
        t_free = 0.0

        def admit_until(t: float) -> None:
            i = self._i
            # coalesced per poll (one instant per tenant+kind with a count),
            # matching the single-tenant frontend: per-op instants under a
            # sustained overload would evict every span from the trace ring
            shed_t0: dict[tuple[int, str], float] = {}
            shed_n: dict[tuple[int, str], int] = {}
            while i < n and mt[i] <= t:
                tid, loc = int(msid[i]), int(mloc[i])
                kname = _KIND_NAMES[int(enc[tid].kinds[loc])]
                if q.offer(tid, loc):
                    trackers[tid].record_queue_depth(q.backlog(tid))
                    agg.record_queue_depth(q.backlog())
                else:
                    trackers[tid].record_shed(kname)
                    agg.record_shed(kname)
                    if obs is not None:
                        shed_t0.setdefault((tid, kname), mt[i])
                        shed_n[(tid, kname)] = shed_n.get((tid, kname), 0) + 1
                        wm.record_shed(mt[i])
                i += 1
            for (tid, kname), t0 in shed_t0.items():
                tracer.instant("shed", kname, t0, tenant=tid,
                               count=shed_n[(tid, kname)])
            self._i = i

        while q.backlog() or self._i < n:
            admit_until(t_free)
            if not q.backlog():
                admit_until(mt[self._i])
            t0 = max(t_free, min(tr_t[tid][loc] for tid, loc in q.heads()))

            # ---- group commit: size or deadline, whichever first ----------
            if q.backlog() >= cfg.commit_ops or self._i >= n:
                t_commit = t0
            else:
                deadline = t0 + cfg.linger_s
                need = cfg.commit_ops - q.backlog()
                j, got = self._i, 0
                while j < n and mt[j] <= deadline and got < need:
                    j, got = j + 1, got + 1
                t_commit = max(t0, mt[j - 1]) if got == need else deadline
            admit_until(t_commit)

            take = q.take(cfg.commit_ops)
            if obs is not None and self.fair:
                # a tenant with backlog that got ZERO slots this commit was
                # deferred by the DRR scheduler — the throttle event.
                served_tids = {p[0] for p in take}
                for tid in self.tenants:
                    if tid not in served_tids and q.backlog(tid) > 0:
                        tracer.instant("tenant_throttle", "drr_defer",
                                       t_commit, tenant=int(tid),
                                       backlog=int(q.backlog(tid)))
            sel_t = np.asarray([p[0] for p in take], np.int64)
            sel_i = np.asarray([p[1] for p in take], np.int64)
            m = len(take)
            bkinds = np.empty(m, np.int8)
            bkeys = np.empty(m, np.uint64)
            bvals = np.empty(m, np.int64)
            bhis = np.empty(m, np.uint64)
            arr = np.empty(m, np.float64)
            for tid in np.unique(sel_t):
                w = sel_t == tid
                e, ii = enc[int(tid)], sel_i[w]
                bkinds[w] = e.kinds[ii]
                bkeys[w] = e.keys[ii]
                bvals[w] = e.vals[ii]
                bhis[w] = e.his[ii]
                arr[w] = tr_t[int(tid)][ii]
            batch = OpBatch(bkinds, bkeys, bvals, bhis)

            # ---- durability: WAL append + fsync BEFORE apply --------------
            wal_s = 0.0
            if self._wal is not None:
                wal_s = self._wal_commit(batch)

            # ---- service (engine clock -> simulated clock) ----------------
            res = eng.apply(batch)
            if self._wal is not None:
                eng.note_applied(self.last_acked_lsn)
                _reach(self._injector, CrashPoint.AFTER_APPLY)
            if self.sim_clock:
                op_service = np.asarray(res.latency_s, np.float64)
            else:
                op_service = np.full(m, cfg.virtual_op_service_s)
            service_s = wal_s + float(op_service.sum())

            # ---- interleaved maintenance + debt snapshot ------------------
            io1 = eng.io_time_s()
            debt = self._maintain(cfg.maintain_budget)
            io2 = eng.io_time_s()
            if self.sim_clock:
                maintain_s = io2 - io1
            else:
                maintain_s = cfg.virtual_op_service_s * cfg.maintain_budget

            self._n_commits += 1
            ckpt_s = 0.0
            if (self._ckpt is not None
                    and self.durability.checkpoint_every_commits
                    and self._n_commits
                    % self.durability.checkpoint_every_commits == 0
                    and self._wal.last_lsn > self._ckpt_lsn):
                ckpt_s = self._checkpoint()
                maintain_s += ckpt_s

            done = t_commit + wal_s + np.cumsum(op_service)
            if obs is not None:
                if wal_s > 0.0:
                    tracer.complete("wal_fsync", "fsync", t_commit, wal_s,
                                    lsn=int(self.last_acked_lsn))
                tracer.complete("commit", "group_commit", t_commit,
                                service_s, ops=m, qdepth=q.backlog())
                cascade_s = maintain_s - ckpt_s
                if cascade_s > 0.0:
                    tracer.complete("cascade", "maintain",
                                    t_commit + service_s, cascade_s,
                                    budget=cfg.maintain_budget,
                                    debt=int(debt))
                if ckpt_s > 0.0:
                    tracer.complete("checkpoint", "snapshot",
                                    t_commit + service_s + cascade_s,
                                    ckpt_s, lsn=int(self._ckpt_lsn),
                                    pairs=int(self._last_snapshot_pairs))
                wm.record(t_commit, done - arr, ops=m,
                          queue_depth=q.backlog(), debt=int(debt))
            knames = [_KIND_NAMES[int(k)] for k in bkinds]
            agg.record_commit(
                t_commit=t_commit, kinds=knames, e2e_s=done - arr,
                queue_delay_s=t_commit - arr, qdepth_after=q.backlog(),
                service_s=service_s, maintain_s=maintain_s, debt=int(debt))
            for tid in np.unique(sel_t):
                w = sel_t == tid
                trackers[int(tid)].record_commit(
                    t_commit=t_commit,
                    kinds=[kn for kn, hit in zip(knames, w) if hit],
                    e2e_s=done[w] - arr[w], queue_delay_s=t_commit - arr[w],
                    qdepth_after=q.backlog(int(tid)),
                    service_s=service_s, maintain_s=maintain_s,
                    debt=int(debt))
            t_free = t_commit + service_s + maintain_s
            if on_commit is not None:
                on_commit(self, t_commit)

        t_end = t_free
        debt_final = eng.maintain(0)
        if drain:
            eng.drain()

        # ---- report ------------------------------------------------------
        def offered_of(kind_arr) -> dict:
            k = np.asarray(kind_arr)
            return {name: int((k == kk).sum())
                    for kk, name in _KIND_NAMES.items()}

        all_kinds = np.concatenate(
            [np.asarray(traces[tid].ops.kinds) for tid in sorted(self.tenants)]
        ) if self.tenants else np.zeros(0, np.int8)
        report = agg.report(offered=offered_of(all_kinds), t_end=t_end)
        report["service_model"] = "charged" if self.sim_clock else "virtual"
        report["pending_debt_at_end"] = int(debt_final)
        report["config"] = dataclasses.asdict(cfg)
        report["fair"] = self.fair
        report["namespace"] = ns.describe()
        report["admission"] = q.stats()
        report["snapshots"] = self.snapshots.stats()
        if obs is not None:
            report["obs"] = self._finish_obs(wm, t_end)

        tenants_out = {}
        for tid in sorted(self.tenants):
            tc = self.tenants[tid]
            sub = trackers[tid].report(
                offered=offered_of(traces[tid].ops.kinds), t_end=t_end)
            lo, hi = ns.tenant_interval(tid)
            ins = sub["per_kind_e2e"].get("insert", {})
            p999 = float(ins.get("p999_s", 0.0))
            slo = {"p999_target_s": tc.slo_p999_s,
                   "observed_insert_p999_s": p999,
                   "met": (None if tc.slo_p999_s is None
                           else bool(p999 <= tc.slo_p999_s))}
            tenants_out[str(tid)] = {
                "name": tc.label, "weight": tc.weight,
                "interval": [int(lo), int(hi)],
                "live_pairs": int(eng.count_live_range(lo, hi)),
                "slo": slo, "open_loop": sub,
            }
        report["tenants"] = tenants_out

        if self._wal is not None:
            self._wal.close()
            report["durability"] = {
                "config": dataclasses.asdict(self.durability),
                "wal": self._wal.stats()
                | {"service_s_total": self._wal_service_s},
                "checkpoints": {
                    "taken": self._ckpts_taken,
                    "last_lsn": self._ckpt_lsn,
                    "last_snapshot_pairs": self._last_snapshot_pairs,
                    "service_s_total": self._ckpt_service_s,
                },
                "acked_commits": len(self.acked),
                "last_acked_lsn": self.last_acked_lsn,
            }
        return report


def run_multi_tenant(engine: StorageEngine, tenants: list, traces: dict, *,
                     config: FrontendConfig | None = None,
                     durability: DurabilityConfig | None = None,
                     namespace: NamespaceMap | None = None,
                     fair: bool = True, obs=None) -> dict:
    """One-call harness: serve every tenant's trace, full JSON report."""
    fe = MultiTenantFrontend(engine, tenants, config, durability,
                             namespace=namespace, fair=fair, obs=obs)
    ol = fe.run(traces)
    stats = engine.stats()
    return {
        "engine": engine.name,
        "tenants": {str(t.tenant_id):
                    {"name": t.label, "weight": t.weight,
                     "arrival": dict(traces[t.tenant_id].arrival),
                     "n_ops": len(traces[t.tenant_id])}
                    for t in tenants},
        "open_loop": ol,
        "stats": dataclasses.asdict(stats),
    }
