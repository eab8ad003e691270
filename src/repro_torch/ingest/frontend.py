"""Open-loop ingest frontend: bounded queue, group commit, simulated clock
(the port's copy of ``repro/ingest/frontend.py``).

This is the serving layer between workload generation and the storage
engines (DESIGN.md §7).  A closed-loop driver asks "how long does an op
take once the engine starts it?"; an open-loop frontend asks the question
the paper's worst-case-delay claim is actually about: *what latency does a
request experience when it arrives on its own schedule* — queueing behind
a compaction stall included.

:class:`IngestFrontend` simulates a single-server ingest node on a
deterministic clock:

* **Arrivals** come from an :class:`~repro_torch.ingest.arrivals.ArrivalTrace`
  (timestamped ops).  An op is *admitted* if the bounded ingest queue has
  room at its arrival instant, else it is **shed** (admission control —
  the knob that trades availability for bounded memory and bounded tail).
* **Group commit**: the server coalesces queued ops into an
  :class:`~repro_torch.core.engine_api.OpBatch` of up to ``commit_ops``,
  lingering at most ``linger_s`` past the moment it could first serve
  (classic group commit: size *or* deadline, whichever first).  Arrival
  order is preserved, so the protocol's sequential batch semantics match
  the trace's logical order.
* **Service** is charged from the engine's own accounting: on cost-model
  tiers (``clock == "sim"``) a batch's service time is the sum of its
  per-op simulated latencies and maintenance time is the engine's charged
  I/O delta — so the whole run is a pure function of (trace, engine
  config) and two runs produce byte-identical reports.  On the wall-clock
  device tier, real measurements are nondeterministic by nature, so the
  clock instead uses a fixed *virtual* per-op service time
  (``virtual_op_service_s``); device rows exercise the full protocol and
  queueing math deterministically, while their absolute latencies are the
  surrogate model's, flagged ``service_model: "virtual"`` in reports.
* **Maintenance** is interleaved once per commit — ``maintain(budget)``
  on the simulated clock, exactly like the closed-loop driver — and the
  engine's pending-debt snapshot is recorded at every commit, which is
  what lets :mod:`.slo` attribute tail latency to stalls and
  verify the deamortized debt bound under load.

End-to-end latency of op *i* = (commit time + its share of batch service)
- arrival time = queueing + service; the SLO tracker reports exact
p50/p99/p99.9/p100 per kind plus queue/shed/stall accounting.

* **Durability** (optional; DESIGN.md §9): with a :class:`DurabilityConfig`
  the frontend write-ahead-logs every group commit's INSERT/DELETE rows
  (``wal``) and **acks only after the record's fsync returns** — the
  ack instant *is* durability.  The fsync-per-commit cost is charged on the
  same clock as everything else: simulated seek + sequential-write seconds
  on sim tiers (through a :class:`~repro_torch.core.cost_model.CostModel` on the
  engine's own device constants), measured wall seconds on the device tier.
  Every ``checkpoint_every_commits`` commits the engine's live table is
  snapshotted (``EngineCheckpointer``) at the current commit LSN and the
  WAL is truncated past it, bounding recovery replay.  A crash at any
  point (``wal.faults``) recovers via ``wal.recovery.recover`` to exactly
  the acked prefix.

Beyond the JAX package's report (which this one equals field for field),
the frontend keeps the measured wall times a device run is judged by:
``preload_wall_s`` (load phase, apply + drain) and ``checkpoint_wall_s``
(each snapshot, the preload's first); the WAL keeps its fsync times
(``wal.fsync_s``).
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from ..core.cost_model import PAIR_BYTES, SSD
from ..core.engine_api import OpBatch, OpKind, StorageEngine
from ..obs.metrics import ObsConfig, WindowedMetrics
from ..obs.stall import attribute_stalls, detect_stalls
from ..obs.trace import Tracer
from ..wal.faults import (ChaosEvent, ChaosKind, CrashPoint, FaultInjector,
                          FaultSchedule, SimulatedCrash, flip_wal_byte,
                          reach as _reach, tear_wal_tail)

from .arrivals import ArrivalTrace
from .slo import STALL_FACTOR, SLOTracker

_KIND_NAMES = {int(k): k.name.lower() for k in OpKind}
_WRITE_KINDS = (int(OpKind.INSERT), int(OpKind.DELETE))


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Serving-node knobs (defaults sized for benchmark-scale traces)."""

    max_queue: int = 4096          # admission-control bound (ops)
    commit_ops: int = 64           # group-commit size cap
    linger_s: float = 1e-3         # group-commit deadline past first-servable
    maintain_budget: int = 1       # maintenance units interleaved per commit
    #: deterministic surrogate service time per op for wall-clock engines
    #: (see module docstring); ignored on sim tiers.
    virtual_op_service_s: float = 5e-6
    #: stall-attribution threshold (see ``ingest.slo``): a commit is
    #: a stall when its service time exceeds this multiple of the run's
    #: typical commit service.  Recorded in ``report["stalls"]`` so sweeps
    #: with different thresholds are self-describing.
    stall_factor: float = STALL_FACTOR

    def __post_init__(self):
        assert self.max_queue >= 1 and self.commit_ops >= 1
        assert self.commit_ops <= self.max_queue, \
            "a commit cannot exceed the queue bound"
        assert self.linger_s >= 0.0 and self.maintain_budget >= 0
        assert self.virtual_op_service_s > 0.0
        assert self.stall_factor > 1.0


@dataclasses.dataclass(frozen=True)
class DurabilityConfig:
    """Knobs of the WAL + checkpoint layer (DESIGN.md §9).

    ``directory`` holds ``wal/`` (redo segments) and ``checkpoints/``
    (LSN-keyed engine snapshots).  ``checkpoint_every_commits = 0``
    disables periodic snapshots (the WAL alone still makes every acked
    write recoverable; a nonempty preload is always snapshotted once
    before the clock starts, since preload is never logged).
    """

    directory: str
    segment_bytes: int = 1 << 20
    checkpoint_every_commits: int = 0

    def __post_init__(self):
        assert self.segment_bytes >= 4096
        assert self.checkpoint_every_commits >= 0


class IngestFrontend:
    """Single-server open-loop serving simulation over one engine."""

    def __init__(self, engine: StorageEngine, config: FrontendConfig | None = None,
                 durability: DurabilityConfig | None = None,
                 injector: FaultInjector | None = None,
                 obs: ObsConfig | None = None,
                 chaos: FaultSchedule | None = None):
        self.engine = engine
        self.config = config or FrontendConfig()
        self.durability = durability
        self._injector = injector
        # chaos harness (DESIGN.md §12): the single-engine frontend owns the
        # schedule's default target, ``"wal"``.  When ``chaos`` is None every
        # hook below is one attribute check — the serving loop is unchanged.
        self.chaos = chaos
        self._chaos_stall_s = 0.0       # one-shot: next commit's fsync pays it
        self._chaos_spike = 1.0         # service multiplier while spike active
        self._chaos_spike_until = 0.0
        if chaos is not None:
            chaos.register("wal", self._on_chaos)
        # observability is strictly opt-in: when ``obs`` is None (or
        # disabled) every hook below is a single attribute check, so the
        # serving loop's timings are identical to the pre-obs frontend.
        self.obs = obs if (obs is not None and obs.enabled) else None
        self.tracer: Tracer | None = None
        if self.obs is not None:
            self.tracer = Tracer(capacity=self.obs.trace_capacity)
            engine.attach_tracer(self.tracer)
        # the engine self-reports its clock domain via stats(); adapters set
        # a class attribute, so probing one snapshot is cheap and universal.
        self.sim_clock = engine.stats().clock == "sim"
        self._wal = None
        self._ckpt = None
        #: every acked group commit as ``(lsn, kinds, keys, vals)`` — the
        #: ground truth the crash-matrix tests build their oracle from (an
        #: op is in here iff its fsync returned, i.e. iff it was acked).
        self.acked: list = []
        self.last_acked_lsn = 0
        self.preload_wall_s = 0.0
        self.checkpoint_wall_s: list = []
        if durability is not None:
            from ..checkpoint.checkpointer import EngineCheckpointer
            from ..wal import CHECKPOINT_SUBDIR, WAL_SUBDIR, WriteAheadLog
            self._wal_dir = os.path.join(durability.directory, WAL_SUBDIR)
            self._wal = WriteAheadLog(
                self._wal_dir,
                segment_bytes=durability.segment_bytes, injector=injector)
            self._ckpt = EngineCheckpointer(
                os.path.join(durability.directory, CHECKPOINT_SUBDIR),
                injector=injector)
            # restart-after-crash: opening an existing directory resumes the
            # durable LSN chain where the previous frontend left it, so a
            # resumed run's first commit is ``last_lsn + 1`` (LSN
            # continuity) and its report never claims a stale watermark.
            self.last_acked_lsn = self._wal.last_lsn
            # fsync cost is charged on the engine's own device constants
            # when it has any (sim tiers); the device tier measures wall
            # time instead, so its device constant is never read.
            cm = getattr(engine, "cm", None)
            self._wal_device = cm.device if cm is not None else SSD
            self._wal_service_s = 0.0
            self._ckpt_service_s = 0.0
            self._ckpt_lsn = 0
            self._ckpts_taken = 0
            self._last_snapshot_pairs = 0

    @property
    def wal(self):
        """The durable log (None without a :class:`DurabilityConfig`)."""
        return self._wal

    # ------------------------------------------------------------------ chaos
    def _on_chaos(self, ev: ChaosEvent) -> None:
        """Apply one due chaos event to this frontend (target ``"wal"``).

        Performance faults mutate charging state consumed at the next
        commit; ``CRASH`` propagates like an injector kill (the crash-
        recovery tests' ``except SimulatedCrash`` path); the corruption
        kinds physically damage the newest WAL segment so the *next
        recovery* — not this run — sees a torn/corrupt tail.
        """
        if ev.kind is ChaosKind.FSYNC_STALL:
            self._chaos_stall_s += ev.arg
        elif ev.kind is ChaosKind.LATENCY_SPIKE:
            self._chaos_spike = max(float(ev.arg), 1.0)
            self._chaos_spike_until = ev.t + ev.dur_s
        elif ev.kind is ChaosKind.CRASH:
            # fires at a commit boundary, before the next WAL append: none
            # of the still-queued ops were acked, exactly BEFORE_WAL_APPEND.
            raise SimulatedCrash(CrashPoint.BEFORE_WAL_APPEND, 1)
        elif ev.kind is ChaosKind.TORN_SEGMENT and self._wal is not None:
            tear_wal_tail(self._wal_dir)
        elif ev.kind is ChaosKind.BIT_FLIP and self._wal is not None:
            flip_wal_byte(self._wal_dir)

    # ------------------------------------------------------------- durability
    def _wal_commit(self, batch: OpBatch) -> float:
        """Durably log the commit's writes; returns charged seconds.

        The ack instant for every write in the batch is the fsync return
        inside ``append_commit`` — a crash before it means the ops were
        never acked (and a torn record is truncated on recovery); a crash
        after it means recovery must replay them.
        """
        wmask = np.isin(np.asarray(batch.kinds), _WRITE_KINDS)
        if not wmask.any():
            return 0.0              # read-only commit: nothing to make durable
        t0 = time.perf_counter()
        lsn, nbytes = self._wal.append_commit(
            batch.kinds[wmask], batch.keys[wmask], batch.vals[wmask])
        wall = time.perf_counter() - t0
        if self.sim_clock:
            dev = self._wal_device
            sec = dev.seek_s + nbytes / dev.write_bw
        else:
            sec = wall
        self._wal_service_s += sec
        self.acked.append((lsn, batch.kinds[wmask].copy(),
                           batch.keys[wmask].copy(), batch.vals[wmask].copy()))
        self.last_acked_lsn = lsn
        # the fsync returned, so the ops above ARE acked — this crash point
        # therefore means "durable + acked, not yet applied": replay owes it.
        _reach(self._injector, CrashPoint.AFTER_WAL_FSYNC)
        return sec

    def _checkpoint(self) -> float:
        """Snapshot the engine's live table at the current commit LSN and
        truncate the WAL past it; returns charged seconds."""
        lsn = self._wal.last_lsn
        t0 = time.perf_counter()
        keys, vals = self.engine.dump_live()
        self._ckpt.save_snapshot(lsn, keys, vals)
        _reach(self._injector, CrashPoint.AFTER_CHECKPOINT)
        self._wal.truncate_upto(lsn)
        wall = time.perf_counter() - t0
        self.checkpoint_wall_s.append(wall)
        self._ckpt_lsn = lsn
        self._ckpts_taken += 1
        self._last_snapshot_pairs = len(keys)
        if self.sim_clock:
            dev = self._wal_device
            sec = dev.seek_s + len(keys) * PAIR_BYTES / dev.write_bw
        else:
            sec = wall
        self._ckpt_service_s += sec
        return sec

    def _maintain(self, budget: int) -> int:
        """``engine.maintain`` with the mid-cascade crash point threaded in
        (unit-at-a-time only when an injector is armed — the production
        path stays one call)."""
        if self._injector is None or budget <= 0:
            return self.engine.maintain(budget)
        debt = self.engine.maintain(0)
        for _ in range(int(budget)):
            if not debt:
                break
            debt = self.engine.maintain(1)
            _reach(self._injector, CrashPoint.MID_CASCADE)
        return debt

    # ------------------------------------------------------------ observability
    def _finish_obs(self, wm: WindowedMetrics, t_end: float) -> dict:
        """Close the windowed timeline, attribute stalls against the span
        buffer, optionally save the Chrome trace, and return the report
        block.  Shared by the single- and multi-tenant serving loops."""
        obs, tracer = self.obs, self.tracer
        block = wm.finish(t_end)
        stalls = detect_stalls(wm.windows, k=obs.stall_k,
                               trailing=obs.stall_trailing)
        block["stalls"] = attribute_stalls(stalls, tracer.events())
        block["trace"] = {
            "events": len(tracer),
            "dropped_events": tracer.dropped_events,
            "categories": sorted(tracer.categories()),
        }
        if obs.trace_path:
            tracer.save(obs.trace_path)
            block["trace"]["path"] = obs.trace_path
        return block

    # ----------------------------------------------------------------- running
    def run(self, trace: ArrivalTrace, *, drain: bool = True) -> dict:
        """Serve ``trace``; returns the JSON-ready open-loop report."""
        cfg = self.config
        eng = self.engine
        tracker = SLOTracker(stall_factor=cfg.stall_factor)
        obs, tracer = self.obs, self.tracer
        wm = None
        if obs is not None:
            wm = WindowedMetrics(obs.window_s, stall_k=obs.stall_k,
                                 stall_trailing=obs.stall_trailing)

        # load phase: closed-loop, before the clock starts (not offered load).
        if len(trace.preload):
            t_load0 = time.perf_counter()
            eng.apply(trace.preload)
            eng.drain()
            self.preload_wall_s = time.perf_counter() - t_load0
            if self._ckpt is not None:
                # preload is setup, not offered load — it is never WAL-logged,
                # so durability requires snapshotting it before the clock
                # starts (uncharged, like the load phase itself).
                self._checkpoint()
                self._ckpt_service_s = 0.0

        kinds = np.asarray(trace.ops.kinds)
        t_arr = np.asarray(trace.t_arrive, np.float64)
        n = len(kinds)
        queue: list[int] = []       # FIFO of admitted op indices
        self._i = 0                 # next arrival not yet admitted/shed
        self._n_commits = 0         # group commits served (checkpoint cadence)
        t_free = 0.0                # server becomes available at this time

        def admit_until(t: float) -> None:
            """Admit (or shed) every arrival with t_arrive <= t, in order.

            Occupancy only grows between commits, so evaluating arrivals in
            timestamp order against the live queue length gives each op the
            admission decision it would see at its own arrival instant.
            """
            i = self._i
            # shed instants are coalesced per poll (one event per kind with
            # a count) so a long overload burst cannot flood the trace ring
            # and evict the cascade/checkpoint spans attribution needs
            shed_t0: dict[str, float] = {}
            shed_n: dict[str, int] = {}
            while i < n and t_arr[i] <= t:
                if len(queue) < cfg.max_queue:
                    queue.append(i)
                    tracker.record_queue_depth(len(queue))
                else:
                    kname = _KIND_NAMES[int(kinds[i])]
                    tracker.record_shed(kname)
                    if obs is not None:
                        shed_t0.setdefault(kname, t_arr[i])
                        shed_n[kname] = shed_n.get(kname, 0) + 1
                        wm.record_shed(t_arr[i])
                i += 1
            for kname, t0 in shed_t0.items():
                tracer.instant("shed", kname, t0, count=shed_n[kname])
            self._i = i

        while queue or self._i < n:
            admit_until(t_free)
            if not queue:
                # idle: jump the clock to the next arrival (plus any ties).
                admit_until(t_arr[self._i])
            t0 = max(t_free, t_arr[queue[0]])

            # ---- group commit: size or deadline, whichever first ----------
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

            take = queue[: cfg.commit_ops]
            del queue[: len(take)]
            idx = np.asarray(take, np.int64)
            batch = OpBatch(kinds[idx], trace.ops.keys[idx],
                            trace.ops.vals[idx], trace.ops.his[idx])

            # ---- chaos: due events fire at the commit boundary ------------
            if self.chaos is not None:
                for ev in self.chaos.fire_due(t_commit):
                    if obs is not None:
                        tracer.instant("chaos", ev.kind.value, t_commit,
                                       target=ev.target, arg=ev.arg)

            # ---- durability: WAL append + fsync BEFORE apply --------------
            # (write-ahead rule; the fsync return is the ack instant, and
            # its cost is part of the commit's service time on this clock.)
            wal_s = 0.0
            if self._wal is not None:
                wal_s = self._wal_commit(batch)
            if self._chaos_stall_s > 0.0:
                # a pending FSYNC_STALL charges the next commit exactly once
                wal_s += self._chaos_stall_s
                if self._wal is not None:
                    self._wal_service_s += self._chaos_stall_s
                self._chaos_stall_s = 0.0

            # ---- service (engine clock -> simulated clock) ----------------
            # apply cost is charged through per-op latencies (the engine's
            # foreground share); maintenance through the charged-I/O delta.
            res = eng.apply(batch)
            if self._wal is not None:
                eng.note_applied(self.last_acked_lsn)
                _reach(self._injector, CrashPoint.AFTER_APPLY)
            if self.sim_clock:
                op_service = np.asarray(res.latency_s, np.float64)
            else:
                op_service = np.full(len(idx), cfg.virtual_op_service_s)
            if self._chaos_spike > 1.0 and t_commit < self._chaos_spike_until:
                # LATENCY_SPIKE window: every charged second costs ``arg``×
                op_service = op_service * self._chaos_spike
                wal_s *= self._chaos_spike
            service_s = wal_s + float(op_service.sum())

            # ---- interleaved maintenance + debt snapshot ------------------
            io1 = eng.io_time_s()
            debt = self._maintain(cfg.maintain_budget)
            io2 = eng.io_time_s()
            if self.sim_clock:
                maintain_s = io2 - io1
            else:
                maintain_s = cfg.virtual_op_service_s * cfg.maintain_budget

            # ---- periodic checkpoint: snapshot @ LSN, truncate WAL --------
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
            tracker.record_commit(
                t_commit=t_commit,
                kinds=[_KIND_NAMES[int(k)] for k in kinds[idx]],
                e2e_s=done - t_arr[idx],
                queue_delay_s=t_commit - t_arr[idx],
                qdepth_after=len(queue),
                service_s=service_s, maintain_s=maintain_s, debt=int(debt))
            if obs is not None:
                # spans carry *charged* durations on the same clock as the
                # latency math, so the saved trace is byte-deterministic on
                # sim tiers (and virtual-clock-consistent on the device tier)
                if wal_s > 0.0:
                    tracer.complete("wal_fsync", "fsync", t_commit, wal_s,
                                    lsn=int(self.last_acked_lsn))
                tracer.complete("commit", "group_commit", t_commit,
                                service_s, ops=len(idx),
                                qdepth=len(queue))
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
                wm.record(t_commit, done - t_arr[idx], ops=len(idx),
                          queue_depth=len(queue), debt=int(debt))
            t_free = t_commit + service_s + maintain_s

        t_end = t_free
        debt_final = eng.maintain(0)
        if drain:
            eng.drain()

        offered = {name: int((kinds == k).sum())
                   for k, name in _KIND_NAMES.items()}
        report = tracker.report(offered=offered, t_end=t_end)
        report["service_model"] = "charged" if self.sim_clock else "virtual"
        report["pending_debt_at_end"] = int(debt_final)
        report["config"] = dataclasses.asdict(self.config)
        if obs is not None:
            report["obs"] = self._finish_obs(wm, t_end)
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
        if self.chaos is not None:
            report["chaos"] = self.chaos.describe()
        return report


def run_open_loop(engine: StorageEngine, trace: ArrivalTrace, *,
                  config: FrontendConfig | None = None,
                  durability: DurabilityConfig | None = None,
                  obs: ObsConfig | None = None,
                  chaos: FaultSchedule | None = None) -> dict:
    """One-call harness: serve ``trace`` on ``engine``, full JSON report.

    The returned dict mirrors the closed-loop driver report shape (engine
    name, arrival description, final ``stats()`` snapshot) with the
    open-loop SLO section under ``"open_loop"``.
    """
    fe = IngestFrontend(engine, config, durability=durability, obs=obs,
                        chaos=chaos)
    ol = fe.run(trace)
    stats = engine.stats()
    return {
        "engine": engine.name,
        "arrival": dict(trace.arrival),
        "trace": {"n_ops": len(trace), "duration_s": trace.duration_s,
                  "seed": trace.seed, "preload_pairs": len(trace.preload)},
        "open_loop": ol,
        "stats": dataclasses.asdict(stats),
    }
