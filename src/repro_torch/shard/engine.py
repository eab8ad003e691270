"""ShardedEngine: range-partitioned ensemble of any registered engine; the
port's copy of ``repro/shard/engine.py``.

This is the scale-out layer of DESIGN.md §6.  ``ShardedEngine`` is itself a
:class:`~repro_torch.core.engine_api.StorageEngine`, so every driver, benchmark
and conformance test that programs against the unified protocol works on an
ensemble unchanged — ``make_engine("sharded:nbtree", shards=4)`` is a
drop-in for ``make_engine("nbtree")``.

Semantics and structure:

* **Partitioning.**  Keys are routed by a :class:`RangePartitioner` whose
  pivots are sampled as quantiles of the first insert batch (hash
  partitioning is available via ``partition="hash"``).  Point ops go to
  exactly one shard; RANGE ops fan out to every shard whose interval
  intersects ``[lo, hi]``.
* **Order-preserving split/merge.**  An incoming :class:`OpBatch` is split
  into per-shard sub-batches that keep the *original op order* (a RANGE op
  is placed into each overlapping shard's stream at its original
  position), so the sequential within-batch semantics of the protocol hold
  per shard; results are scattered back to original positions, and a
  fanned-out RANGE merges its per-shard sorted fragments with a stable
  key sort (shards are disjoint, so no cross-shard dedup is needed).
  Sub-batch selection preserves the generator's kind grouping, so a device
  shard still serves its slice in <= 4 power-of-two-padded impl calls.
* **Cross-shard deamortized maintenance.**  ``maintain(budget)`` hands the
  step budget to a :class:`DebtScheduler` (heaviest pending debt first,
  round-robin tiebreak) so the ensemble's worst-case insertion delay stays
  at the single-shard bound instead of degenerating into unscheduled
  background stalls (Luo & Carey 2019).  Leftover budget funds *hot-shard
  splitting*: when one shard's live-pair count exceeds ``skew_factor``
  times the mean of its peers, its pairs are cut at their median key into
  two fresh shards and the pivot table grows — how a moving-hotspot ingest
  is kept balanced.  The sim-clock tiers read the shard out with one
  charged RANGE op, as in the JAX package; a wall-clock (device) shard is
  read by ``dump_live_range``, which gives the same key-sorted visible
  pairs with no result cap (its RANGE op would double its capped
  ``max_results`` until a whole shard fits, rerunning the descent each
  time, and keep the doubled cap).
* **Aggregated stats.**  ``stats()`` sums the monotone I/O counters (a
  retired-shard accumulator keeps them monotone *across rebalances*),
  takes the max height, and carries the per-shard debt vector
  (``EngineStats.shard_debt``).
"""
from __future__ import annotations

import numpy as np

from ..core.engine_api import (EngineStats, OpBatch, OpKind, OpResult,
                               StorageEngine, make_engine)
from ..core.sorted_run import KEY_DTYPE, VAL_DTYPE
from ..distributed.fault_tolerance import StragglerDetector

from .partition import HashPartitioner, RangePartitioner
from .scheduler import DebtScheduler


class ShardedEngine(StorageEngine):
    """Range- (or hash-) partitioned ensemble of one registered base engine."""

    name = "sharded"

    def __init__(self, base: str = "nbtree", *, shards: int = 4,
                 partition: str = "range", skew_factor: float = 4.0,
                 min_split_pairs: int = 512, max_shards: int = 64, **base_kw):
        super().__init__()
        assert shards >= 1 and partition in ("range", "hash")
        assert skew_factor > 1.0
        self.base = base
        self.n_target = int(shards)
        self.skew_factor = float(skew_factor)
        self.min_split_pairs = int(min_split_pairs)
        self.max_shards = max(int(max_shards), int(shards))
        self._base_kw = dict(base_kw)
        self._sched = DebtScheduler()
        self._straggle: StragglerDetector | None = None
        self.partitioner = None
        self._engines: list[StorageEngine] = []
        self._debts: list[int] = []
        self._approx_live: list[int] = []   # split trigger only; never exact
        self._inherited_s: list[float] = []
        self.n_splits = 0
        # monotone counters of shards retired by rebalances
        # (io_s, seeks, rd, wr, bloom probes / skips / false positives,
        #  maintain units, maintain wall seconds, device dispatches)
        self._retired = [0.0, 0, 0, 0, 0, 0, 0, 0, 0.0, 0]
        self._tracer = None
        # the first shard is built now, so the ensemble knows its clock
        # before the first batch fixes the pivots: a frontend reads it at
        # construction (the JAX package reports "sim" until then, which
        # makes a frontend charge a device ensemble's wall seconds as
        # simulated ones)
        self._spare: StorageEngine | None = None
        self._spare = self._make_shard()
        self.clock = self._spare.clock
        if partition == "hash":
            self.partitioner = HashPartitioner(shards)
            self._spawn_all()

    # ------------------------------------------------------------ observability
    def attach_tracer(self, tracer) -> None:
        """Forward the tracer to every shard (current and future) and emit
        ensemble-level events: one ``shard_split`` instant per rebalance
        and a ``cascade`` debt-allocation instant whenever the scheduler
        hands out budget.  Event timestamps are the ensemble's *charged*
        I/O seconds — deterministic on sim tiers, and monotone."""
        self._tracer = tracer
        for e in self._engines:
            e.attach_tracer(tracer)

    # ------------------------------------------------------------ construction
    def _make_shard(self) -> StorageEngine:
        if self._spare is not None:
            eng, self._spare = self._spare, None
            return eng
        return make_engine(self.base, **self._base_kw)

    def _spawn_all(self) -> None:
        n = self.partitioner.n_shards
        self._engines = [self._make_shard() for _ in range(n)]
        self._debts = [0] * n
        self._approx_live = [0] * n
        self._inherited_s = [0.0] * n   # retired predecessors' charged time
        self._straggle = StragglerDetector(list(range(n)), warmup=4)
        if self._tracer is not None:
            for e in self._engines:
                e.attach_tracer(self._tracer)

    def _bootstrap(self, batch: OpBatch) -> None:
        """Sample range pivots from the first batch (insert keys preferred)."""
        keys = batch.keys[batch.kinds == int(OpKind.INSERT)]
        if len(keys) == 0:
            keys = batch.keys
        self.partitioner = RangePartitioner.from_sample(keys, self.n_target)
        self._spawn_all()

    @property
    def shard_engines(self) -> tuple:
        return tuple(self._engines)

    def shard_io_times(self) -> list[float]:
        """Per-shard monotone charged cost (parallel-makespan ingredient).

        A shard's lineage time includes its retired predecessors: the work a
        pre-split shard did happened serially on the same logical partition,
        so dropping it on split would make the ensemble makespan (and hence
        aggregate throughput) look better right after every rebalance.
        """
        return [inh + e.io_time_s()
                for inh, e in zip(self._inherited_s, self._engines)]

    # ------------------------------------------------------------------ apply
    def apply(self, batch: OpBatch) -> OpResult:
        n = len(batch)
        if n == 0:
            return OpResult(batch.kinds.copy(), np.zeros(0, bool),
                            np.full(0, -1, VAL_DTYPE), [], np.zeros(0))
        if self.partitioner is None:
            self._bootstrap(batch)

        kinds = np.asarray(batch.kinds)
        keys = np.asarray(batch.keys)
        his = np.asarray(batch.his)
        sid = self.partitioner.shard_of(keys)
        pos: list[list[int]] = [[] for _ in self._engines]
        for i in range(n):
            if kinds[i] == int(OpKind.RANGE):
                for s in self.partitioner.shards_for_range(int(keys[i]),
                                                           int(his[i])):
                    pos[s].append(i)
            else:
                pos[int(sid[i])].append(i)

        found = np.zeros(n, bool)
        values = np.full(n, -1, VAL_DTYPE)
        lat = np.zeros(n, np.float64)
        truncated = np.zeros(n, bool)
        range_parts: dict[int, list] = {}
        for s, idx_list in enumerate(pos):
            if not idx_list:
                continue
            idx = np.asarray(idx_list, np.int64)
            sub = OpBatch(kinds[idx], keys[idx], batch.vals[idx], his[idx])
            res = self._engines[s].apply(sub)
            pmask = np.asarray(sub.kinds) != int(OpKind.RANGE)
            pidx = idx[pmask]
            found[pidx] = res.found[pmask]
            values[pidx] = res.values[pmask]
            lat[pidx] = res.latency_s[pmask]
            for j in np.nonzero(~pmask)[0]:
                i = int(idx[j])
                range_parts.setdefault(i, []).append(res.range_hits[j])
                # fan-out runs shard-parallel: the op costs its slowest leg
                lat[i] = max(lat[i], float(res.latency_s[j]))
                truncated[i] |= bool(res.range_truncated[j])
            ins = int((np.asarray(sub.kinds) == int(OpKind.INSERT)).sum())
            dels = int((np.asarray(sub.kinds) == int(OpKind.DELETE)).sum())
            self._approx_live[s] += ins - dels
            self._debts[s] = self._engines[s].maintain(0)

        range_hits: list = [None] * n
        for i in np.nonzero(kinds == int(OpKind.RANGE))[0]:
            parts = range_parts.get(int(i), [])
            if not parts:
                range_hits[int(i)] = (np.zeros(0, KEY_DTYPE),
                                      np.zeros(0, VAL_DTYPE))
                continue
            rk = np.concatenate([p[0] for p in parts])
            rv = np.concatenate([p[1] for p in parts])
            order = np.argsort(rk, kind="stable")   # shards are disjoint
            range_hits[int(i)] = (rk[order], rv[order])
        for k in OpKind:                            # each op counted once
            self._counts[k] += int((kinds == int(k)).sum())
        return OpResult(batch.kinds.copy(), found, values, range_hits, lat,
                        truncated)

    # ------------------------------------------------------------- maintenance
    def maintain(self, budget: int = 1) -> int:
        """Debt-weighted cross-shard maintenance; returns ensemble debt."""
        if not self._engines:
            return 0
        budget = int(budget)
        slow = self._straggle.stragglers() if self._straggle else ()
        alloc = self._sched.allocate(self._debts, budget, stragglers=slow)
        if self._tracer is not None and sum(alloc) > 0:
            self._tracer.instant("cascade", "debt_alloc", self.io_time_s(),
                                 debts=list(self._debts), alloc=list(alloc),
                                 stragglers=list(slow))
        for s, units in enumerate(alloc):
            if units:
                before = self._engines[s].io_time_s()
                self._debts[s] = self._engines[s].maintain(units)
                # per-unit charged seconds feed the straggler EWMA: a shard
                # whose units cost more time is nearer a forced drain at
                # equal debt, so the scheduler front-loads it next step
                self._straggle.record(
                    s, (self._engines[s].io_time_s() - before) / units)
        if (sum(alloc) < budget and self.partitioner.can_split
                and len(self._engines) < self.max_shards):
            self._maybe_split_hot()
        return sum(self._debts)

    def drain(self) -> None:
        for e in self._engines:
            e.drain()
        self._debts = [0] * len(self._engines)

    # ------------------------------------------------------- hot-shard splits
    def _maybe_split_hot(self) -> bool:
        n = len(self._engines)
        if n < 2:       # skew is relative: a lone shard has no peers to lag
            return False
        total = sum(self._approx_live)
        s = int(np.argmax(self._approx_live))
        # compare against the mean of the *other* shards: a hot shard is
        # always part of the ensemble mean, so an inclusive-mean threshold
        # of skew_factor >= n is unreachable (max live <= n * mean) and the
        # default config would never rebalance.
        peers = max(1.0, (total - self._approx_live[s]) / (n - 1))
        if (self._approx_live[s] < self.min_split_pairs
                or self._approx_live[s] <= self.skew_factor * peers):
            return False
        return self._split_shard(s)

    def _split_shard(self, sid: int) -> bool:
        """Cut shard ``sid`` at its median live key into two fresh shards."""
        eng = self._engines[sid]
        eng.drain()
        lo, hi = self.partitioner.interval(sid)
        if eng.clock == "sim":
            # one charged RANGE op, the JAX package's extraction
            res = eng.apply(OpBatch.ranges([lo], [hi]))
            rk, rv = res.range_hits[0]
            if bool(res.range_truncated[0]):    # would drop live pairs
                raise RuntimeError(
                    f"hot-shard split of shard {sid} truncated its "
                    f"extraction range scan ({len(rk)} pairs returned)")
        else:
            rk, rv = eng.dump_live_range(lo, hi)    # uncapped, vectorised
        if len(rk) < 2:
            self._approx_live[sid] = len(rk)    # correct a stale trigger
            return False
        q = int(rk[len(rk) // 2])
        if q == int(rk[0]):                     # duplicate-heavy left half:
            above = np.nonzero(rk > rk[0])[0]   # first key that can separate
            if len(above) == 0:
                self._approx_live[sid] = len(rk)
                return False
            q = int(rk[above[0]])
        st = eng.stats()                        # keep aggregate stats monotone
        self._retired[0] += st.io_time_s
        self._retired[1] += st.io_seeks
        self._retired[2] += st.io_bytes_read
        self._retired[3] += st.io_bytes_written
        self._retired[4] += st.bloom_probes
        self._retired[5] += st.bloom_negative_skips
        self._retired[6] += st.bloom_false_positives
        self._retired[7] += st.maintain_units
        self._retired[8] += st.maintain_wall_s
        self._retired[9] += st.device_dispatches
        lineage_s = self._inherited_s[sid] + eng.io_time_s()
        left = rk < np.uint64(q)
        a, b = self._make_shard(), self._make_shard()
        if self._tracer is not None:
            a.attach_tracer(self._tracer)
            b.attach_tracer(self._tracer)
            self._tracer.instant(
                "shard_split", "split", self.io_time_s(), shard=int(sid),
                pivot=int(q), left_pairs=int(left.sum()),
                right_pairs=int((~left).sum()),
                n_shards=len(self._engines) + 1)
        a.apply(OpBatch.inserts(rk[left], rv[left]))
        b.apply(OpBatch.inserts(rk[~left], rv[~left]))
        self.partitioner.split(sid, q)
        self._engines[sid:sid + 1] = [a, b]
        self._approx_live[sid:sid + 1] = [int(left.sum()), int((~left).sum())]
        # both children continue the same partition's serial history
        self._inherited_s[sid:sid + 1] = [lineage_s, lineage_s]
        # the rewrite itself is deferred work the scheduler keeps paying off
        self._debts[sid:sid + 1] = [a.maintain(0), b.maintain(0)]
        # shard indices shifted: per-index EWMA history is stale, restart it
        self._straggle = StragglerDetector(list(range(len(self._engines))),
                                           warmup=4)
        self.n_splits += 1
        return True

    # ------------------------------------------------------------------- stats
    def io_time_s(self) -> float:
        return self._retired[0] + sum(e.io_time_s() for e in self._engines)

    def height(self) -> int:
        return max((e.height() for e in self._engines), default=0)

    def count_live(self) -> int:
        return sum(e.count_live() for e in self._engines)

    def dump_live(self) -> tuple:
        """Key-sorted union of the shard dumps (shards are disjoint)."""
        dumps = [e.dump_live() for e in self._engines]
        if not dumps:
            return (np.zeros(0, KEY_DTYPE), np.zeros(0, VAL_DTYPE))
        rk = np.concatenate([d[0] for d in dumps])
        rv = np.concatenate([d[1] for d in dumps])
        order = np.argsort(rk, kind="stable")
        return rk[order], rv[order]

    def dump_live_range(self, lo: int, hi: int) -> tuple:
        """Range-scoped dump touching only intersecting shards.

        A tenant namespace is one contiguous encoded interval
        (``tenancy``), so per-tenant snapshots and stats read a few
        shards, not the whole ensemble — the scoped counterpart of the
        RANGE fan-out.
        """
        if self.partitioner is None:
            return (np.zeros(0, KEY_DTYPE), np.zeros(0, VAL_DTYPE))
        dumps = [self._engines[s].dump_live_range(lo, hi)
                 for s in self.partitioner.shards_for_range(int(lo), int(hi))]
        if not dumps:
            return (np.zeros(0, KEY_DTYPE), np.zeros(0, VAL_DTYPE))
        rk = np.concatenate([d[0] for d in dumps])
        rv = np.concatenate([d[1] for d in dumps])
        order = np.argsort(rk, kind="stable")
        return rk[order], rv[order]

    def stats(self) -> EngineStats:
        per = [e.stats() for e in self._engines]
        debts = [e.maintain(0) for e in self._engines]
        self._debts = list(debts) if debts else self._debts
        return EngineStats(
            engine=self.name,
            clock=self.clock,
            io_time_s=self._retired[0] + sum(s.io_time_s for s in per),
            io_seeks=self._retired[1] + sum(s.io_seeks for s in per),
            io_bytes_read=self._retired[2] + sum(s.io_bytes_read for s in per),
            io_bytes_written=(self._retired[3]
                              + sum(s.io_bytes_written for s in per)),
            height=max((s.height for s in per), default=0),
            total_pairs=sum(s.total_pairs for s in per),
            physical_pairs=sum(s.physical_pairs for s in per),
            pending_debt=sum(debts),
            n_inserts=self._counts[OpKind.INSERT],
            n_deletes=self._counts[OpKind.DELETE],
            n_queries=self._counts[OpKind.QUERY],
            n_ranges=self._counts[OpKind.RANGE],
            shards=len(per) if per else self.n_target,
            shard_debt=list(debts),
            bloom_probes=self._retired[4] + sum(s.bloom_probes for s in per),
            bloom_negative_skips=(self._retired[5]
                                  + sum(s.bloom_negative_skips for s in per)),
            bloom_false_positives=(self._retired[6]
                                   + sum(s.bloom_false_positives
                                         for s in per)),
            # units/wall sum across shards (retired predecessors folded in,
            # keeping the aggregate monotone across rebalances); percentiles
            # take the per-shard max (units run shard-local — a conservative
            # ensemble tail).
            maintain_units=self._retired[7] + sum(s.maintain_units
                                                  for s in per),
            maintain_wall_s=self._retired[8] + sum(s.maintain_wall_s
                                                   for s in per),
            maintain_unit_p50_s=max((s.maintain_unit_p50_s for s in per),
                                    default=0.0),
            maintain_unit_p99_s=max((s.maintain_unit_p99_s for s in per),
                                    default=0.0),
            maintain_unit_p100_s=max((s.maintain_unit_p100_s for s in per),
                                     default=0.0),
            device_dispatches=self._retired[9] + sum(s.device_dispatches
                                                     for s in per),
            applied_lsn=self.applied_lsn)
