"""Cross-shard deamortized maintenance scheduling (DESIGN.md §6); the
port's copy of ``repro/shard/scheduler.py``.

The paper's worst-case insertion-delay bound comes from spending a bounded
amount of maintenance per serving step (Sec. 5.1).  A sharded ensemble
breaks that bound if the step budget is spent obliviously: Luo & Carey
("On Performance Stability in LSM-based Storage Systems") show that
unscheduled background maintenance across partitions is exactly what
reintroduces write stalls at scale-out.  The fix is the same deamortization
argument applied one level up — each serving step's budget is *allocated*
across shards so the shard closest to a forced synchronous drain is always
served first.

:class:`DebtScheduler` is that allocator, kept as a pure, deterministic
strategy object so it can be unit-tested without engines: given the current
per-shard debt vector and a unit budget it returns how many maintenance
units each shard receives this step.  Policy: one unit at a time to the
heaviest *remaining* (optimistically decremented) debt, ties broken by a
persistent round-robin pointer so equally-indebted shards share the budget
fairly across steps instead of the lowest id starving the rest.

Straggler-aware priority: shards flagged by the caller (a
``StragglerDetector`` over per-unit maintain seconds, see
``ShardedEngine.maintain``) have their remaining debt *weighted* by
``straggler_boost`` when choosing where the next unit goes.  The units a
slow shard owes cost more charged seconds each, so at equal debt counts
it is closer — in time — to a forced synchronous drain; front-loading it
caps the ensemble's worst maintain tail.  Measured on a 4-shard skewed
ingest (one shard on a device with 4x per-unit cost, the JAX package's
``tests/test_replication.py::test_straggler_boost_drains_slow_shard``)
the boost cuts the slow shard's peak outstanding debt roughly in half
with unchanged total units; with no straggler flagged the allocation is
bit-identical to the unweighted policy, so the hook is kept.
"""
from __future__ import annotations


class DebtScheduler:
    """Debt-weighted, round-robin-tiebroken budget allocator."""

    def __init__(self, straggler_boost: float = 2.0):
        assert straggler_boost >= 1.0
        self._rr = 0  # persistent tiebreak pointer (fairness across calls)
        self.straggler_boost = float(straggler_boost)

    def allocate(self, debts, budget: int, stragglers=()) -> list[int]:
        """Distribute ``budget`` maintenance units over ``debts``.

        Returns a per-shard unit allocation with ``sum(alloc) ==
        min(budget, sum(debts))``.  Each unit goes to the shard with the
        highest remaining debt (debt is optimistically decremented by one
        per granted unit; the engine refreshes true debt from the shard's
        ``maintain`` return value afterwards).  Exact ties go to the shard
        at or after the round-robin pointer, which then advances — so a
        uniformly indebted ensemble is served in rotation, not by id.

        Shards listed in ``stragglers`` compete with ``remaining *
        straggler_boost`` as their effective debt — extra budget for
        persistently slow shards, never units they don't owe (a shard
        with zero remaining debt gets nothing regardless of flags).
        """
        remaining = [int(d) for d in debts]
        alloc = [0] * len(remaining)
        n = len(remaining)
        slow = set(stragglers)
        boost = self.straggler_boost
        for _ in range(max(0, int(budget))):
            best, best_debt = -1, 0.0
            for off in range(n):
                s = (self._rr + off) % n
                eff = remaining[s] * (boost if s in slow else 1.0)
                if eff > best_debt:
                    best, best_debt = s, eff
            if best < 0:
                break
            alloc[best] += 1
            remaining[best] -= 1
            self._rr = (best + 1) % n
        return alloc
