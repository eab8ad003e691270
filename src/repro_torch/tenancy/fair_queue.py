"""Weighted-fair admission: deficit round-robin over per-tenant queues; the
port's copy of ``repro/tenancy/fair_queue.py``.

The single-tenant frontend (``ingest.frontend``) admits through one
bounded FIFO — an aggressor that bursts faster than the engine drains
fills the shared queue and every co-tenant's ops get shed or stall behind
the backlog.  This module replaces that FIFO with one *bounded queue per
tenant* plus a deficit-round-robin (DRR) scheduler deciding whose ops the
next group commit serves:

* **Isolation at admission.**  ``offer`` sheds against the offering
  tenant's *own* bound only; an aggressor overflows its own queue while
  its co-tenants' queues stay shallow.  Shed counts are per-tenant.
* **Weighted service.**  Each scheduler round credits every backlogged
  tenant ``quantum x weight`` ops of *deficit*; ``take`` drains a
  tenant's queue only down to its deficit.  Over any backlogged interval
  tenant service converges to the weight ratio — the classic DRR
  guarantee (the error is bounded by one quantum per tenant per round).
* **Work conservation.**  ``take`` never idles while any queue is
  non-empty: the round-robin pointer skips empty queues and deficits
  reset when a queue empties, so credit cannot be hoarded while idle.

Ops are held as ``(t_arrive, local index)`` pairs against the tenant's
trace — the queue stores positions, not payloads, mirroring the
single-tenant frontend.
"""
from __future__ import annotations

import collections
import dataclasses


@dataclasses.dataclass
class _TenantState:
    weight: float
    max_queue: int
    q: collections.deque = dataclasses.field(
        default_factory=collections.deque)
    deficit: float = 0.0
    offered: int = 0
    shed: int = 0
    served: int = 0
    depth_max: int = 0


class WeightedFairQueue:
    """Per-tenant bounded queues + DRR pick; see module docstring.

    ``quantum`` is the per-round deficit credit of a weight-1.0 tenant, in
    ops.  It should be of the order of the group-commit batch size: much
    smaller wastes scheduler rounds, much larger degrades fairness
    granularity toward FIFO bursts.
    """

    def __init__(self, *, quantum: int = 64):
        assert quantum >= 1
        self.quantum = int(quantum)
        self._tenants: dict[int, _TenantState] = {}
        self._order: list[int] = []       # round-robin scan order (sorted)
        self._cursor = 0                  # next tenant the scan starts from
        self._mid_visit = False           # cursor tenant holds unspent credit

    def add_tenant(self, tenant_id: int, *, weight: float = 1.0,
                   max_queue: int = 4096) -> None:
        tid = int(tenant_id)
        assert tid not in self._tenants, f"tenant {tid} already registered"
        assert weight > 0 and max_queue >= 1
        self._tenants[tid] = _TenantState(float(weight), int(max_queue))
        self._order = sorted(self._tenants)
        self._cursor = 0

    # ----------------------------------------------------------- admission
    def offer(self, tenant_id: int, item) -> bool:
        """Enqueue one op for ``tenant_id``; False = shed (queue full)."""
        st = self._tenants[int(tenant_id)]
        st.offered += 1
        if len(st.q) >= st.max_queue:
            st.shed += 1
            return False
        st.q.append(item)
        st.depth_max = max(st.depth_max, len(st.q))
        return True

    # ------------------------------------------------------------- service
    def take(self, max_ops: int) -> list:
        """Dequeue up to ``max_ops`` items as ``(tenant_id, item)`` pairs.

        Runs DRR *visits* until the budget is filled or every queue is
        empty.  A visit credits the tenant ``quantum x weight`` once, then
        serves down to its deficit; a visit cut short by the op budget (not
        by an exhausted deficit) resumes at the same tenant with its
        *remaining* credit on the next call — never a fresh quantum —
        which is what stops a deep-queued tenant from re-crediting itself
        every group commit and monopolizing the server.  Across calls the
        cursor persists, so no tenant is systematically scanned first.
        """
        out: list = []
        n = len(self._order)
        if n == 0 or max_ops <= 0:
            return out
        idle_scans = 0
        while len(out) < max_ops and idle_scans < n:
            tid = self._order[self._cursor]
            st = self._tenants[tid]
            if not st.q:
                st.deficit = 0.0          # credit must not accrue while idle
                self._mid_visit = False
                self._cursor = (self._cursor + 1) % n
                idle_scans += 1
                continue
            idle_scans = 0
            if not self._mid_visit:
                st.deficit += self.quantum * st.weight
                self._mid_visit = True
            while st.q and st.deficit >= 1.0 and len(out) < max_ops:
                out.append((tid, st.q.popleft()))
                st.deficit -= 1.0
                st.served += 1
            if not st.q:
                st.deficit = 0.0
            if st.q and st.deficit >= 1.0:
                break       # op budget cut the visit short: resume here
            # visit complete (deficit spent or queue drained): move on.
            self._mid_visit = False
            self._cursor = (self._cursor + 1) % n
        return out

    # --------------------------------------------------------------- state
    def heads(self) -> list:
        """``(tenant_id, item)`` at the head of every non-empty queue."""
        return [(tid, self._tenants[tid].q[0])
                for tid in self._order if self._tenants[tid].q]

    def backlog(self, tenant_id: int | None = None) -> int:
        if tenant_id is not None:
            return len(self._tenants[int(tenant_id)].q)
        return sum(len(st.q) for st in self._tenants.values())

    @property
    def tenant_ids(self) -> list[int]:
        return list(self._order)

    def stats(self) -> dict:
        """Per-tenant admission ledger (JSON-ready)."""
        return {
            str(tid): {
                "weight": st.weight,
                "max_queue": st.max_queue,
                "offered": st.offered,
                "shed": st.shed,
                "served": st.served,
                "backlog": len(st.q),
                "depth_max": st.depth_max,
            }
            for tid, st in self._tenants.items()
        }
