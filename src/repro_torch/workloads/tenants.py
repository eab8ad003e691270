"""Multi-tenant workload scenarios (tenant mixes + arrival processes); the
port's copy of ``repro/workloads/tenants.py``.

Couples the single-stream building blocks — :mod:`.generator` op mixes
and :mod:`repro_torch.ingest.arrivals` processes — into named
*scenarios*: a set of tenants, each with its own mix, key space, arrival
process, fair-share weight and SLO target.  The canonical one is
``noisy-neighbor`` (two steady well-behaved tenants + one bursty MMPP
aggressor), the workload behind the JAX package's
``benchmarks/fig_tenancy.py``.

Everything is deterministic per seed: each tenant's op stream and arrival
clock get independent seeds derived from ``(scenario seed, tenant id)``,
so adding a tenant never perturbs another tenant's trace.
"""
from __future__ import annotations

import dataclasses

from ..ingest.arrivals import (DiurnalArrivals, MMPPArrivals,
                               PoissonArrivals, make_trace)
from ..tenancy import TenantConfig
from .generator import make_workload

#: tenant-local key spaces stay small: every tenant must fit its namespace
#: interval (2^27 keys at the default 4 tenant bits) with range-scan slack.
_TENANT_KEY_SPACE = 1 << 20


@dataclasses.dataclass(frozen=True)
class TenantStream:
    """One tenant's serving contract plus the trace recipe behind it."""

    tenant: TenantConfig
    mix: str = "insert-heavy"
    arrival: dict = dataclasses.field(
        default_factory=lambda: {"process": "poisson", "rate": 2000.0})
    n_ops: int = 4096
    preload: int = 1024
    key_space: int = _TENANT_KEY_SPACE

    def make_process(self):
        a = dict(self.arrival)
        kind = a.pop("process")
        if kind == "poisson":
            return PoissonArrivals(**a)
        if kind == "mmpp":
            return MMPPArrivals(**a)
        if kind == "diurnal":
            return DiurnalArrivals(**a)
        raise KeyError(f"unknown arrival process {kind!r}")


def build_streams(streams: list, *, seed: int = 0) -> tuple:
    """Expand streams into ``(tenants, traces)`` for the frontend.

    Per-tenant seeds are ``seed*1000 + tenant_id`` on the op stream and
    the same on the arrival clock — independent across tenants, stable
    under adding/removing co-tenants.
    """
    tenants, traces = [], {}
    for s in streams:
        tid = s.tenant.tenant_id
        assert tid not in traces, f"duplicate tenant id {tid}"
        wl = make_workload(s.mix, n_ops=s.n_ops, preload=s.preload,
                           key_space=s.key_space,
                           seed=seed * 1000 + tid)
        traces[tid] = make_trace(wl, s.make_process(),
                                 arrival_seed=seed * 1000 + tid)
        tenants.append(s.tenant)
    return tenants, traces


# --------------------------------------------------------------- scenarios
def noisy_neighbor(*, n_ops: int = 4096, victim_rate: float = 2000.0,
                   aggressor_rate: float = 40000.0,
                   victim_weight: float = 2.0,
                   aggressor_queue: int = 1024,
                   aggressor_ops: int | None = None,
                   slo_p999_s: float | None = None) -> list:
    """Two steady insert-heavy victims + one bursty MMPP aggressor.

    The aggressor's burst rate is the sweep knob: past the engine's drain
    rate, an unfair (shared-FIFO) frontend lets its bursts camp the queue
    and inflate the victims' p99.9 without bound, while fair queuing sheds
    the aggressor against its own bound and holds the victims near their
    solo latency — the claim ``fig_tenancy`` checks.
    """
    victims = [
        TenantStream(
            tenant=TenantConfig(tid, name=f"steady{tid}",
                                weight=victim_weight,
                                slo_p999_s=slo_p999_s),
            mix="insert-heavy", n_ops=n_ops,
            arrival={"process": "poisson", "rate": victim_rate})
        for tid in (0, 1)
    ]
    # default aggressor length: ~cover the victims' trace window at the
    # MMPP mean rate (rate_on x 50% duty) so the bursts overlap the whole
    # measured run instead of ending early.
    if aggressor_ops is None:
        aggressor_ops = max(2 * n_ops, int(aggressor_rate / 2
                                           * (n_ops / victim_rate)))
    aggressor = TenantStream(
        tenant=TenantConfig(2, name="aggressor", weight=1.0,
                            max_queue=aggressor_queue),
        mix="insert-heavy", n_ops=aggressor_ops,
        arrival={"process": "mmpp", "rate_on": aggressor_rate,
                 "rate_off": 0.0, "mean_on_s": 0.05, "mean_off_s": 0.05})
    return victims + [aggressor]


def mixed_oltp(*, n_ops: int = 4096, base_rate: float = 2000.0) -> list:
    """Heterogeneous mixes: writer, point-reader, scanner, diurnal blend.

    Exercises namespace isolation across op kinds — the scanner's RANGEs
    stay inside its own interval no matter what the writer inserts.
    """
    return [
        TenantStream(
            tenant=TenantConfig(0, name="writer", weight=2.0),
            mix="insert-heavy", n_ops=n_ops,
            arrival={"process": "poisson", "rate": base_rate}),
        TenantStream(
            tenant=TenantConfig(1, name="reader", weight=1.0),
            mix="point-read-heavy", n_ops=n_ops,
            arrival={"process": "poisson", "rate": base_rate / 2}),
        TenantStream(
            tenant=TenantConfig(2, name="scanner", weight=1.0),
            mix="ycsb-e", n_ops=n_ops // 2,
            arrival={"process": "poisson", "rate": base_rate / 4}),
        TenantStream(
            tenant=TenantConfig(3, name="diurnal", weight=1.0),
            mix="ycsb-a", n_ops=n_ops,
            arrival={"process": "diurnal", "base_rate": base_rate,
                     "amplitude": 0.8, "period_s": 2.0}),
    ]


#: scenario name -> factory returning ``list[TenantStream]``.
SCENARIOS: dict = {
    "noisy-neighbor": noisy_neighbor,
    "mixed-oltp": mixed_oltp,
}


def build_scenario(name: str, *, seed: int = 0, **overrides) -> tuple:
    """``(tenants, traces)`` for a named scenario; overrides reach the
    scenario factory (rates, sizes, weights — see each factory)."""
    return build_streams(SCENARIOS[name](**overrides), seed=seed)
