"""Seeded arrival processes: turn a workload mix into an open-loop trace
(the port's copy of ``repro/ingest/arrivals.py``).

The paper's worst-case-delay claim is an *open-loop* claim: a compaction
stall only becomes user-visible latency when requests keep arriving behind
it and queue (Luo & Carey, "On Performance Stability in LSM-based Storage
Systems").  The closed-loop driver (``workloads.driver``) measures
service time only; this module supplies the missing half — *when* each
operation arrives — so the ingest frontend (``ingest.frontend``) can
measure end-to-end latency = queueing + service on a simulated clock.

An :class:`ArrivalProcess` maps ``(rng, n)`` to ``n`` strictly ordered
arrival timestamps (seconds from 0).  Three processes cover the shapes
serving systems are sized for:

* :class:`PoissonArrivals` — memoryless open-loop load at a fixed offered
  rate (the M/G/1 baseline every saturation sweep starts from);
* :class:`MMPPArrivals` — a two-state Markov-modulated (on/off) Poisson
  process: exponentially distributed bursts of high-rate traffic separated
  by quiet periods.  Same mean rate as a Poisson process can be configured
  while the burst rate far exceeds the service rate — the adversary for
  admission control and group commit;
* :class:`DiurnalArrivals` — a nonhomogeneous Poisson process whose rate
  follows a sinusoidal day curve (peak/trough), generated by thinning.

Every process consumes its ``numpy`` Generator in a fixed order, so a trace
is a pure function of ``(process parameters, seed)`` — byte-identical
across runs and equal to the JAX package's trace for the same seed.

:func:`make_trace` pairs the timestamps with the op stream of an existing
:class:`~repro_torch.workloads.generator.Workload` (same mixes, same key
distributions, same portability envelope) into an :class:`ArrivalTrace`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.engine_api import OpBatch
from ..workloads.generator import Workload


class ArrivalProcess:
    """Base: deterministic arrival-timestamp generator."""

    name = "arrivals"

    def times(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """``n`` non-decreasing arrival timestamps (float64 seconds)."""
        raise NotImplementedError

    def describe(self) -> dict:
        """JSON-ready parameter snapshot (stamped into reports)."""
        return {"process": self.name}


class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson arrivals at ``rate`` ops/second."""

    name = "poisson"

    def __init__(self, rate: float):
        assert rate > 0.0
        self.rate = float(rate)

    def times(self, rng, n):
        return np.cumsum(rng.exponential(1.0 / self.rate, n))

    def describe(self):
        return {"process": self.name, "rate": self.rate}


class MMPPArrivals(ArrivalProcess):
    """Two-state on/off Markov-modulated Poisson process (bursty load).

    The process alternates between an *on* state emitting at ``rate_on``
    and an *off* state emitting at ``rate_off`` (often 0-ish); dwell times
    in each state are exponential with means ``mean_on_s`` / ``mean_off_s``.
    Mean offered rate = ``(rate_on*mean_on + rate_off*mean_off) /
    (mean_on + mean_off)``; burst intensity is ``rate_on`` regardless — the
    knob that drives a server past saturation *transiently* even when the
    average load is comfortable.
    """

    name = "mmpp"

    def __init__(self, rate_on: float, rate_off: float = 0.0, *,
                 mean_on_s: float = 1.0, mean_off_s: float = 1.0):
        assert rate_on > 0.0 and rate_off >= 0.0
        assert mean_on_s > 0.0 and mean_off_s > 0.0
        self.rate_on, self.rate_off = float(rate_on), float(rate_off)
        self.mean_on_s, self.mean_off_s = float(mean_on_s), float(mean_off_s)

    @property
    def mean_rate(self) -> float:
        num = self.rate_on * self.mean_on_s + self.rate_off * self.mean_off_s
        return num / (self.mean_on_s + self.mean_off_s)

    def times(self, rng, n):
        out = np.empty(n, np.float64)
        t = 0.0
        on = True                       # start in a burst: worst case first
        state_end = rng.exponential(self.mean_on_s)
        i = 0
        while i < n:
            rate = self.rate_on if on else self.rate_off
            if rate <= 0.0:
                t = state_end
            else:
                gap = rng.exponential(1.0 / rate)
                if t + gap < state_end:
                    t += gap
                    out[i] = t
                    i += 1
                    continue
                t = state_end
            on = not on
            state_end = t + rng.exponential(
                self.mean_on_s if on else self.mean_off_s)
        return out

    def describe(self):
        return {"process": self.name, "rate_on": self.rate_on,
                "rate_off": self.rate_off, "mean_on_s": self.mean_on_s,
                "mean_off_s": self.mean_off_s, "mean_rate": self.mean_rate}


class DiurnalArrivals(ArrivalProcess):
    """Nonhomogeneous Poisson with a sinusoidal rate curve (thinning).

    ``rate(t) = base_rate * (1 + amplitude * sin(2*pi*t / period_s))``;
    ``amplitude`` in [0, 1) keeps the rate positive.  ``period_s`` is the
    "day" length — shrink it so a benchmark-sized trace spans peaks and
    troughs.
    """

    name = "diurnal"

    def __init__(self, base_rate: float, *, amplitude: float = 0.8,
                 period_s: float = 60.0):
        assert base_rate > 0.0 and 0.0 <= amplitude < 1.0 and period_s > 0.0
        self.base_rate = float(base_rate)
        self.amplitude = float(amplitude)
        self.period_s = float(period_s)

    def rate_at(self, t: float) -> float:
        return self.base_rate * (
            1.0 + self.amplitude * np.sin(2.0 * np.pi * t / self.period_s))

    def times(self, rng, n):
        lam_max = self.base_rate * (1.0 + self.amplitude)
        out = np.empty(n, np.float64)
        t, i = 0.0, 0
        while i < n:
            t += rng.exponential(1.0 / lam_max)
            if rng.random() * lam_max <= self.rate_at(t):   # thinning accept
                out[i] = t
                i += 1
        return out

    def describe(self):
        return {"process": self.name, "base_rate": self.base_rate,
                "amplitude": self.amplitude, "period_s": self.period_s}


#: CLI names -> constructor.  ``rate`` is the one shared knob: the mean
#: offered rate for poisson/diurnal, the *burst* rate for mmpp (its off
#: state defaults to idle, so mean rate is rate * duty cycle).
ARRIVALS: dict = {
    "poisson": lambda rate, **kw: PoissonArrivals(rate, **kw),
    "mmpp": lambda rate, **kw: MMPPArrivals(rate, **kw),
    "diurnal": lambda rate, **kw: DiurnalArrivals(rate, **kw),
}


def make_arrivals(name: str, rate: float, **kw) -> ArrivalProcess:
    if name not in ARRIVALS:
        raise KeyError(f"unknown arrival process {name!r}; "
                       f"known: {sorted(ARRIVALS)}")
    return ARRIVALS[name](rate, **kw)


@dataclasses.dataclass
class ArrivalTrace:
    """An open-loop trace: one op stream + one timestamp per op.

    ``ops`` is the whole stream as a single columnar :class:`OpBatch`
    (sequential semantics over the full trace); ``t_arrive[i]`` is op i's
    arrival time in seconds from trace start.  ``preload`` is applied
    closed-loop before the clock starts (the YCSB load phase — it is setup,
    not offered load).
    """

    ops: OpBatch
    t_arrive: np.ndarray        # float64 (n,), non-decreasing
    preload: OpBatch
    arrival: dict               # process description (JSON-ready)
    seed: int

    def __len__(self) -> int:
        return len(self.ops)

    @property
    def duration_s(self) -> float:
        return float(self.t_arrive[-1]) if len(self.t_arrive) else 0.0


def multiplex(traces: dict) -> tuple:
    """Merge per-stream traces into one global arrival timeline.

    ``traces`` maps a stream id (e.g. a tenant id) to its
    :class:`ArrivalTrace`.  Returns ``(t, sid, local)`` — parallel arrays
    where op *k* of the merged timeline arrives at ``t[k]``, belongs to
    stream ``sid[k]``, and is that stream's op ``local[k]``.  Ordering is a
    stable merge on ``(t, sid, local)``: simultaneous arrivals resolve by
    ascending stream id then stream position, so the merged timeline — like
    everything else in the open-loop stack — is a pure function of the
    input traces: the fan-in primitive of a multi-stream frontend
    (DESIGN.md §10).
    """
    sids = sorted(traces)
    if not sids:
        return (np.zeros(0, np.float64), np.zeros(0, np.int64),
                np.zeros(0, np.int64))
    t = np.concatenate([np.asarray(traces[s].t_arrive, np.float64)
                        for s in sids])
    sid = np.concatenate([np.full(len(traces[s]), s, np.int64)
                          for s in sids])
    local = np.concatenate([np.arange(len(traces[s]), dtype=np.int64)
                            for s in sids])
    order = np.lexsort((local, sid, t))     # last key is primary
    return t[order], sid[order], local[order]


def make_trace(workload: Workload, process: ArrivalProcess, *,
               duration_s: float | None = None,
               arrival_seed: int | None = None) -> ArrivalTrace:
    """Timestamp ``workload``'s op stream with ``process`` arrivals.

    The op *content* stream is exactly the workload generator's (same seed,
    same batches, concatenated), so closed- and open-loop runs of one spec
    apply identical operations — what makes their final engine states
    comparable.  Arrival times come from an independent rng seeded with
    ``arrival_seed`` (default: the workload seed), so load shape and key
    distribution can be varied independently.  ``duration_s`` truncates the
    trace to ops arriving within the window (the offered load of a
    fixed-length experiment); the spec's ``n_ops`` is the hard cap.
    """
    spec = workload.spec
    ops = OpBatch.concat(list(workload.batches()))
    seed = spec.seed if arrival_seed is None else int(arrival_seed)
    rng = np.random.default_rng(np.random.SeedSequence([0x0A11, seed]))
    t = process.times(rng, len(ops))
    assert len(t) == len(ops) and np.all(np.diff(t) >= 0.0)
    if duration_s is not None:
        keep = int(np.searchsorted(t, float(duration_s), side="right"))
        idx = np.arange(keep)
        ops = OpBatch(ops.kinds[idx], ops.keys[idx], ops.vals[idx],
                      ops.his[idx])
        t = t[:keep]
    return ArrivalTrace(ops=ops, t_arrive=np.asarray(t, np.float64),
                        preload=workload.preload_batch(),
                        arrival=process.describe(), seed=seed)
