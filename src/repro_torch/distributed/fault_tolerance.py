"""Fault tolerance: heartbeats and straggler detection; the port's copy
of ``repro/distributed/fault_tolerance.py`` (numpy only).

* ``HeartbeatMonitor`` — hosts report heartbeats on any monotone clock
  (integer steps *or* float sim-seconds — the replication layer's failure
  detector drives it straight off the ingest sim clock); a host silent
  for ``timeout`` clock units is declared dead, once -> replica promotion.
* ``StragglerDetector`` — per-host step-time EWMA; hosts slower than
  ``z_threshold`` sigma above the fleet mean are flagged (the sharded
  engine's maintenance scheduler front-loads them).

The reference's ``elastic_resize`` reshards a JAX mesh from a checkpoint;
it belongs with training and distribution, which the port has not taken
yet.
"""
from __future__ import annotations

import numpy as np


class HeartbeatMonitor:
    """Per-step liveness with declare-once semantics.

    A host silent for ``timeout_steps`` is declared dead exactly once (the
    one ``advance`` call that crosses the threshold returns it; later calls
    don't re-report, so the resize/recovery it triggers fires once).  A
    beat arriving *after* the declaration is ignored — a host that was
    declared dead has already been resized away, and silently readmitting
    it would split the cluster's view; re-admission is the explicit
    :meth:`revive` path (post-restart health check).

    The clock is any monotone number: integer SPMD steps (the trainer) or
    float sim-seconds (the replication layer beats on the ingest sim
    clock).  Host ids are any hashable (ints for trainer hosts, strings
    like ``"g0/n1"`` for replica nodes).  ``timeout_steps`` is accepted as
    an alias of ``timeout`` for the original trainer call sites.
    """

    def __init__(self, hosts=(), timeout: float = 3,
                 timeout_steps: float | None = None):
        self.last_beat = {h: 0.0 for h in hosts}
        self.timeout = timeout if timeout_steps is None else timeout_steps
        self.step = 0.0
        self.dead: set = set()

    def add_host(self, host, now: float | None = None) -> None:
        """Start monitoring ``host``; its beat clock starts at ``now``."""
        self.last_beat[host] = self.step if now is None else float(now)

    def beat(self, host, now: float) -> bool:
        """Record a heartbeat; returns False (ignored) for declared-dead
        hosts — late beats do not resurrect, only :meth:`revive` does."""
        if host in self.dead:
            return False
        self.last_beat[host] = float(now)
        return True

    def advance(self, now: float) -> list:
        """Returns hosts *newly* declared dead at clock value ``now``."""
        self.step = now
        newly = [h for h, s in self.last_beat.items()
                 if h not in self.dead and now - s >= self.timeout]
        self.dead.update(newly)
        return newly

    def forget(self, host) -> None:
        """Stop monitoring ``host`` entirely (retired, not merely dead)."""
        self.last_beat.pop(host, None)
        self.dead.discard(host)

    def revive(self, host, now: float | None = None) -> None:
        """Explicitly re-admit a declared-dead (or new) host.

        The beat clock restarts at ``now`` (default: the monitor's current
        clock), so the host gets a full timeout window before it can be
        re-declared.
        """
        self.dead.discard(host)
        self.last_beat[host] = self.step if now is None else float(now)


class StragglerDetector:
    def __init__(self, hosts: list[int], alpha: float = 0.2,
                 z_threshold: float = 2.0, warmup: int = 8):
        # z capped at (n-1)/sqrt(n) for a single outlier: 2.0 keeps one
        # straggler detectable in an 8-host fleet while ~3-sigma-safe at
        # hundreds of hosts (fleet std shrinks with n).
        self.ewma = {h: None for h in hosts}
        self.alpha, self.z, self.warmup = alpha, z_threshold, warmup
        self.samples = 0

    def record(self, host, step_seconds: float) -> None:
        prev = self.ewma.get(host)
        self.ewma[host] = (step_seconds if prev is None
                           else self.alpha * step_seconds + (1 - self.alpha) * prev)
        self.samples += 1

    def stragglers(self) -> list[int]:
        if self.samples < self.warmup * len(self.ewma):
            return []
        vals = np.asarray([v for v in self.ewma.values() if v is not None])
        if len(vals) < 3:
            return []
        mu, sd = float(vals.mean()), float(vals.std() + 1e-12)
        return [h for h, v in self.ewma.items()
                if v is not None and (v - mu) / sd > self.z]

