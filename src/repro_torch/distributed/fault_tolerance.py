"""Fault tolerance: heartbeats, straggler detection, elastic resize; the
port's copy of ``repro/distributed/fault_tolerance.py``.

* ``HeartbeatMonitor`` — hosts report heartbeats on any monotone clock
  (integer steps *or* float sim-seconds — the replication layer's failure
  detector drives it straight off the ingest sim clock); a host silent
  for ``timeout`` clock units is declared dead, once -> replica promotion.
* ``StragglerDetector`` — per-host step-time EWMA; hosts slower than
  ``z_threshold`` sigma above the fleet mean are flagged (the sharded
  engine's maintenance scheduler front-loads them).
* ``elastic_resize`` — restores a checkpointed train state onto a
  *different* mesh (fewer ranks after a host died): every rank reads the
  full arrays and keeps its pieces for the new mesh's placements
  (``checkpoint/checkpointer.py``, ``distributed/sharding.py``).  The
  caller builds its train step for the new mesh; training resumes with a
  proportionally smaller global batch, or the same batch over more
  microbatches (the caller's policy).
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



def elastic_resize(checkpointer, step: int, state_like, new_mesh,
                   param_specs_fn):
    """Restore checkpointed state onto a *different* mesh.

    ``state_like`` = ``{"params": {name: tensor}, "opt": {"m", "v",
    "count"}}`` gives names, shapes and dtypes (the structure the trainer
    checkpoints; its leaves may be on ``meta``).  ``param_specs_fn(params,
    mesh)`` gives each parameter's spec (``sharding.param_specs``).
    Returns that state with the parameters, ``m`` and ``v`` DTensors placed
    for ``new_mesh`` and ``count`` on its device; the caller makes its
    train step with the new mesh (``sharding.shard_model(model, new_mesh,
    params=...)`` puts the parameters in a model).
    """
    import torch

    from .sharding import placements

    specs = param_specs_fn(state_like["params"], new_mesh)
    places = {}
    for name, spec in specs.items():
        pl = (new_mesh, placements(spec, new_mesh))
        for prefix in ("params", "opt.m", "opt.v"):
            places[f"{prefix}.{name}"] = pl
    return checkpointer.restore(step, state_like, placements=places,
                                device=torch.device(new_mesh.device_type))
