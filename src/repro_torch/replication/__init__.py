"""Replicated shards of the port (the copy of ``repro/replication``): WAL
shipping, heartbeat failover, chaos survival.

DESIGN.md §12.  Each range partition of the key space is served by a
:class:`~.replica.ReplicaGroup` — a primary plus R−1 replicas kept in
sync by shipping group-commit WAL records (``wal`` on-disk format,
one private segment directory per node).  The
:class:`~.frontend.ReplicatedFrontend` runs the open-loop serving
protocol over the ensemble with heartbeat-driven failover: a dead
primary is detected on the sim clock, the most-caught-up replica is
promoted (WAL tail replayed), a fresh replica is rebuilt from snapshot
+ catch-up, and ops for the affected range degrade to bounded
retry-with-backoff while every other range keeps serving.  The chaos
harness (:class:`repro_torch.wal.faults.FaultSchedule`) injects crashes,
stalls, latency spikes, and physical log corruption against stable slot
addresses — the whole run stays deterministic given the schedule seed.
"""
from .frontend import ReplicatedFrontend, run_replicated
from .replica import ReplicaGroup, ReplicaNode, ReplicationConfig

__all__ = [
    "ReplicaGroup", "ReplicaNode", "ReplicatedFrontend",
    "ReplicationConfig", "run_replicated",
]
