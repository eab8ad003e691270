"""Sharded storage layer of the port: partitioned ensembles of any
registered engine (the copy of ``repro/shard``).

See DESIGN.md §6.  ``make_engine("sharded:<base>", shards=N)`` (registry
prefix handled by ``core.engine_api``) or construct
:class:`ShardedEngine` directly.
"""
from .engine import ShardedEngine
from .partition import HashPartitioner, RangePartitioner
from .scheduler import DebtScheduler

__all__ = ["ShardedEngine", "RangePartitioner", "HashPartitioner",
           "DebtScheduler"]
