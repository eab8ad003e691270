"""Per-tenant key namespaces over one shared engine (DESIGN.md §10); the
port's copy of ``repro/tenancy/namespace.py``.

A tenant's keys live in their own *namespace*: tenant id packed into the
high bits of the engine key, tenant-local key in the low bits::

    encoded = (tenant_id << key_bits) | local_key
    key_bits = 31 - tenant_bits          # the whole envelope stays < 2^31

The packing is collision-free by construction — distinct
``(tenant, local_key)`` pairs map to distinct encoded keys, and
``decode`` inverts ``encode`` exactly — and it preserves *order within a
namespace*: a tenant's keys occupy one contiguous interval
``[tid << key_bits | 1, tid << key_bits | max_local_key]`` of the shared
keyspace.  Contiguity is what makes everything downstream keep working
unchanged:

* a tenant RANGE ``[lo, hi]`` encodes to a contiguous scan that can never
  leak a co-tenant's rows;
* the sharded layer's :class:`~repro_torch.shard.partition.RangePartitioner`
  routes and *hot-shard-splits* encoded keys like any others — a bursty
  tenant's namespace simply splits into more shards;
* per-namespace snapshots/stats are ``dump_live_range`` over the interval;
* WAL records carry encoded keys, so tenant identity is threaded through
  the shared log for free and recovery can rebuild one namespace by
  key-interval replay (``wal``).

The 31-bit ceiling keeps the paper-tier portability envelope (uint32
device keys, see ``core.engine_api``): with the default 4 tenant
bits every tenant still owns a 2^27-key space — far above benchmark scale.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.engine_api import OpBatch, OpKind
from ..core.sorted_run import KEY_DTYPE

#: encoded keys must stay below 2^31 (uint32 device tier; engine_api).
_ENVELOPE_BITS = 31


@dataclasses.dataclass(frozen=True)
class NamespaceMap:
    """Collision-free (tenant, local key) <-> engine key packing."""

    tenant_bits: int = 4

    def __post_init__(self):
        assert 1 <= self.tenant_bits <= 12, \
            "tenant_bits outside [1, 12] leaves no usable per-tenant keyspace"

    # ------------------------------------------------------------- geometry
    @property
    def key_bits(self) -> int:
        return _ENVELOPE_BITS - self.tenant_bits

    @property
    def max_tenants(self) -> int:
        return 1 << self.tenant_bits

    @property
    def max_local_key(self) -> int:
        """Largest encodable tenant-local key (local keys are >= 1)."""
        return (1 << self.key_bits) - 1

    def describe(self) -> dict:
        return {"tenant_bits": self.tenant_bits, "key_bits": self.key_bits,
                "max_tenants": self.max_tenants,
                "max_local_key": self.max_local_key}

    # ------------------------------------------------------------ transform
    def _check_tenant(self, tenant_id: int) -> int:
        tid = int(tenant_id)
        assert 0 <= tid < self.max_tenants, \
            f"tenant id {tid} outside [0, {self.max_tenants})"
        return tid

    def encode(self, tenant_id: int, keys) -> np.ndarray:
        """Tenant-local keys -> engine keys (vectorized, checked)."""
        tid = self._check_tenant(tenant_id)
        keys = np.asarray(keys, KEY_DTYPE)
        if len(keys):
            assert int(keys.min()) >= 1 and \
                int(keys.max()) <= self.max_local_key, \
                f"tenant-local keys must lie in [1, {self.max_local_key}]"
        return (np.uint64(tid << self.key_bits) | keys).astype(KEY_DTYPE)

    def decode(self, keys) -> tuple:
        """Engine keys -> ``(tenant_ids, local_keys)`` (exact inverse)."""
        keys = np.asarray(keys, KEY_DTYPE)
        mask = np.uint64(self.max_local_key)
        return ((keys >> np.uint64(self.key_bits)).astype(np.int64),
                (keys & mask).astype(KEY_DTYPE))

    def tenant_interval(self, tenant_id: int) -> tuple:
        """The namespace's contiguous engine-key interval (inclusive)."""
        tid = self._check_tenant(tenant_id)
        base = tid << self.key_bits
        return base + 1, base + self.max_local_key

    def encode_batch(self, tenant_id: int, batch: OpBatch) -> OpBatch:
        """Rewrite a tenant-local :class:`OpBatch` into engine keyspace.

        ``keys`` encode on every row; ``his`` (the RANGE inclusive upper
        bound) encodes on RANGE rows only — other rows keep their zero
        placeholder, exactly as the protocol ignores them.
        """
        keys = self.encode(tenant_id, batch.keys)
        his = batch.his.copy()
        rmask = np.asarray(batch.kinds) == int(OpKind.RANGE)
        if rmask.any():
            his[rmask] = self.encode(tenant_id, batch.his[rmask])
        return OpBatch(batch.kinds, keys, batch.vals, his)
