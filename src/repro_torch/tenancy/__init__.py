"""Multi-tenant serving front door of the port (DESIGN.md §10); the copy
of ``repro/tenancy``.

Namespaces (tenant id in the key's high bits), weighted-fair admission
(deficit round-robin over per-tenant bounded queues), per-tenant SLO
reports, and commit-watermark snapshot reads — all over ONE shared
storage engine of any tier.
"""
from .fair_queue import WeightedFairQueue
from .frontend import MultiTenantFrontend, TenantConfig, run_multi_tenant
from .namespace import NamespaceMap
from .snapshots import Snapshot, SnapshotManager

__all__ = [
    "MultiTenantFrontend",
    "NamespaceMap",
    "Snapshot",
    "SnapshotManager",
    "TenantConfig",
    "WeightedFairQueue",
    "recover_namespace",
    "run_multi_tenant",
]


def recover_namespace(directory: str, engine_factory, tenant_id: int, *,
                      namespace: NamespaceMap | None = None):
    """Rebuild ONE tenant's namespace from a shared durable directory.

    Thin wrapper over :func:`repro_torch.wal.recovery.recover` with
    ``key_range`` set to the tenant's interval: the snapshot is filtered
    to the namespace and WAL replay skips co-tenants' ops — single-tenant
    restore without paying for the co-tenants' history.
    """
    from ..wal.recovery import recover

    ns = namespace or NamespaceMap()
    return recover(directory, engine_factory,
                   key_range=ns.tenant_interval(tenant_id))
