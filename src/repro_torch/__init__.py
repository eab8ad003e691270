"""PyTorch/CUDA port of the ``repro`` package for an NVIDIA H100: the
NB-tree device tier (``core/jax_nbtree.py`` and everything it runs), the
layers over it (ingest, durability, sharding, tenancy, replication, the
host comparison tiers) and the paged-KV serving bridge (``serve/`` and
the models it decodes).

Layout mirrors ``repro`` so a module's counterpart is easy to find:

* ``kernels/`` — hand-written CUDA C++ kernels for ``sm_90a`` (``csrc/``),
  their plain PyTorch versions and the one dispatch point (``ops.py``: a
  CPU tensor takes the plain version, a CUDA tensor the kernel);
* ``core/`` — ``torch_nbtree.NBTreeIndex`` (host control plane + torch
  impls), ``engine_api`` (the ``torch-nbtree`` StorageEngine, the host
  tiers and the registry), the host tiers' structures (``refimpl``,
  ``lsm``, ``btree``, ``bepsilon``), ``state`` (carrying index state
  across from the JAX package);
* ``configs/``, ``models/`` — the config dataclasses and the dense
  transformer stack (qwen3-8b), ``convert`` carrying JAX weights across;
* ``serve/`` — the paged KV cache over the NB-tree, the engine, the steps;
* ``launch/`` — the serving CLI; ``workloads/`` — the mix generator, the
  tenant scenarios and the driver (closed and open loop, one stream or
  several, replicated); ``obs/`` — histograms, windowed metrics, traces;
* ``ingest/``, ``wal/``, ``checkpoint/`` — the open-loop frontend, the
  write-ahead log, snapshots and recovery; ``shard/`` — partitioned
  ensembles of any engine; ``tenancy/`` — the multi-tenant frontend;
  ``replication/`` — replicated range groups (sim-clock tiers);
  ``distributed/`` — heartbeats and straggler detection.

The package imports ``torch``, ``numpy`` and the standard library only.
Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no device given and no CUDA present it raises.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
