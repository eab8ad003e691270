"""PyTorch/CUDA port of the NB-tree device tier (the ``repro`` package's
``core/jax_nbtree.py`` and everything it runs), for an NVIDIA H100.

Layout mirrors ``repro`` so a module's counterpart is easy to find:

* ``kernels/`` — hand-written CUDA C++ kernels for ``sm_90a`` (``csrc/``),
  their plain PyTorch versions (``ref.py``) and the one dispatch point
  (``ops.py``: a CPU tensor takes the plain version, a CUDA tensor the
  kernel);
* ``core/`` — ``torch_nbtree.NBTreeIndex`` (host control plane + torch
  impls), ``engine_api`` (the ``torch-nbtree`` StorageEngine), ``state``
  (carrying index state across from the JAX package);
* ``workloads/`` — the deterministic mix generator and the closed-loop
  driver;
* ``obs/`` — the bounded log-bucket latency histogram.

The package imports ``torch``, ``numpy`` and the standard library only.
Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no device given and no CUDA present it raises.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
