"""Device meshes for training.

The port of ``repro/launch/mesh.py``: ``torch.distributed``'s
``DeviceMesh`` in place of ``jax.make_mesh``.

Single pod : (16, 16)    axes ("data", "model")        = 256 ranks
Multi-pod  : (2, 16, 16) axes ("pod", "data", "model") = 512 ranks

Both are *functions*, and ``torch.distributed`` is imported inside them,
so importing this module touches no device and no process group.  A mesh
needs a process group of exactly its size: ``init_device_mesh`` uses the
default group when one is initialised (tests pass their own, over
``gloo``) and otherwise initialises it from the ``torchrun``
environment.  The train step runs any mesh over ``"pod"``, ``"data"``
and ``"model"``; its parameters are DTensors placed by
``distributed/sharding.py`` (``train/train_step.py``).

``mesh_context(mesh)`` makes ``mesh`` the current mesh for the code
inside it, as the reference's ``jax.sharding.set_mesh``: the train step
enters it, and ``sharding.mesh_axis_size`` and the MoE balance term
(``models/moe.py``) read it.  ``dp_axes`` names the axes whose ranks
share one batch's statistics: ``("pod", "data")``, or ``("data",)`` in
the compressed step, whose pods run apart as the reference's manual
``shard_map`` over ``"pod"``.
"""
from __future__ import annotations

import contextlib

_CURRENT: list = []


@contextlib.contextmanager
def mesh_context(mesh, dp_axes=("pod", "data")):
    """``mesh`` is the current mesh inside the block."""
    _CURRENT.append((mesh, tuple(dp_axes)))
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh():
    """The innermost ``mesh_context``'s mesh, or None."""
    return _CURRENT[-1][0] if _CURRENT else None


def current_dp_axes() -> tuple:
    """The innermost ``mesh_context``'s data-parallel axes (() without
    one)."""
    return _CURRENT[-1][1] if _CURRENT else ()


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` over the ranks of the default
    group (tests, elastic resize); ``device_type="cpu"`` for ``gloo``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool = False):
    """(shape, axes) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape, axes = production_shape(multi_pod)
    return make_mesh(shape, axes, device_type)
