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
environment.  The train step of this port runs meshes whose axes are
``"pod"`` and ``"data"`` (both data parallel, parameters replicated);
a ``"model"`` axis wider than 1 needs the sharded step that
``distributed/sharding.py`` will bring (``train/train_step.py``).
"""
from __future__ import annotations


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` over the ranks of the default
    group (tests, elastic resize); ``device_type="cpu"`` for ``gloo``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)
