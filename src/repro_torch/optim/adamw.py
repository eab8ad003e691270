"""AdamW with fp32 state over bf16 params, global-norm clipping.

The port of ``repro/optim/adamw.py``, with its arithmetic and not
``torch.optim.AdamW``'s: ``m`` and ``v`` are fp32 whatever the
parameter's dtype, the global gradient norm is taken in fp32, the bias
corrections are fp32 functions of the step count, and each parameter's
new value ``p - lr * (m_hat / (sqrt(v_hat) + eps)) - lr * wd * p`` is
computed in fp32 and cast to the parameter's dtype once.

Trees are ``{parameter name: tensor}`` dicts (``dict(model.named_parameters())``).
The state is ``{"m": tree, "v": tree, "count": int32 scalar}``.  ``update``
writes the new parameters, ``m``, ``v`` and ``count`` in place, so a step
holds one copy of the state, and returns the metrics ``grad_norm`` and
``lr`` as tensors on the device (reading them waits for the step).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init(params: dict) -> dict:
    """Zero fp32 ``m`` and ``v`` beside each parameter (placed as it is,
    for a DTensor), and count 0."""
    f32 = lambda t: torch.zeros_like(t, dtype=torch.float32,
                                     memory_format=torch.contiguous_format)
    dev = next(iter(params.values())).device
    return {"m": {n: f32(p) for n, p in params.items()},
            "v": {n: f32(p) for n, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict) -> torch.Tensor:
    """The L2 norm of every leaf together, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree.values()))


@torch.no_grad()
def update(grads: dict, state: dict, params: dict, cfg: AdamWConfig,
           gnorm=None) -> dict:
    """One AdamW step of ``params`` by ``grads``, in place (module
    docstring); returns ``{"grad_norm", "lr"}``.  ``gnorm`` replaces
    ``global_norm(grads)`` where the trees are this rank's shards
    (``distributed/sharding.py::global_norm``)."""
    count = state["count"] + 1
    lr = cfg.lr(count) if callable(cfg.lr) else cfg.lr

    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    b1c = 1.0 - cfg.b1 ** count.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** count.to(torch.float32)

    for name, g in grads.items():
        p, m, v = params[name], state["m"][name], state["v"][name]
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        step = lr * (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        step = step + lr * cfg.weight_decay * p.float()
        p.copy_((p.float() - step).to(p.dtype))
    state["count"] = count
    return {"grad_norm": gnorm,
            "lr": torch.as_tensor(lr, dtype=torch.float32,
                                  device=count.device)}
