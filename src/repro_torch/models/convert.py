"""Carry the JAX package's weights across to the port.

``params_from_reference(params_np, cfg)`` takes the JAX param pytree as
numpy arrays (``jax.tree.map(np.asarray, init_params(key, cfg))``) and
returns a :class:`Transformer` holding the same values: each ``seg{i}``
leaf's leading (layer) axis is unstacked into that segment's per-layer
modules.  Every block tree carries across under its names: the MoE
tree (3-D expert leaves, ``shared``, the fp32 router), MLA's, the
recurrent ``cell`` of mlstm/slstm, and the hybrid kinds' Mamba ``cell``
(with its fp32 ``a_log``, ``d_skip``, ``dt_bias`` in a bf16 model) beside
``attn_norm`` and ``ssm_norm``.  Shapes and dtypes must match leaf by
leaf.  The port's forward then computes what the JAX forward computes,
which is how the tests compare the two.

``named_from_reference(tree_np, cfg)`` is that name mapping alone, for
any tree shaped like the JAX params (gradients, AdamW's ``m`` and ``v``):
``{port parameter name: array}``.  ``opt_state_from_reference(opt_np,
cfg)`` carries a JAX ``optim/adamw.py`` state across as the port's
``{"m", "v", "count"}``.
"""
from __future__ import annotations

import numpy as np
import torch

from .transformer import Transformer


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def _tensor(arr) -> torch.Tensor:
    arr = np.array(arr)                     # a writable copy
    if arr.dtype.name == "bfloat16":        # ml_dtypes: carry the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def named_from_reference(tree_np, cfg) -> dict:
    """``{port parameter name: array}`` of a tree shaped like the JAX
    params: each ``seg{i}`` leaf's leading (layer) axis unstacked into the
    names of that segment's layers."""
    named = _flatten({k: v for k, v in tree_np.items()
                      if not k.startswith("seg")})
    layer = 0
    for i, (_kind, count) in enumerate(cfg.segments):
        seg = _flatten(tree_np[f"seg{i}"])
        for j in range(count):
            named.update({f"layers.{layer}.{k}": v[j] for k, v in seg.items()})
            layer += 1
    return named


def opt_state_from_reference(opt_np, cfg, device="cpu") -> dict:
    """The port's AdamW state (``optim/adamw.py``) on ``device`` from a JAX
    one as numpy arrays: ``m`` and ``v`` by port name, fp32, and the int32
    step ``count``."""
    def by_name(tree):
        return {n: _tensor(a).to(device)
                for n, a in named_from_reference(tree, cfg).items()}
    return {"m": by_name(opt_np["m"]), "v": by_name(opt_np["v"]),
            "count": torch.tensor(int(np.asarray(opt_np["count"])),
                                  dtype=torch.int32, device=device)}


def params_from_reference(params_np, cfg, device="cpu") -> Transformer:
    """A Transformer on ``device`` with the weights of ``params_np``."""
    named = named_from_reference(params_np, cfg)
    model = Transformer(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            src = _tensor(named.pop(name))
            if src.shape != p.shape or src.dtype != p.dtype:
                raise ValueError(f"{name}: reference {tuple(src.shape)} "
                                 f"{src.dtype}, port {tuple(p.shape)} {p.dtype}")
            p.copy_(src)
    if named:
        raise ValueError(f"reference params the port has no place for: "
                         f"{sorted(named)}")
    return model
