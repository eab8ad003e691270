"""Error-feedback int8 gradient compression for the cross-pod axis.

The port of ``repro/optim/compression.py``.  At multi-pod scale the
"pod" axis rides the data-center network, much thinner than the links
inside a pod, and the cross-pod gradient all-reduce is the step's
largest collective.  Each rank adds its residual from the last step to
its gradient, quantizes it to int8 with a per-tensor scale that every
rank shares (an all-reduce MAX of ``amax``), sums the int8 values as
int32 over the group, dequantizes and divides by the group size; the
local quantization residual is carried to the next step (error
feedback).  ``torch.round`` rounds half to even, as ``jnp.round``.

Where the reference runs inside a ``shard_map`` that is manual over the
pod axis and holds every pod's residual in one array with a leading pod
axis, the port runs on each rank over a ``torch.distributed`` process
group (``mesh["pod"].get_group()``) and each rank keeps its own residual.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


@torch.no_grad()
def quantized_psum_mean(grads: dict, error: dict, group=None, bits: int = 8,
                        scale_groups=()):
    """Compressed mean of a gradient tree over the ranks of ``group``.

    Returns (the mean tree, each leaf in its gradient's dtype; the new
    fp32 residual tree).  Every rank of the group must call it with trees
    of the same names and shapes.  Where the trees hold shards (the
    sharded step), ``scale_groups`` are the groups of the mesh's other
    axes: ``amax`` is taken over them too, so each tensor keeps one scale,
    as the reference's.
    """
    qmax = float(2 ** (bits - 1) - 1)
    n = dist.get_world_size(group)
    red, err = {}, {}
    for name, g in grads.items():
        x = g.float() + error[name]
        amax = torch.amax(torch.abs(x)).reshape(1)
        for g_ in (group, *scale_groups):
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=g_)
        scale = torch.clamp(amax[0], min=1e-12) / qmax      # shared scale
        q = torch.clamp(torch.round(x / scale), -qmax, qmax)
        # int8 values; an int32 sum cannot overflow below 2^23 ranks
        s = q.to(torch.int8).to(torch.int32)
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        red[name] = ((s.to(torch.float32) * scale) / n).to(g.dtype)
        err[name] = x - q * scale                            # local residual
    return red, err


def init_error(params: dict) -> dict:
    """This rank's zero fp32 residual beside each parameter (placed as it
    is, for a DTensor: the residual of this rank's shard; its copies along
    "pod" differ, each pod keeping its own, as the reference's)."""
    return {n: torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
            for n, p in params.items()}
