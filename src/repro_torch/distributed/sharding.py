"""Sharding rules: parameter names -> mesh axes, and the sharded weights.

The port of ``repro/distributed/sharding.py``.  Mesh axes
(``launch/mesh.py``):

  pod    — across pods: pure data parallel (the gradient mean crosses the
           slow network once a step, int8 with ``grad_compression``).
  data   — FSDP: batch rows and fully-sharded parameters/optimizer state.
  model  — the reference's TP/EP axis: attention heads, MLP hidden, MoE
           experts, vocab.

``PARAM_RULES`` maps parameter-name suffixes to specs, copied from the
reference; anything unmatched is replicated.  :func:`param_specs` gives
``{name: spec}``, a spec being one mesh axis or ``None`` per tensor dim,
over a ``DeviceMesh`` or a plain ``{axis: size}`` dict (the dry-run asks
for 256- and 512-rank meshes that do not exist); :func:`placements` turns
a spec into DTensor placements.  The port's parameters carry per-layer
names (``layers.{i}.attn.wq``) where the reference stacks each segment's
layers under ``seg{i}``, so no leading layer dim is ever prepended.

The sharded train step (``train/train_step.py``) holds each parameter,
its AdamW ``m`` and ``v`` and its gradient as a DTensor placed by these
specs (:func:`shard_model`).  Compute is not split over ``"model"``:
each block runs on its weights gathered to full (:func:`gather_full`,
inside the block's recompute checkpoint under ``remat == "layer"``), and
every rank runs its own batch rows, those of its (pod, data) slot; ranks
along ``"model"`` hold the same rows.  A gathered weight's gradient goes
back to its shard: summed over ``"data"`` (a reduce-scatter where the
weight is sharded there, an all-reduce where it is replicated) and
divided by the data width; along ``"model"`` each rank keeps its own
slice of a gradient every rank of the axis computed alike (a weight
replicated over ``"model"`` is averaged there, which changes no value and
keeps the copies equal whatever the kernels' rounding).  The step then
averages over ``"pod"``.

``constrain`` is the identity (its docstring says why).  The reference's
``shard_map`` has no torch counterpart and is not ported: the compressed
step already runs its pod loop by hand, a rank per pod slot over a
``torch.distributed`` group (``optim/compression.py``).
"""
from __future__ import annotations

import math
import re

import torch

from ..launch.mesh import current_dp_axes, current_mesh

#: logical -> physical for activations (tuples = joint axes, e.g. the
#: data-parallel product ("pod", "data") for batch/group dims).
ACT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
}

#: suffix pattern -> spec, or a candidate list whose first valid entry wins
PARAM_RULES: list[tuple[str, tuple | list]] = [
    # attention projections: shard the head/feature product dim over model,
    # the d_model dim over data (FSDP).
    (r"\.attn\.wq$", ("data", "model")),
    (r"\.attn\.wk$", ("data", "model")),
    (r"\.attn\.wv$", ("data", "model")),
    (r"\.attn\.wo$", ("model", "data")),
    # MLA
    (r"\.attn\.wq_down$", ("data", "model")),
    (r"\.attn\.wq_up$", (None, "model")),
    (r"\.attn\.wkv_down$", ("data", None)),
    (r"\.attn\.wk_up$", (None, "model")),
    (r"\.attn\.wv_up$", (None, "model")),
    # dense MLP
    (r"\.mlp\.wi$", ("data", "model")),
    (r"\.mlp\.wg$", ("data", "model")),
    (r"\.mlp\.wo$", ("model", "data")),
    # MoE: experts over model (EP); when E doesn't divide the model axis
    # (mixtral: 8 experts on a 16-way axis) fall back to tensor-parallel
    # expert FFNs (hidden dim over model) — candidate list, first valid wins.
    (r"\.moe\.router$", (None, None)),
    (r"\.moe\.wi$", [("model", "data", None), (None, "data", "model")]),
    (r"\.moe\.wg$", [("model", "data", None), (None, "data", "model")]),
    (r"\.moe\.wo$", [("model", None, "data"), (None, "model", "data")]),
    (r"\.moe\.shared\.wi$", ("data", "model")),
    (r"\.moe\.shared\.wg$", ("data", "model")),
    (r"\.moe\.shared\.wo$", ("model", "data")),
    # xLSTM / SSM
    (r"\.cell\.wq$", ("data", "model")),
    (r"\.cell\.wk$", ("data", "model")),
    (r"\.cell\.wv$", ("data", "model")),
    (r"\.cell\.w_in$", ("data", "model")),
    (r"\.cell\.w_bcdt$", ("model", None)),
    (r"\.cell\.w_out$", ("model", "data")),
    (r"\.cell\.wz$", ("data", "model")),
    (r"\.cell\.wi$", ("data", "model")),
    (r"\.cell\.wf$", ("data", "model")),
    (r"\.cell\.wo_gate$", ("data", "model")),
    (r"\.cell\.r$", ("data", "model")),
    (r"\.cell\.wo$", ("model", "data")),
    # embeddings: vocab over model, features over data.
    (r"^embed$", ("model", "data")),
    (r"^unembed$", ("data", "model")),
]


# ------------------------------------------------------------------ meshes
def mesh_sizes(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh``, of an object with a ``shape``
    mapping (a JAX mesh) or of such a dict itself; ``{}`` for None."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def mesh_axis_size(name: str) -> int:
    """The size of axis ``name`` of the current mesh (1 without one)."""
    return mesh_sizes(current_mesh()).get(name, 1)


def dp_mean(t):
    """``t``'s mean over the data-parallel ranks of the current mesh (its
    ``dp_axes`` present in it), outside autograd; ``t`` without a mesh.
    Every rank of those axes must call it."""
    import torch.distributed as dist

    mesh = current_mesh()
    axes = [a for a in current_dp_axes()
            if a in mesh_sizes(mesh) and mesh_sizes(mesh)[a] > 1]
    if not axes:
        return t
    t = t.detach().clone()
    for a in axes:
        dist.all_reduce(t, group=mesh.get_group(a))
    return t / math.prod(mesh_sizes(mesh)[a] for a in axes)


def constrain(x, *logical):
    """The identity, kept so model code reads as the reference's.

    The reference's ``with_sharding_constraint`` is a placement hint to
    GSPMD: it moves data between devices and never changes a value.  In
    the port no tensor of the forward is distributed: each rank computes
    its own batch rows on full weights (module docstring), so there is
    nothing to place.
    """
    return x


# ---------------------------------------------------------------- the specs
def _candidates_for(path: str, ndim: int) -> list:
    """Ordered candidate specs for a parameter path (first valid wins)."""
    for pat, spec in PARAM_RULES:
        if re.search(pat, path):
            cands = spec if isinstance(spec, list) else [spec]
            out = []
            for c in cands:
                c = tuple(c)
                if len(c) < ndim:
                    c = c + (None,) * (ndim - len(c))
                out.append(c[:ndim])
            return out
    return [(None,) * ndim]


def _validate(spec, shape, sizes: dict):
    fixed, full = [], True
    for dim, ax in zip(shape, spec):
        ok = ax is not None and ax in sizes and dim % sizes[ax] == 0
        fixed.append(ax if ok else None)
        if ax is not None and not ok:
            full = False
    return tuple(fixed), full


def param_specs(named, mesh=None) -> dict:
    """``{name: spec}`` for ``{name: tensor or shape}`` (or a module's
    named parameters) on ``mesh`` (a ``DeviceMesh``, a ``{axis: size}``
    dict, or the current mesh when None).

    Each rule may list fallback candidates; the first whose named axes all
    divide the tensor is used, otherwise the non-dividing axes of the
    first candidate are dropped (tiny configs on big meshes).  Without a
    mesh every spec is its first candidate, as the reference's.
    """
    if isinstance(named, torch.nn.Module):
        named = dict(named.named_parameters())
    sizes = mesh_sizes(mesh if mesh is not None else current_mesh())
    specs = {}
    for path, leaf in named.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        cands = _candidates_for(path, len(shape))
        if not sizes:
            specs[path] = cands[0]
            continue
        chosen = None
        for c in cands:
            fixed, full = _validate(c, shape, sizes)
            if full:
                chosen = fixed
                break
        if chosen is None:
            chosen, _ = _validate(cands[0], shape, sizes)
        specs[path] = chosen
    return specs


def shard_factor(spec, sizes: dict) -> int:
    """Into how many pieces ``spec`` cuts its tensor on a mesh of
    ``sizes``."""
    return math.prod(sizes.get(ax, 1) for ax in spec if ax is not None)


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on the
    mesh dim a tensor dim is sharded over, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {ax: d for d, ax in enumerate(spec) if ax is not None}
    return [Shard(dims[name]) if name in dims else Replicate()
            for name in mesh.mesh_dim_names]


# ------------------------------------------------------ DTensors and gathers
def is_sharded(model) -> bool:
    """Whether ``model``'s parameters are DTensors (:func:`shard_model`)."""
    from torch.distributed.tensor import DTensor

    return any(isinstance(p, DTensor) for p in model.parameters())


def shard_tensor(full, mesh, places):
    """``full`` placed by ``places`` (:func:`placements`) on ``mesh``:
    ``distribute_tensor`` with ``src_data_rank=None`` (every rank holds
    ``full``, so each keeps its piece and none sends), the piece copied
    out: one cut along dim 0 is a view that would keep all of ``full``
    alive."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    dt = distribute_tensor(full, mesh, places, src_data_rank=None)
    return DTensor.from_local(dt.to_local().clone(), mesh, dt.placements,
                              run_check=False)


def _set_param(model, name: str, value) -> None:
    mod_name, _, leaf = name.rpartition(".")
    mod = model.get_submodule(mod_name) if mod_name else model
    setattr(mod, leaf, torch.nn.Parameter(value, requires_grad=False))


def shard_model(model, mesh, specs=None, params=None):
    """Place ``model``'s parameters on ``mesh`` in place, as DTensors by
    ``specs`` (default :func:`param_specs`); with ``params`` (``{name:
    DTensor}``, an elastic restore) take those instead.  The model's
    forward then gathers each block's weights to full (``Transformer.
    gather``).  Returns the model."""
    if params is None:
        specs = specs or param_specs(model, mesh)
        with torch.no_grad():
            for name, p in list(model.named_parameters()):
                _set_param(model, name, shard_tensor(
                    p.detach(), mesh, placements(specs[name], mesh)))
    else:
        names = {n for n, _ in model.named_parameters()}
        if names != set(params):
            raise ValueError(f"parameters differ: "
                             f"{sorted(names ^ set(params))}")
        for name, value in params.items():
            _set_param(model, name, value)
    model.gather = gather_named
    return model


class _Gather(torch.autograd.Function):
    """A local shard -> the full tensor (all-gathers over the mesh dims
    that shard it); its backward takes the full gradient back to the shard
    (module docstring)."""

    @staticmethod
    def forward(ctx, local, mesh, places):
        ctx.mesh, ctx.places = mesh, places
        full = local
        for i, pl in enumerate(places):
            if pl.is_shard():
                full = _all_gather(full, pl.dim, mesh.get_group(i))
        return full

    @staticmethod
    def backward(ctx, g):
        mesh, places = ctx.mesh, ctx.places
        names = mesh.mesh_dim_names
        g = g if g.dtype == torch.float64 else g.float()
        for i in reversed(range(len(places))):
            pl, name = places[i], names[i]
            if name == "pod":
                if pl.is_shard():
                    raise ValueError("no parameter is sharded over 'pod'")
                continue                   # the step's pod mean, later
            n = mesh.size(i)
            if name == "model" and pl.is_shard():
                k = g.shape[pl.dim] // n
                g = g.narrow(pl.dim, mesh.get_local_rank(i) * k, k)
            elif pl.is_shard():             # "data": reduce-scatter, mean
                g = _reduce_scatter(g, pl.dim, mesh.get_group(i)) / n
            else:                           # replicated: all-reduce, mean
                import torch.distributed as dist

                g = g.contiguous()
                dist.all_reduce(g, group=mesh.get_group(i))
                g = g / n
        return g.contiguous(), None, None


def _all_gather(t, dim: int, group):
    import torch.distributed as dist

    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    # contiguous, as the parameter is: the products then see the layout
    # an unsharded model's weight has
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(t, dim: int, group):
    import torch.distributed as dist

    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def gather_full(p):
    """The full tensor of DTensor ``p``, differentiable: its gradient
    reaches ``p`` as a DTensor placed like ``p``."""
    return _Gather.apply(p.to_local(), p.device_mesh, tuple(p.placements))


def gather_named(named: dict) -> dict:
    """``{name: gather_full(p)}``."""
    return {n: gather_full(p) for n, p in named.items()}


def replication(p) -> int:
    """How many ranks of ``p``'s mesh hold each of its elements."""
    mesh = p.device_mesh
    return math.prod(mesh.size(i) for i, pl in enumerate(p.placements)
                     if not pl.is_shard())


def global_norm(local: dict, params: dict) -> torch.Tensor:
    """The L2 norm of a sharded tree in fp32: each rank's sum of squares
    of its shards, each element counted once (divided by the ranks that
    hold it), summed over every rank of the mesh."""
    import torch.distributed as dist

    sq = sum(torch.sum(torch.square(t.float())) / replication(params[n])
             for n, t in local.items()).reshape(1)
    mesh = next(iter(params.values())).device_mesh
    for i in range(mesh.ndim):
        dist.all_reduce(sq, group=mesh.get_group(i))
    return torch.sqrt(sq[0])


def full_state(tree, keep: bool = True):
    """``tree`` with each DTensor gathered to its full tensor
    (``full_tensor``; every rank of its mesh must call) and every leaf
    copied to the host, leaf by leaf, so the card holds one gathered leaf
    at a time; a rank that does not ``keep`` them gets None leaves."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: full_state(v, keep) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    return tree.detach().to("cpu", copy=True) if keep else None
