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
specs (:func:`shard_model`), and splits its compute over ``"model"`` as
the reference's GSPMD plan does (Megatron's tensor and expert
parallelism).  Every rank runs its own batch rows, those of its (pod,
data) slot; ranks along ``"model"`` hold the same rows and split the
work on them:

* a block fetches its weights with :func:`gather_named` (inside the
  block's recompute checkpoint under ``remat == "layer"``), each in one
  of three modes (:data:`MODES`) that ``models/transformer.py::
  model_plan`` picks with :func:`keeps_model_cut`: ``"local"``, gathered
  over ``"data"`` only, so the rank keeps its ``"model"`` slice (whole
  heads, experts, hidden units or vocab rows) and computes on it;
  ``"full"``, gathered to full for compute every rank of the axis
  repeats (norms, the router, a cell whose cuts keep no whole unit);
  ``"partial"``, gathered to full for use inside a split region only,
  where each rank adds its share of the gradient (the KV projections
  when the KV heads do not divide over ``"model"``, MLA's ``wq_down``
  whose cut splits the latent its norm spans, the norms applied per
  head, a split Mamba's ``w_in`` and the replicated leaves each rank
  slices to its channels, an mLSTM's ``wq``/``wk`` sliced to the head of
  the value columns it holds);
* a split region (one of the regions ``model_plan`` names, which the
  block hands its layer functions) starts with :func:`copy_to_model`
  (identity, its gradient summed over ``"model"``) and ends with
  :func:`reduce_from_model` (summed over ``"model"``, identity
  backward): attention's heads with the row-parallel ``wo``, the MLP's
  hidden units, the MoE's experts (or their hidden units where the
  experts do not divide), the vocab of the embedding and of the logits,
  a recurrent cell's heads, value columns or channels (``models/
  ssm.py``); a sum inside a split region that feeds each rank's own
  compute (a split cell's norm's sum of squares, a Mamba's B, C and dt)
  is :func:`sum_model`, summed in the backward as well, and a split
  sLSTM gathers its ``h`` each step with :func:`gather_model`, whose
  gradient is reduce-scattered back;
  the vocab-parallel loss (``models/transformer.py::
  vocab_parallel_cross_entropy``) all-reduces the max
  (:func:`all_reduce_max`, no gradient), the sum of exps and the gold
  logit, so no rank builds the full logits.

A fetched weight's gradient goes back to its shard: along ``"model"`` a
local slice's gradient is its own; a ``"full"`` weight's, which every
rank computed alike, is narrowed to the rank's slice (averaged where it
is replicated there, which changes no value and keeps the copies equal
whatever the kernels' rounding); a ``"partial"`` weight's is summed over
the axis (a reduce-scatter where it is sharded there).  Over ``"data"``
it is summed (a reduce-scatter where the weight is sharded there, an
all-reduce where it is replicated) and divided by the data width.  The
step then averages over ``"pod"``.

Every collective of this module goes through one helper per kind, which
counts its bytes by mesh axis (:func:`wire_counts`), skips a group of one
rank (a sum or a gather over one rank is the identity: a gather still
copies, as a parameter's gathered copy is contiguous) and, on a ``gloo``
group handed CUDA tensors, runs through host copies (two ranks on one
card: ``gloo`` carries the collective, the compute stays on the card).

``constrain`` is the identity (its docstring says why).  The reference's
``shard_map`` has no torch counterpart and is not ported: the compressed
step already runs its pod loop by hand, a rank per pod slot over a
``torch.distributed`` group (``optim/compression.py``).
"""
from __future__ import annotations

import collections
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
    mesh = current_mesh()
    axes = [a for a in current_dp_axes()
            if a in mesh_sizes(mesh) and mesh_sizes(mesh)[a] > 1]
    if not axes:
        return t
    t = t.detach().clone()
    for a in axes:
        all_reduce(t, mesh.get_group(a), a)
    return t / math.prod(mesh_sizes(mesh)[a] for a in axes)


def constrain(x, *logical):
    """The identity, kept so model code reads as the reference's.

    The reference's ``with_sharding_constraint`` is a placement hint to
    GSPMD: it moves data between devices and never changes a value.  In
    the port no tensor of the forward is a DTensor: the split over
    ``"model"`` happens where a block fetches its weights
    (:func:`gather_named` in the modes of ``models/transformer.py::
    model_plan``) and at the edges of its split regions
    (:func:`copy_to_model`, :func:`reduce_from_model`), and the batch's
    rows are split by the train step, so there is nothing to place.
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
    forward then fetches each block's weights with :func:`gather_named`
    (``Transformer.gather``).  Returns the model."""
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


# ------------------------------------------------------------- collectives
#: ``{(kind, axis): bytes}`` this rank received by all-gathers and handed
#: to all-reduces and reduce-scatters since :func:`reset_wire_counts`
_WIRE: collections.Counter = collections.Counter()
#: names of the weights :func:`gather_named` gathered along ``"model"``
_MODEL_GATHERED: set = set()


def reset_wire_counts() -> None:
    _WIRE.clear()
    _MODEL_GATHERED.clear()


def wire_counts() -> dict:
    """``{"kind/axis": bytes}`` since :func:`reset_wire_counts` (an
    all-gather's bytes are those the rank received; an all-reduce's and a
    reduce-scatter's its operand's), and ``"model_gathered"``, the sorted
    names of the weights gathered along ``"model"``."""
    out = {f"{k}/{a}": int(v) for (k, a), v in sorted(_WIRE.items())}
    out["model_gathered"] = sorted(_MODEL_GATHERED)
    return out


def _via_host(t, group) -> bool:
    """Whether a collective of ``t`` over ``group`` goes through a host
    copy: ``gloo`` handed a CUDA tensor."""
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t, group, axis: str, op: str = "sum"):
    """``t`` reduced in place over ``group`` (``op`` "sum" or "max"),
    counted under ``axis``; returns ``t``."""
    import torch.distributed as dist

    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    if dist.get_world_size(group) == 1:
        return t
    _WIRE["all-reduce", axis] += t.numel() * t.element_size()
    if _via_host(t, group):
        h = t.cpu()
        dist.all_reduce(h, op=red, group=group)
        return t.copy_(h)
    dist.all_reduce(t, op=red, group=group)
    return t


def _all_gather(t, dim: int, group, axis: str):
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if n == 1:              # a copy, contiguous, as a gather gives
        return t.clone(memory_format=torch.contiguous_format)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _WIRE["all-gather", axis] += (n - 1) * src.numel() * src.element_size()
    if _via_host(src, group):
        h = out.cpu()
        dist.all_gather_into_tensor(h, src.cpu(), group=group)
        out.copy_(h)
    else:
        dist.all_gather_into_tensor(out, src, group=group)
    # contiguous, as the parameter is: the products then see the layout
    # an unsharded model's weight has
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(t, dim: int, group, axis: str):
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _WIRE["reduce-scatter", axis] += src.numel() * src.element_size()
    if _via_host(src, group):
        h = out.cpu()
        dist.reduce_scatter_tensor(h, src.cpu(), group=group)
        out.copy_(h)
    else:
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _axis_group(axis: str):
    """(group, rank, size, axis) of the current mesh's ``axis``, or None
    where it has one rank or there is no mesh."""
    mesh = current_mesh()
    if mesh_sizes(mesh).get(axis, 1) <= 1:
        return None
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh_sizes(mesh)[axis], axis)


def model_rank() -> int:
    """This rank's index along ``"model"`` of the current mesh (0 without
    one)."""
    g = _axis_group("model")
    return 0 if g is None else g[1]


class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: identity forward, the gradient summed over
    ``"model"``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: summed over ``"model"``, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x):
    """``x`` entering a split region: the identity, whose gradient (each
    rank's share) is summed over ``"model"``; ``x`` itself without a
    ``"model"`` axis."""
    g = _axis_group("model")
    return x if g is None else _CopyToModel.apply(x, g[0])


def reduce_from_model(x):
    """A split region's partial result summed over ``"model"`` (identity
    backward: every rank's copy of the sum carries the same gradient);
    ``x`` itself without a ``"model"`` axis."""
    g = _axis_group("model")
    return x if g is None else _ReduceFromModel.apply(x, g[0])


class _SumModel(torch.autograd.Function):
    """Summed over ``"model"`` in the forward and in the backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group, "model")

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group, "model"), None


def sum_model(x):
    """Partial sums ``x`` summed over ``"model"`` where the sum feeds
    compute that each rank of a split region runs on its own share (a
    split cell's B, C and dt, its norm's sum of squares): the gradient,
    each rank's share of it, is summed over the axis as well, unlike
    :func:`reduce_from_model`'s; ``x`` itself without a ``"model"``
    axis."""
    g = _axis_group("model")
    return x if g is None else _SumModel.apply(x, g[0])


def all_reduce_max(x, axis: str = "model"):
    """The elementwise max of ``x`` over ``axis``, detached (the loss's
    shift, a split softmax's: they carry no gradient)."""
    g = _axis_group(axis)
    x = x.detach()
    return x if g is None else all_reduce(x.contiguous().clone(), g[0],
                                          axis, op="max")


# ------------------------------------------------------ fetching the weights
#: how :func:`gather_named` fetches a weight (module docstring)
MODES = ("local", "full", "partial")


def spec_model_cut(shape, spec, sizes: dict):
    """``(dim, local length)`` of the tensor dim that ``spec`` shards over
    a ``"model"`` axis of more than one rank on a mesh of ``sizes``, or
    None."""
    m = sizes.get("model", 1)
    if m <= 1 or "model" not in spec:
        return None
    d = list(spec).index("model")
    return d, shape[d] // m


def model_cut(p):
    """:func:`spec_model_cut` of DTensor ``p``."""
    mesh = p.device_mesh
    spec = [None] * p.dim()
    for name, pl in zip(mesh.mesh_dim_names, p.placements):
        if pl.is_shard():
            spec[pl.dim] = name
    return spec_model_cut(tuple(p.shape), spec, mesh_sizes(mesh))


def keeps_model_cut(cut, unit: int = 1) -> bool:
    """Whether a ``"model"`` cut (:func:`model_cut`) falls on a boundary of
    ``unit`` elements of its dim (a head of ``unit`` features, an expert,
    a hidden unit or a vocab row of ``unit = 1``): each rank then holds
    whole units and can compute on its own slice."""
    return cut is not None and cut[1] % unit == 0


class _Gather(torch.autograd.Function):
    """A local shard -> the tensor a block runs on (all-gathers over the
    mesh dims that shard it, but ``"model"`` in mode ``"local"``); its
    backward takes the gradient back to the shard (module docstring)."""

    @staticmethod
    def forward(ctx, local, mesh, places, mode):
        ctx.mesh, ctx.places, ctx.mode = mesh, places, mode
        full = local
        for i, pl in enumerate(places):
            name = mesh.mesh_dim_names[i]
            if pl.is_shard() and not (name == "model" and mode == "local"):
                full = _all_gather(full, pl.dim, mesh.get_group(i), name)
        return full

    @staticmethod
    def backward(ctx, g):
        mesh, places, mode = ctx.mesh, ctx.places, ctx.mode
        names = mesh.mesh_dim_names
        g = g if g.dtype == torch.float64 else g.float()
        for i in reversed(range(len(places))):
            pl, name = places[i], names[i]
            if name == "pod":
                if pl.is_shard():
                    raise ValueError("no parameter is sharded over 'pod'")
                continue                   # the step's pod mean, later
            n, group = mesh.size(i), mesh.get_group(i)
            if name == "model" and pl.is_shard():
                if mode == "partial":       # each rank's share: summed
                    g = _reduce_scatter(g, pl.dim, group, name)
                elif mode == "full":        # alike on every rank: its slice
                    k = g.shape[pl.dim] // n
                    g = g.narrow(pl.dim, mesh.get_local_rank(i) * k, k)
            elif name == "model" and mode == "partial":
                g = all_reduce(g.contiguous(), group, name)
            elif pl.is_shard():             # "data": reduce-scatter, mean
                g = _reduce_scatter(g, pl.dim, group, name) / n
            else:                           # replicated: all-reduce, mean
                g = all_reduce(g.contiguous(), group, name) / n
        return g.contiguous(), None, None, None


def gather_named(named: dict, modes: dict | None = None) -> dict:
    """``{name: the tensor a block runs on}`` of DTensors ``named``, each
    fetched in ``modes[name]`` (:data:`MODES`, ``"full"`` where ``modes``
    names none; ``"local"`` keeps the ``"model"`` slice), differentiable:
    each gradient reaches its DTensor placed like it."""
    modes = modes or {}
    out = {}
    for n, p in named.items():
        mode = modes.get(n, "full")
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} is not among {MODES}")
        if mode != "local" and model_cut(p) is not None:
            _MODEL_GATHERED.add(n)
        out[n] = _Gather.apply(p.to_local(), p.device_mesh,
                               tuple(p.placements), mode)
    return out


def replication(p) -> int:
    """How many ranks of ``p``'s mesh hold each of its elements."""
    mesh = p.device_mesh
    return math.prod(mesh.size(i) for i, pl in enumerate(p.placements)
                     if not pl.is_shard())


def global_norm(local: dict, params: dict) -> torch.Tensor:
    """The L2 norm of a sharded tree in fp32: each rank's sum of squares
    of its shards, each element counted once (divided by the ranks that
    hold it), summed over every rank of the mesh."""
    sq = sum(torch.sum(torch.square(t.float())) / replication(params[n])
             for n, t in local.items()).reshape(1)
    mesh = next(iter(params.values())).device_mesh
    for i, name in enumerate(mesh.mesh_dim_names):
        all_reduce(sq, mesh.get_group(i), name)
    return torch.sqrt(sq[0])


# ---------------------------------------------------- the rows of a batch
def row_axes(B: int, sizes: dict) -> tuple:
    """The mesh axes (of more than one rank) that split the rows of a
    ``B``-row batch, the reference's ``batch_specs``: pod x data where
    that divides ``B``, else data where it does, else none (every rank
    serves every row)."""
    pod, data = sizes.get("pod", 1), sizes.get("data", 1)
    axes = (("pod", "data") if B % (pod * data) == 0
            else ("data",) if B % data == 0 else ())
    return tuple(a for a in axes if sizes.get(a, 1) > 1)


def rows_per_rank(B: int, sizes: dict) -> int:
    """The rows of a ``B``-row batch that one rank serves
    (:func:`row_axes`)."""
    return B // math.prod(sizes[a] for a in row_axes(B, sizes))


def _row_groups() -> list:
    """:func:`_axis_group` of each current data-parallel axis (the axes
    the rows are split over) of more than one rank, outermost first."""
    return [g for g in map(_axis_group, current_dp_axes()) if g is not None]


def local_rows(t):
    """This rank's rows (dim 0) of ``t``, which holds every rank's: slice
    ``r`` of the current data-parallel axes' ranks, ``r`` row-major over
    them (the train step's and the reference's layout)."""
    r, n = 0, 1
    for _, rank, size, _ in _row_groups():
        r, n = r * size + rank, n * size
    k = t.shape[0] // n
    return t[r * k:(r + 1) * k]


def global_rows(B: int) -> int:
    """The rows of the whole batch of which this rank holds ``B`` (split
    over the current data-parallel axes): what the reference's GSPMD step
    sees, and so what its shape-dependent choices read."""
    return B * math.prod(g[2] for g in _row_groups())


def _gather_rows(t, groups):
    for group, _, _, axis in reversed(groups):   # the innermost axis first
        t = _all_gather(t, 0, group, axis)
    return t


class _GatherRows(torch.autograd.Function):
    """Every rank's rows, in the order of :func:`local_rows`; the gradient
    summed back to each rank's own (reduce-scatters, outermost axis
    first)."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return _gather_rows(t, groups)

    @staticmethod
    def backward(ctx, g):
        for group, _, _, axis in ctx.groups:
            g = _reduce_scatter(g, 0, group, axis)
        return g.contiguous(), None


def gather_rows(t):
    """``t`` (this rank's rows, dim 0) gathered over the current
    data-parallel axes into every rank's rows (:func:`local_rows`'s
    order), differentiable; ``t`` itself where the rows are not split."""
    groups = _row_groups()
    return _GatherRows.apply(t, groups) if groups else t


# -------------------------------------------------------- serving's layout
def slots_split(B: int, T: int, sizes: dict) -> bool:
    """Whether the ``T`` KV slots of a ``B``-row decode cache go over
    ``"data"`` (the reference's ``cache_specs``): for ``B == 1`` (one
    long context, whose row no axis can split), where ``T`` divides."""
    data = sizes.get("data", 1)
    return B == 1 and data > 1 and T % data == 0


def slot_range(T_local: int):
    """(first slot, global slot count) of this rank's ``T_local`` slots of
    a cache whose slots are split over ``"data"``."""
    g = _axis_group("data")
    return g[1] * T_local, T_local * g[2]


def data_sum(*ts) -> list:
    """Each of ``ts`` summed over ``"data"``, in one all-reduce of their
    concatenation."""
    g = _axis_group("data")
    if g is None:
        return list(ts)
    flat = all_reduce(torch.cat([t.reshape(-1) for t in ts]), g[0], "data")
    out, at = [], 0
    for t in ts:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


#: a KV dict's tensors that hold KV heads (dim 2)
KV_HEAD_KEYS = ("k", "v", "k_scale", "v_scale")


class RankCache(list):
    """A sharded model's decode cache on one rank: the unsharded cache's
    list (one entry a layer), each tensor this rank's piece, and the
    layout it was cut by: ``rows``, the mesh axes its rows are split over
    (:func:`row_axes`); ``kv_split``, the layers whose KV heads are split
    over ``"model"`` (the others hold every KV head on every rank of the
    axis); ``slots``, the layers whose slots are split over ``"data"``
    (:func:`slots_split`); ``cells``, ``{layer: region}`` of the layers
    whose recurrent state is split over ``"model"``, by the cell's region
    (``models/transformer.py::REGIONS``): ``"cell"``, an mLSTM's heads
    (dim 1 of C, n and m) or an sLSTM's or a Mamba's channels (dim 1 of
    each (B, d) state and of s, dim 2 of the conv tail), or
    ``"cell_values"``, an mLSTM's value columns of one head (dim 3 of C;
    n and m that head's, alike on the ranks that share it)."""

    def __init__(self, entries, rows=(), kv_split=frozenset(),
                 slots=frozenset(), cells=None):
        super().__init__(entries)
        self.rows = tuple(rows)
        self.kv_split = frozenset(kv_split)
        self.slots = frozenset(slots)
        self.cells = dict(cells or {})


def _gather_state(state: tuple, cell, rows: list) -> tuple:
    """A recurrent state's rows and, where ``cell`` (its region in
    :class:`RankCache`'s ``cells``) split it over ``"model"``, its pieces
    there, gathered into the whole state."""
    state = [_gather_rows(t, rows) for t in state]
    if cell is None:
        return tuple(state)
    group = _axis_group("model")[0]
    if len(state) == 2:                            # Mamba: s, conv tail
        return (_all_gather(state[0], 1, group, "model"),
                _all_gather(state[1], 2, group, "model"))
    if cell == "cell":                             # heads, channels
        return tuple(_all_gather(t, 1, group, "model") for t in state)
    C, n, m = state                                # value columns
    C = _all_gather(C, 3, group, "model")          # (B, 1, dk, H * dk)
    B, _, dk, width = C.shape
    H = width // dk
    k = mesh_axis_size("model") // H               # ranks a head
    C = C.reshape(B, dk, H, dk).transpose(1, 2).contiguous()
    n = _all_gather(n, 1, group, "model")[:, ::k].contiguous()
    m = _all_gather(m, 1, group, "model")[:, ::k].contiguous()
    return C, n, m


def _gather_entry(e, heads: bool, slots: bool, rows: list, cell=None):
    if isinstance(e, tuple):
        return _gather_state(e, cell, rows)
    if isinstance(e, dict) and "kv" in e:              # a hybrid layer
        return {"kv": _gather_entry(e["kv"], heads, slots, rows),
                "ssm": _gather_state(e["ssm"], cell, rows)}
    out = {}
    for k, t in e.items():
        t = _gather_rows(t, rows)
        if slots:
            g = _axis_group("data")
            t = _all_gather(t, 1, g[0], "data")
        if heads and k in KV_HEAD_KEYS:
            g = _axis_group("model")
            t = _all_gather(t, 2, g[0], "model")
        out[k] = t
    return out


def gather_cache(cache: RankCache) -> list:
    """The global decode cache (a plain list, the unsharded model's
    layout) from every rank's :class:`RankCache`: rows, KV heads, slots
    and split recurrent states gathered where the layout split them;
    every rank of the mesh must call it, inside the model's
    ``mesh_scope``."""
    rows = [g for g in map(_axis_group, cache.rows) if g is not None]
    return [_gather_entry(e, i in cache.kv_split, i in cache.slots, rows,
                          cache.cells.get(i))
            for i, e in enumerate(cache)]


class _GatherModel(torch.autograd.Function):
    """Every rank's piece along ``"model"``; the gradient, each rank's
    share of it, summed back to the rank's own piece (a reduce-scatter,
    in fp32)."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(t, dim, group, "model")

    @staticmethod
    def backward(ctx, g):
        wide = g if g.dtype == torch.float64 else g.float()
        out = _reduce_scatter(wide, ctx.dim, ctx.group, "model")
        return out.to(g.dtype).contiguous(), None, None


def gather_model(t, dim: int = -1):
    """``t``'s pieces along ``"model"`` (dim ``dim``) gathered in rank
    order, differentiable (:class:`_GatherModel`): a split vocab's
    columns, a split sLSTM's ``h`` before its recurrent product."""
    g = _axis_group("model")
    if g is None:
        return t
    return _GatherModel.apply(t, dim % t.dim(), g[0])


def vocab_argmax(logits, split: bool):
    """Greedy ids (...,) of ``logits`` (..., V'), whose columns are this
    rank's ``V / m`` of a vocab split over ``"model"`` (rank r's from ``r
    * V / m``) where ``split``: the global argmax, ties to the lowest
    global id as ``torch.argmax``; the local argmax otherwise."""
    ids = torch.argmax(logits, dim=-1)
    g = _axis_group("model") if split else None
    if g is None:
        return ids
    best = torch.gather(logits, -1, ids[..., None])[..., 0].float()
    top = all_reduce(best.contiguous().clone(), g[0], "model", op="max")
    ids = ids + g[1] * logits.shape[-1]
    # the lowest id among the ranks holding the max: max of its negation
    cand = torch.where(best == top, -ids, -torch.iinfo(torch.int64).max)
    return -all_reduce(cand.contiguous(), g[0], "model", op="max")


def full_state(tree, keep: bool = True):
    """``tree`` with each DTensor gathered to its full tensor (the gather
    helper over each mesh dim that shards it; every rank of its mesh must
    call) and every leaf copied to the host, leaf by leaf, so the card
    holds one gathered leaf at a time; a rank that does not ``keep`` them
    gets None leaves."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: full_state(v, keep) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        mesh, local = tree.device_mesh, tree.to_local().detach()
        for i, pl in enumerate(tree.placements):
            if pl.is_shard():
                local = _all_gather(local, pl.dim, mesh.get_group(i),
                                    mesh.mesh_dim_names[i])
        tree = local
    return tree.detach().to("cpu", copy=True) if keep else None
