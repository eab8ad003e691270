"""Training step factory: loss, grad, (optionally compressed) reduce, AdamW.

The port of ``repro/train/train_step.py``.  ``make_train_step(cfg, ...)``
returns ``step(model, opt_state, batch) -> metrics``: it differentiates
every parameter of the port's ``Transformer`` (turning their
``requires_grad`` on), reduces the gradients over the mesh, and updates
the parameters and ``opt_state`` in place with ``optim/adamw.py``.
``metrics`` holds ``loss``, ``aux_loss``, ``grad_norm`` and ``lr`` as
tensors on the device.

Microbatching (gradient accumulation) runs loss and grad over row slices
``[i * mb, (i + 1) * mb)`` of the batch in turn and sums the gradients in
fp32 buffers (autograd's ``.grad`` would sum them in the parameter's
dtype), so activation memory scales with the microbatch; loss, aux and
gradients are averaged over the microbatches.

With a mesh (``launch/mesh.py``; axes among ``"pod"``, ``"data"``,
``"model"``) every rank is handed the same global batch and, of each
microbatch, takes its own rows: rank (pod p, data d) of an (n_pod,
n_data) mesh the rows of slice ``p * n_data + d`` of ``n_pod * n_data``,
the reference's ``P(("pod", "data"))`` layout.  Ranks along ``"model"``
take the same rows (they split the work on them, not the batch).  The step runs inside
``mesh_context(mesh)``, so MoE balance terms see the whole batch.  Loss
and aux are averaged over every rank.

The parameters must be DTensors on the mesh (``distributed/sharding.py::
shard_model``; ``Trainer(mesh=...)`` makes them so): each block runs on
its weights gathered over ``"data"`` and split over ``"model"`` as the
reference's plan (heads, hidden units, experts, vocab; the ``sharding``
module docstring), and the backward returns each gradient to its
shard, averaged over ``"data"``.
Gradients, AdamW's ``m`` and ``v`` (``adamw.init`` of the sharded
parameters) and the residual of ``grad_compression`` are DTensors placed
like their parameter.  The gradients are then averaged over ``"pod"``,
exactly or, with ``grad_compression``, by error-feedback int8
(``optim/compression.py``; the step expects ``opt_state["error"]`` from
``compression.init_error``), and AdamW runs on each rank's shards, with
the global gradient norm summed over the mesh.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..distributed import sharding
from ..launch.mesh import mesh_context
from ..models.transformer import cross_entropy, vocab_parallel_cross_entropy
from ..optim import adamw, compression

AUX_LOSS_WEIGHT = 0.01
MESH_AXES = ("pod", "data", "model")


def make_loss_fn(cfg):
    """(model, batch) -> (loss + 0.01 * aux, (loss, aux)).  Decoders:
    next-token CE of ``logits[:, :-1]`` against ``tokens[:, 1:]``;
    encoder-only archs: CE of the logits of ``embeds`` against
    ``labels``.  A model whose plan splits the vocab over ``"model"``
    (``Transformer.top_plan``) takes the vocab-parallel CE."""
    def loss_fn(model, batch):
        with model.mesh_scope():
            return _loss(model, batch)

    def _loss(model, batch):
        ce = (vocab_parallel_cross_entropy if "vocab" in model.top_plan().split
              else cross_entropy)
        if cfg.encoder_only:
            logits, aux = model(embeds=batch["embeds"])
            loss = ce(logits, batch["labels"])
        else:
            logits, aux = model(tokens=batch["tokens"])
            loss = ce(logits[:, :-1], batch["tokens"][:, 1:])
        return loss + AUX_LOSS_WEIGHT * aux, (loss, aux)
    return loss_fn


def _grads(loss_fn, model, batch):
    """(grads by name, loss, aux) of one batch; a parameter the loss does
    not reach gets zeros, as ``jax.grad`` gives."""
    names, params = zip(*model.named_parameters())
    tot, (loss, aux) = loss_fn(model, batch)
    gs = torch.autograd.grad(tot, params, allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for n, p, g in zip(names, params, gs)}
    return grads, loss.detach(), aux.detach()


def _grads_microbatched(loss_fn, model, batch, num_microbatches: int,
                        rows=None):
    """(grads, loss, aux) averaged over the microbatches; ``rows`` maps a
    (micro)batch to this rank's rows of it."""
    take = rows or (lambda b: b)
    if num_microbatches <= 1:
        return _grads(loss_fn, model, take(batch))
    mb = next(iter(batch.values())).shape[0] // num_microbatches
    g_acc = {n: torch.zeros_like(p, dtype=torch.float32,
                                 memory_format=torch.contiguous_format)
             for n, p in model.named_parameters()}
    l_acc = a_acc = 0.0
    for i in range(num_microbatches):
        part = take({k: t[i * mb:(i + 1) * mb] for k, t in batch.items()})
        g, loss, aux = _grads(loss_fn, model, part)
        for n, t in g.items():
            g_acc[n].add_(t)
        l_acc, a_acc = l_acc + loss, a_acc + aux
        del g
    inv = 1.0 / num_microbatches
    return {n: t * inv for n, t in g_acc.items()}, l_acc * inv, a_acc * inv


def _mesh_axes(mesh) -> dict:
    """{axis: size} of ``mesh``; raises for an axis this step does not
    know."""
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    unknown = set(axes) - set(MESH_AXES)
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)} are not among "
                         f"{MESH_AXES}")
    return axes


def _local_rows(batch, mesh, axes):
    """This rank's rows of the global ``batch`` (module docstring)."""
    n_data = axes.get("data", 1)
    n = axes.get("pod", 1) * n_data
    r = ((mesh.get_local_rank("pod") if "pod" in axes else 0) * n_data
         + (mesh.get_local_rank("data") if "data" in axes else 0))
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split over "
                         f"{n} ranks")
    k = rows // n
    return {name: t[r * k:(r + 1) * k] for name, t in batch.items()}


def _mean(tree: dict, mesh, axis: str) -> dict:
    """Exact fp32 mean of each leaf over the ranks of ``mesh``'s
    ``axis``."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    out = {}
    for name, t in tree.items():
        t = t.float()            # a fresh tensor or one this step owns
        sharding.all_reduce(t, group, axis)
        out[name] = t / n
    return out


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *,
                    num_microbatches: int = 1,
                    grad_compression: bool = False,
                    mesh=None):
    """Build the train step (module docstring).

    With ``grad_compression`` the mesh must have a "pod" axis and the step
    expects ``opt_state["error"]``; the cross-pod mean then rides int8.
    """
    loss_fn = make_loss_fn(cfg)
    axes = _mesh_axes(mesh) if mesh is not None else {}
    if grad_compression and "pod" not in axes:
        raise ValueError("grad_compression needs a mesh with a 'pod' axis")
    dp_axes = ("data",) if grad_compression else ("pod", "data")

    def sharded_update(grads, opt_state, params):
        local = {n: g.to_local() for n, g in grads.items()}
        if "pod" in axes and grad_compression:
            error = {n: e.to_local() for n, e in opt_state["error"].items()}
            local, err = compression.quantized_psum_mean(
                local, error, mesh.get_group("pod"),
                scale_groups=[mesh.get_group(a) for a in axes if a != "pod"])
            for n, e in err.items():
                error[n].copy_(e)            # the DTensors' own storage
        elif "pod" in axes:
            local = _mean(local, mesh, "pod")
        state = {"m": {n: t.to_local() for n, t in opt_state["m"].items()},
                 "v": {n: t.to_local() for n, t in opt_state["v"].items()},
                 "count": opt_state["count"]}
        metrics = adamw.update(
            local, state, {n: p.to_local() for n, p in params.items()},
            opt_cfg, gnorm=sharding.global_norm(local, params))
        opt_state["count"] = state["count"]
        return metrics

    def step(model, opt_state, batch):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        if mesh is None:
            grads, loss, aux = _grads_microbatched(loss_fn, model, batch,
                                                   num_microbatches)
            metrics = adamw.update(grads, opt_state, params, opt_cfg)
            metrics.update(loss=loss, aux_loss=aux)
            return metrics
        if not sharding.is_sharded(model):
            raise ValueError("a mesh needs the model's parameters placed on "
                             "it: distributed.sharding.shard_model(model, "
                             "mesh)")
        with mesh_context(mesh, dp_axes):
            grads, loss, aux = _grads_microbatched(
                loss_fn, model, batch, num_microbatches,
                rows=lambda b: _local_rows(b, mesh, axes))
        metrics = sharded_update(grads, opt_state, params)
        stats = torch.stack([loss, aux]).float()
        for axis in axes:
            stats = _mean({"s": stats}, mesh, axis)["s"]
        metrics.update(loss=stats[0], aux_loss=stats[1])
        return metrics

    return step
