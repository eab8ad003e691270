"""Mixture-of-Experts MLP with capacity-based sort dispatch, in PyTorch.

The port of ``repro/models/moe.py``.  Mixtral-style (few large experts)
and DeepSeek-MoE-style (fine-grained routed experts + always-on shared
experts) are both expressed here.

Dispatch is the static-shape *capacity* formulation: token->expert
assignments are grouped by a stable sort on expert id, truncated to
``cap = max(1, round(tokens * top_k / E * capacity_factor))`` per expert
(overflow slots drop), and the grouped activations hit the expert weights
as one batched product ``(E, cap, d) @ (E, d, d_ff)``: every expert's
``cap`` rows run, used or not, as in the reference.

The reference batches the dispatch over G = pod x data groups read from
its mesh (``_dp_groups``), each a contiguous slice of the batch's
tokens, and falls back to one global group where G does not divide the
tokens or a group would hold fewer than E / capacity_factor of them
(``N % G != 0 or (N // G) * capacity_factor < E``).  Groups change the
capacity, so the drops and the output.  The port takes G and the
fallback from the current mesh over the *global* token count
(:func:`dispatch_groups`): its rows lie split over the current
data-parallel axes (``launch/mesh.py::current_dp_axes``, R ranks), so a
rank's tokens are G / R of the reference's groups, dispatched as a batch
of groups (one group where the rows split over pod x data, as the
train step's always do).  Where the rule falls back to one group over
split rows, the layer's input rows are all-gathered over those axes
(``sharding.gather_rows``; its gradient a reduce-scatter back), every
rank routes and computes the one global group alike and keeps its own
rows.  Without a mesh this is the reference's G = 1.

The load-balancing term is computed on all of the step's tokens in the
reference (GSPMD sees the global batch).  Under a mesh each rank holds
its own rows, so the expert fractions (no gradient) are averaged over
the data-parallel ranks first (``sharding.dp_mean``); each rank's term
then averages, over the ranks, to the reference's, and so does its
gradient.

Under the sharded step's split over ``"model"`` (``distributed/
sharding.py``) ranks along the axis hold the same rows, so expert
parallelism needs no all-to-all: every rank routes alike and builds the
same ``E x cap`` grid, runs the expert product over its own ``E / m``
experts only and adds its slots into ``y``, which is summed over the
axis.  Where ``m`` does not divide ``E`` the weights hold every expert's
share of the hidden units instead (the reference's fallback rule), and
every slot's partial output is added.  The shared experts are split as
an MLP.  The balance term sees every rank's same rows, unchanged.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import sharding
from ..distributed.sharding import (copy_to_model, dp_mean, model_rank,
                                    reduce_from_model)
from ..launch.mesh import current_dp_axes, current_mesh
from .layers import MLP, _weight


class MoE(nn.Module):
    """``router`` (d, E), fp32 whatever the model dtype; the expert weights
    ``wi``/``wg`` (E, d, d_ff) and ``wo`` (E, d_ff, d); ``shared`` (a
    swiglu MLP of width d_ff * n_shared_experts) when the config has
    shared experts."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, E = cfg.d_model, cfg.n_experts
        dff = cfg.d_expert or cfg.d_ff
        self.router = _weight((d, E), torch.float32, device)
        self.wi = _weight((E, d, dff), dtype, device)
        self.wg = _weight((E, d, dff), dtype, device)
        self.wo = _weight((E, dff, d), dtype, device)
        if cfg.n_shared_experts:
            self.shared = MLP(d, dff * cfg.n_shared_experts, "swiglu", dtype,
                              device)


def capacity(n_tokens: int, cfg) -> int:
    """Slots per expert for ``n_tokens`` tokens (Python's ``round``, which
    rounds halves to even, as the reference)."""
    return int(max(1, round(n_tokens * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor)))


def dispatch_groups(n_tokens: int, cfg) -> tuple:
    """(groups, gather) for a call on this rank's ``n_tokens`` tokens
    (module docstring): how many of the reference's dispatch groups they
    hold, and whether the fallback to one global group needs every
    rank's rows gathered first."""
    sizes = sharding.mesh_sizes(current_mesh())
    R = math.prod(sizes.get(a, 1) for a in current_dp_axes())
    G = sizes.get("pod", 1) * sizes.get("data", 1)
    N = n_tokens * R
    if N % G or (N // G) * cfg.capacity_factor < cfg.n_experts:
        return 1, R > 1
    return G // R, False


def route(xf, p, cfg):
    """Top-k routing of xf (N, d), or of a batch of groups (G, N, d), and
    its capacity dispatch plan, per group.

    Returns (gate, eidx, order, keep, dest, cap): the softmax over the top
    k fp32 router logits and the chosen experts, both (N, K); the stable
    order of the N*K (token, k) slots by expert id; for each slot in that
    order whether it fits its expert's capacity, and its row ``dest`` in
    the (E * cap) expert grid (each with a leading G for groups).
    """
    N = xf.shape[-2]
    E, K = cfg.n_experts, cfg.top_k
    logits = xf.float() @ p.router                            # (.., N, E)
    gate, eidx = torch.topk(logits, K, dim=-1)                # (.., N, K)
    gate = torch.softmax(gate, dim=-1)                        # renorm over top-k
    flat_e = eidx.reshape(eidx.shape[:-2] + (N * K,))
    order = torch.argsort(flat_e, dim=-1, stable=True)        # token order kept
    sorted_e = torch.gather(flat_e, -1, order)
    cap = capacity(N, cfg)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    within = torch.arange(N * K, device=xf.device) - first    # rank in group
    keep = within < cap
    dest = sorted_e * cap + within.clamp(0, cap - 1)
    return gate, eidx, order, keep, dest, cap


def moe_mlp(x, p, cfg, split=frozenset()):
    """x (B, S, d) -> (B, S, d): top-k routing with capacity dispatch in
    the reference's groups (module docstring).  ``split``: the sharded
    step's regions split over ``"model"`` (``models/transformer.py::
    model_plan``): "experts" or "expert_hidden" for the routed experts,
    "shared" for the shared ones (module docstring)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    x_own = x.reshape(B * S, d)
    G, gather = dispatch_groups(B * S, cfg)
    xf = sharding.gather_rows(x_own) if gather else x_own
    N = xf.shape[0] // G                                      # a group's
    gate, _, order, keep, dest, cap = route(xf.reshape(G, N, d), p, cfg)
    slot_token = order // K                                   # (G, N*K)
    E_local = p.wi.shape[0]                   # the experts this rank holds
    routed = bool(split & {"experts", "expert_hidden"})
    lo = model_rank() * E_local if "experts" in split else 0   # own first
    # the split parts' input: every rank's share of its gradient summed
    xin = copy_to_model(xf) if routed or "shared" in split else xf

    # Row N of each group's xpad is its padding row; a dropped slot's write
    # goes to the extra grid row E*cap, which is cut off (the reference's
    # mode="drop").
    grid_token = torch.full((G, E * cap + 1), N, dtype=torch.long,
                            device=x.device)
    grid_token.scatter_(1, torch.where(keep, dest, E * cap), slot_token)
    xpad = torch.cat([(xin if routed else xf).reshape(G, N, d),
                      xf.new_zeros((G, 1, d))], 1)
    own = grid_token[:, lo * cap:(lo + E_local) * cap]
    xg = torch.gather(xpad, 1, own[..., None].expand(-1, -1, d))
    # (E_local, G * cap, d): every (own) expert's rows of every group
    xg = xg.reshape(G, E_local, cap, d).transpose(0, 1).reshape(
        E_local, G * cap, d)

    # ---- expert FFN: every (own) expert's cap rows in one batched product
    h = torch.bmm(xg, p.wi)
    g = torch.bmm(xg, p.wg)
    yg = torch.bmm(F.silu(g) * h, p.wo).to(x.dtype)
    yg = yg.reshape(E_local, G, cap, d).transpose(0, 1).reshape(
        G * E_local * cap, d)

    # ---- combine back with the gate weights, in fp32 ---------------------
    slot_gate = torch.gather(gate.reshape(G, N * K), 1, order)
    mine = keep
    if routed:
        slot_gate = copy_to_model(slot_gate)
        mine = keep & (dest >= lo * cap) & (dest < (lo + E_local) * cap)
    contrib = torch.where(mine, slot_gate, 0.0)
    base = torch.arange(G, device=x.device)[:, None]
    vals = yg[(base * (E_local * cap)
               + torch.where(mine, dest - lo * cap, 0)).reshape(-1)].float()
    y = torch.zeros((G * (N + 1), d), dtype=torch.float32, device=x.device)
    y.index_add_(0, (base * (N + 1) + torch.where(mine, slot_token, N))
                 .reshape(-1), vals * contrib.reshape(-1, 1))
    y = y.reshape(G, N + 1, d)[:, :N].reshape(G * N, d)
    if routed:
        y = reduce_from_model(y)
    if gather:
        y = sharding.local_rows(y)
    out = y.to(x.dtype)

    if cfg.n_shared_experts:
        sp = p.shared
        xs = x_own
        if "shared" in split:     # the gathered rows' copy is not own
            xs = copy_to_model(x_own) if gather else xin
        s = (F.silu(xs @ sp.wg) * (xs @ sp.wi)) @ sp.wo
        out = out + (reduce_from_model(s) if "shared" in split else s)
    return out.reshape(B, S, d)


def aux_load_balance_loss(x, p, cfg):
    """Switch-style load-balancing auxiliary loss (fp32 scalar)."""
    N = x.shape[0] * x.shape[1]
    logits = x.reshape(N, -1).float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    _, eidx = torch.topk(logits, cfg.top_k, dim=-1)
    frac = dp_mean(F.one_hot(eidx, cfg.n_experts).float().mean(dim=(0, 1)))
    return cfg.n_experts * torch.sum(frac * probs.mean(0))
