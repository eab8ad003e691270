"""Recurrent blocks in PyTorch: xLSTM (mLSTM, sLSTM) and a Mamba-style SSM.

The port of ``repro/models/ssm.py``.  Each recurrence is a Python loop
over time of the reference's step (JAX scans it), in the same dtypes:
state math in fp32 (float64 in a float64 model, ``layers.stat``), projections, the conv and ``dt`` in the model dtype.
Each block is ``(x, p, cfg, state=None) -> (out, state)``; a prefill runs
it over the whole sequence, a decode step over one token with the state.
Floors are ``torch.maximum`` against 1, as the reference's
``jnp.maximum``: at a tie (the sLSTM normaliser ``n`` is exactly 1 on a
step whose input gate leads) both split the gradient in half, where
``torch.clamp`` would pass all of it.

State layouts (decode carries these instead of a KV cache):
  mLSTM : C (B, H, Dk, Dv), n (B, H, Dk), m (B, H), all fp32
  sLSTM : c, n, m, h_prev (B, d) each, fp32
  mamba : s (B, d_inner, N) fp32, conv tail (B, W - 1, d_inner) model dtype

Split over ``"model"`` (the sharded steps' ``split``, the regions of
``models/transformer.py::model_plan``), each rank runs its share of a
cell and the output is summed over the axis (``reduce_from_model``), x
entering through ``copy_to_model``; the norm over ``d`` sums its squares
over the axis (``layers.split_rms_norm``):

  "cell" on an mLSTM: its H/m heads (``wq wk wv wo_gate``, ``wi wf``
      columns, ``wo`` rows); C (B, H/m, Dk, Dk), n, m of those heads;
  "cell_values" on an mLSTM (H divides m): rank r's d/m value columns of
      head r // (m/H) (``wv wo_gate`` columns, ``wo`` rows; ``wq wk wi
      wf`` whole, sliced to the head); C (B, 1, Dk, d/m), n and m the
      head's;
  "cell" on an sLSTM: its d/m channels (``wz wi wf wo_gate r`` columns,
      ``wo`` rows); c, n, m, h (B, d/m); each step gathers ``h_prev``
      over the axis (``sharding.gather_model``) for ``h_prev @ r``;
  "cell" on a Mamba: its d_inner/m channels (``w_bcdt``, ``w_out`` rows;
      ``w_in``, ``conv``, ``a_log``, ``d_skip``, ``dt_bias`` whole,
      sliced to them); B, C and dt summed over the axis in fp32
      (``sharding.sum_model``); s (B, d_inner/m, N), the conv tail
      (B, W - 1, d_inner/m).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import (copy_to_model, gather_model,
                                    mesh_axis_size, model_rank,
                                    reduce_from_model, sum_model)
from .layers import _weight, rms_norm, split_rms_norm, stat

#: the regions that split a cell over ``"model"`` (module docstring)
CELL_REGIONS = frozenset({"cell", "cell_values"})


def _own_channels(w, n: int, dim: int = -1):
    """This rank's ``n`` channels of ``w`` (dim ``dim``), which holds
    every rank's: the run from ``model_rank() * n``."""
    return w.narrow(dim, model_rank() * n, n)


def _norm(h, scale, cfg, split: bool):
    """The cells' ``out_norm`` over ``d``; over this rank's channels
    where ``split`` (``scale`` whole, sliced to them)."""
    if not split:
        return rms_norm(h, scale, cfg.norm_eps)
    return split_rms_norm(h, _own_channels(scale, h.shape[-1]), cfg.norm_eps)


def _ones(n, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(n, dtype=dtype, device=device),
                        requires_grad=False)


# ------------------------------------------------------------------- mLSTM
class MLSTM(nn.Module):
    """``wq wk wv`` (d, d), the per-head gates ``wi wf`` (d, H),
    ``wo_gate wo`` (d, d) and ``out_norm`` (d,)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        for name in ("wq", "wk", "wv"):
            setattr(self, name, _weight((d, d), dtype, device))
        self.wi = _weight((d, H), dtype, device)
        self.wf = _weight((d, H), dtype, device)
        self.wo_gate = _weight((d, d), dtype, device)
        self.wo = _weight((d, d), dtype, device)
        self.out_norm = _ones(d, dtype, device)


def _mlstm_step(state, q, k, v, i_pre, f_pre, dk):
    """One recurrence step with the exponential-gating stabilizer m."""
    C, n, m = state
    logf = F.logsigmoid(stat(f_pre))
    m_new = torch.maximum(logf + m, stat(i_pre))
    i_g = torch.exp(stat(i_pre) - m_new)
    f_g = torch.exp(logf + m - m_new)
    kf = stat(k) / math.sqrt(dk)
    C = f_g[..., None, None] * C + i_g[..., None, None] * (
        kf[..., :, None] * stat(v)[..., None, :])
    n = f_g[..., None] * n + i_g[..., None] * kf
    qf = stat(q)
    num = torch.einsum("bhk,bhkv->bhv", qf, C)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", qf, n)),
                        qf.new_ones(()))
    return (C, n, m_new), num / den[..., None]


def mlstm_block(x, p, cfg, state=None, split=frozenset()):
    """x (B, S, d) -> (out (B, S, d), final state); ``split`` (module
    docstring) runs this rank's heads or value columns."""
    B, S, d = x.shape
    H = cfg.n_heads
    dk = d // H
    split = split & CELL_REGIONS
    wq, wk, wi, wf = p.wq, p.wk, p.wi, p.wf
    if split:
        x = copy_to_model(x)
    if "cell_values" in split:           # the head of this rank's columns
        head = model_rank() * H // mesh_axis_size("model")
        wq, wk = (w[:, head * dk:(head + 1) * dk] for w in (wq, wk))
        wi, wf = wi[:, head:head + 1], wf[:, head:head + 1]
    Hl = wi.shape[1]                     # the heads this rank runs
    dv = p.wv.shape[1] // Hl             # their value columns it holds
    q = (x @ wq).reshape(B, S, Hl, dk)
    k = (x @ wk).reshape(B, S, Hl, dk)
    v = (x @ p.wv).reshape(B, S, Hl, dv)
    i_pre = x @ wi
    f_pre = x @ wf
    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        state = (torch.zeros((B, Hl, dk, dv), **f32),
                 torch.zeros((B, Hl, dk), **f32), torch.zeros((B, Hl), **f32))
    hs = []
    for t in range(S):
        state, h = _mlstm_step(state, q[:, t], k[:, t], v[:, t], i_pre[:, t],
                               f_pre[:, t], dk)
        hs.append(h)
    h = torch.stack(hs, 1).reshape(B, S, Hl * dv).to(x.dtype)
    h = _norm(h, p.out_norm, cfg, bool(split))
    gate = F.silu(x @ p.wo_gate)
    out = (h * gate) @ p.wo
    return (reduce_from_model(out) if split else out), state


# ------------------------------------------------------------------- sLSTM
class SLSTM(nn.Module):
    """``wz wi wf wo_gate`` (d, d), the recurrent mixing ``r`` (d, d),
    ``wo`` (d, d) and ``out_norm`` (d,)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg.d_model
        for name in ("wz", "wi", "wf", "wo_gate", "r", "wo"):
            setattr(self, name, _weight((d, d), dtype, device))
        self.out_norm = _ones(d, dtype, device)


def slstm_block(x, p, cfg, state=None, split=frozenset()):
    """x (B, S, d) -> (out (B, S, d), final state).  The recurrent term
    ``rec`` is rounded to the model dtype (``h_prev`` cast down for the
    matmul) and enters the z, i and f pre-activations, not o.
    ``split`` (module docstring) runs this rank's channels."""
    B, S, d = x.shape
    split = "cell" in split
    if split:
        x = copy_to_model(x)
    z_pre = x @ p.wz
    i_pre = x @ p.wi
    f_pre = x @ p.wf
    o_pre = x @ p.wo_gate
    if state is None:
        state = tuple(torch.zeros((B, z_pre.shape[-1]), dtype=torch.float32,
                                  device=x.device) for _ in range(4))
    c, n, m, h = state
    hs = []
    for t in range(S):
        h_prev = h.to(x.dtype)
        if split:
            h_prev = gather_model(h_prev, -1)
        rec = stat(h_prev @ p.r)
        ip = stat(i_pre[:, t]) + rec
        zt = torch.tanh(stat(z_pre[:, t]) + rec)
        logf = F.logsigmoid(stat(f_pre[:, t]) + rec)
        m_new = torch.maximum(logf + m, ip)
        i_g = torch.exp(ip - m_new)
        f_g = torch.exp(logf + m - m_new)
        c = f_g * c + i_g * zt
        n = f_g * n + i_g
        h = torch.sigmoid(stat(o_pre[:, t])) * c / torch.maximum(
            n, n.new_ones(()))
        m = m_new
        hs.append(h)
    out = torch.stack(hs, 1).to(x.dtype)
    out = _norm(out, p.out_norm, cfg, split) @ p.wo
    return (reduce_from_model(out) if split else out), (c, n, m, h)


# ------------------------------------------------------- mamba-style SSM
class Mamba(nn.Module):
    """``w_in`` (d, 2 di), the depthwise ``conv`` (W, di), ``w_bcdt``
    (di, 2N + 1), ``w_out`` (di, d) in the model dtype; ``a_log`` (di, N),
    ``d_skip`` and ``dt_bias`` (di,) in fp32 whatever the model dtype, as
    the reference.  ``a_log``, ``d_skip`` and ``dt_bias`` hold the
    reference's init (log 1..N per channel, ones, zeros)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, N = cfg.d_model, cfg.ssm_state
        di = cfg.ssm_expand * d
        self.w_in = _weight((d, 2 * di), dtype, device)
        self.conv = _weight((cfg.conv_width, di), dtype, device)
        self.w_bcdt = _weight((di, 2 * N + 1), dtype, device)
        a = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=device))
        self.a_log = nn.Parameter(a[None, :].expand(di, N).contiguous(),
                                  requires_grad=False)
        self.d_skip = _ones(di, torch.float32, device)
        self.dt_bias = nn.Parameter(torch.zeros(di, dtype=torch.float32,
                                                device=device),
                                    requires_grad=False)
        self.w_out = _weight((di, d), dtype, device)


def mamba_block(x, p, cfg, state=None, split=frozenset()):
    """Selective SSM: x (B, S, d) -> (out (B, S, d), (s, conv tail));
    ``split`` (module docstring) runs this rank's channels."""
    B, S, d = x.shape
    di = cfg.ssm_expand * d
    N = cfg.ssm_state
    W = cfg.conv_width
    split = "cell" in split
    w_in, conv, a_log, d_skip, dt_bias = (p.w_in, p.conv, p.a_log,
                                          p.d_skip, p.dt_bias)
    if split:
        x = copy_to_model(x)
        dl = p.w_out.shape[0]            # this rank's channels
        w_in = torch.cat([_own_channels(w_in[:, :di], dl),
                          _own_channels(w_in[:, di:], dl)], dim=1)
        conv, d_skip, dt_bias = (_own_channels(t, dl)
                                 for t in (conv, d_skip, dt_bias))
        a_log = _own_channels(a_log, dl, 0)
        di = dl
    xi, z = torch.chunk(x @ w_in, 2, dim=-1)            # (B, S, di) each
    if state is None:
        s = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
        conv_tail = torch.zeros((B, W - 1, di), dtype=x.dtype,
                                device=x.device)
    else:
        s, conv_tail = state

    # causal depthwise conv over time (window W), in the model dtype
    xpad = torch.cat([conv_tail, xi], dim=1)            # (B, S + W - 1, di)
    xc = sum(xpad[:, i:i + S] * conv[i] for i in range(W))
    xc = F.silu(xc)
    # a copy, so the state does not hold the whole padded sequence
    new_tail = (xpad[:, -(W - 1):].clone(memory_format=torch.contiguous_format)
                if W > 1 else conv_tail)

    if split:        # each rank's channels' share, summed in fp32
        bcdt = sum_model(stat(xc) @ stat(p.w_bcdt)).to(x.dtype)
    else:
        bcdt = xc @ p.w_bcdt                            # (B, S, 2N + 1)
    Bm, Cm, dt = bcdt[..., :N], bcdt[..., N:2 * N], bcdt[..., 2 * N:]
    # a per-position step size, per channel through dt_bias; rounded to
    # the model dtype as the reference streams it ("bf16 on the wire")
    dt = F.softplus(dt.float() + dt_bias[None, None, :]).to(x.dtype)
    A = -torch.exp(a_log)                               # (di, N), negative
    ys = []
    for t in range(S):
        dt_f = dt[:, t].float()
        dA = torch.exp(dt_f[..., None] * A[None])        # (B, di, N)
        dB = dt_f[..., None] * Bm[:, t].float()[:, None, :]
        s = dA * s + dB * xc[:, t].float()[..., None]
        ys.append(torch.einsum("bdn,bn->bd", s, Cm[:, t].float()).to(xc.dtype))
    y = torch.stack(ys, 1) + xc.float() * d_skip
    y = (y.to(x.dtype) * F.silu(z)) @ p.w_out
    return (reduce_from_model(y) if split else y), (s, new_tail)
