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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import _weight, rms_norm, stat


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


def mlstm_block(x, p, cfg, state=None):
    """x (B, S, d) -> (out (B, S, d), final state)."""
    B, S, d = x.shape
    H = cfg.n_heads
    dk = d // H
    q = (x @ p.wq).reshape(B, S, H, dk)
    k = (x @ p.wk).reshape(B, S, H, dk)
    v = (x @ p.wv).reshape(B, S, H, dk)
    i_pre = x @ p.wi
    f_pre = x @ p.wf
    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        state = (torch.zeros((B, H, dk, dk), **f32),
                 torch.zeros((B, H, dk), **f32), torch.zeros((B, H), **f32))
    hs = []
    for t in range(S):
        state, h = _mlstm_step(state, q[:, t], k[:, t], v[:, t], i_pre[:, t],
                               f_pre[:, t], dk)
        hs.append(h)
    h = torch.stack(hs, 1).reshape(B, S, d).to(x.dtype)
    h = rms_norm(h, p.out_norm, cfg.norm_eps)
    gate = F.silu(x @ p.wo_gate)
    return (h * gate) @ p.wo, state


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


def slstm_block(x, p, cfg, state=None):
    """x (B, S, d) -> (out (B, S, d), final state).  The recurrent term
    ``rec`` is rounded to the model dtype (``h_prev`` cast down for the
    matmul) and enters the z, i and f pre-activations, not o."""
    B, S, d = x.shape
    z_pre = x @ p.wz
    i_pre = x @ p.wi
    f_pre = x @ p.wf
    o_pre = x @ p.wo_gate
    if state is None:
        state = tuple(torch.zeros((B, d), dtype=torch.float32,
                                  device=x.device) for _ in range(4))
    c, n, m, h = state
    hs = []
    for t in range(S):
        rec = stat(h.to(x.dtype) @ p.r)
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
    out = rms_norm(out, p.out_norm, cfg.norm_eps)
    return out @ p.wo, (c, n, m, h)


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


def mamba_block(x, p, cfg, state=None):
    """Selective SSM: x (B, S, d) -> (out (B, S, d), (s, conv tail))."""
    B, S, d = x.shape
    di = cfg.ssm_expand * d
    N = cfg.ssm_state
    W = cfg.conv_width
    xi, z = torch.chunk(x @ p.w_in, 2, dim=-1)          # (B, S, di) each
    if state is None:
        s = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
        conv_tail = torch.zeros((B, W - 1, di), dtype=x.dtype,
                                device=x.device)
    else:
        s, conv_tail = state

    # causal depthwise conv over time (window W), in the model dtype
    xpad = torch.cat([conv_tail, xi], dim=1)            # (B, S + W - 1, di)
    xc = sum(xpad[:, i:i + S] * p.conv[i] for i in range(W))
    xc = F.silu(xc)
    # a copy, so the state does not hold the whole padded sequence
    new_tail = (xpad[:, -(W - 1):].clone(memory_format=torch.contiguous_format)
                if W > 1 else conv_tail)

    bcdt = xc @ p.w_bcdt                                # (B, S, 2N + 1)
    Bm, Cm, dt = bcdt[..., :N], bcdt[..., N:2 * N], bcdt[..., 2 * N:]
    # a per-position step size, per channel through dt_bias; rounded to
    # the model dtype as the reference streams it ("bf16 on the wire")
    dt = F.softplus(dt.float() + p.dt_bias[None, None, :]).to(x.dtype)
    A = -torch.exp(p.a_log)                             # (di, N), negative
    ys = []
    for t in range(S):
        dt_f = dt[:, t].float()
        dA = torch.exp(dt_f[..., None] * A[None])        # (B, di, N)
        dB = dt_f[..., None] * Bm[:, t].float()[:, None, :]
        s = dA * s + dB * xc[:, t].float()[..., None]
        ys.append(torch.einsum("bdn,bn->bd", s, Cm[:, t].float()).to(xc.dtype))
    y = torch.stack(ys, 1) + xc.float() * p.d_skip
    y = (y.to(x.dtype) * F.silu(z)) @ p.w_out
    return y, (s, new_tail)
