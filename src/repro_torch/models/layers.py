"""Transformer layers in PyTorch: norms, RoPE, GQA attention, MLPs.

The port of ``repro/models/layers.py`` for the attention backbones (full
and sliding-window causal attention).  Conventions kept from the JAX
package:

  * weights keep the JAX layout, ``(in, out)``, so ``x @ w`` reads as
    there and ``models/convert.py`` copies a JAX param tree across as it is;
  * all softmax / norm statistics accumulate in fp32;
  * attention is the einsum form of ``_sdpa`` with -1e30 masking; the
    contiguous decode cache is ``(B, S_max, KVH, D)`` plus stored positions.
    Where JAX returns an updated copy (``dynamic_update_slice``), the port
    writes the new token into the cache tensors in place.

Not ported (ROADMAP.md, queue 1, item 10): M-RoPE, the int8 KV cache and
blockwise attention.  ``attention`` raises where the JAX code would take
one of them; it never does something else quietly.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

#: score-tensor element threshold above which the JAX package's attention
#: goes blockwise (``repro/models/blockwise_attn.py``).
BLOCKWISE_THRESHOLD = 32 * 1024 * 1024


def should_use_blockwise(B, S, T, H) -> bool:
    return B * S * T * H > BLOCKWISE_THRESHOLD


# --------------------------------------------------------------------- init
def _dense_init(shape, dtype, generator, device, fan_in=None):
    """normal / sqrt(fan_in), drawn in fp32 from ``generator`` on ``device``
    (the JAX init's distribution, not its bits)."""
    fan_in = fan_in or shape[0]
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return w.div_(math.sqrt(fan_in)).to(dtype)


def _weight(shape, dtype, device) -> nn.Parameter:
    """An uninitialised inference weight (filled by an init or a copy)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# -------------------------------------------------------------------- norms
def rms_norm(x, scale, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x, scale, bias, eps):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


class Norm(nn.Module):
    """Norm parameters: ``scale`` (and ``bias`` for ``kind="layer"``)."""

    def __init__(self, d, kind, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                  requires_grad=False)
        if kind != "rms":
            self.bias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device),
                                     requires_grad=False)


def apply_norm(x, p, kind, eps):
    if kind == "rms":
        return rms_norm(x, p.scale, eps)
    return layer_norm(x, p.scale, p.bias, eps)


# --------------------------------------------------------------------- RoPE
def rope_angles(positions, dim, base):
    """positions (..., S) -> cos/sin (..., S, dim//2), fp32."""
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (B, S, H, D) with cos/sin (B, S, D//2) [or broadcastable]."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


# ---------------------------------------------------------------- attention
class Attention(nn.Module):
    """GQA projection weights (``wq wk wv wo``, optional q/k norm scales)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        self.wq = _weight((d, cfg.n_heads * hd), dtype, device)
        self.wk = _weight((d, cfg.n_kv_heads * hd), dtype, device)
        self.wv = _weight((d, cfg.n_kv_heads * hd), dtype, device)
        self.wo = _weight((cfg.n_heads * hd, d), dtype, device)
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones(hd, dtype=dtype, device=device),
                                       requires_grad=False)
            self.k_norm = nn.Parameter(torch.ones(hd, dtype=dtype, device=device),
                                       requires_grad=False)


def _sdpa(q, k, v, mask):
    """q (B,S,H,D), k/v (B,T,KVH,D) -> (B,S,H,D); fp32 softmax; GQA grouping."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    q = q.reshape(B, S, KVH, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) / math.sqrt(D)
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, S, H, D).to(v.dtype)


def causal_mask(S, T=None, window=None, offset=0, device=None):
    """(S, T) bool; True = attend.  offset = query-position of row 0."""
    T = T or S
    qpos = torch.arange(S, device=device)[:, None] + offset
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m


def project_qkv(x, p, cfg, cos, sin):
    """Projections, qk-norm and RoPE: x (B, S, d) -> q (B,S,H,D), k, v
    (B,S,KVH,D), as ``attention`` computes them before attending."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p.wq).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p.wk).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p.wv).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attention(x, p, cfg, *, positions, window=None, cache=None,
              cache_index=None, true_index=None):
    """Full-sequence causal or single-step (cache) attention; ``window``
    enables SWA (a key attends if it is at most ``window - 1`` positions
    behind the query).

    Without ``cache``: x (B, S, d); returns (out, {"k", "v"}), the raw
    per-position KV for a prefill cache.  With ``cache`` = dict(k, v, pos)
    of (B, kv_len, ...), a *ring* when kv_len < context: the new KV of x
    (B, 1, d) is written in place at slot ``cache_index`` (= true_index %
    kv_len) and masking uses the stored true positions, so rolled-over
    slots are handled exactly.  Returns (out, cache).  The reference's
    ``kind="bidir"`` belongs to the encoder block, which is not ported
    (ROADMAP.md, queue 1, item 9g).
    """
    if cfg.mrope_sections is not None:
        raise NotImplementedError("M-RoPE is not ported (ROADMAP.md, queue 1, "
                                  "item 10)")
    B, S, _ = x.shape
    cos, sin = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_base)
    q, k, v = project_qkv(x, p, cfg, cos, sin)

    if cache is None:
        if should_use_blockwise(B, S, S, cfg.n_heads):
            raise NotImplementedError(
                f"B*S*S*H = {B * S * S * cfg.n_heads} > {BLOCKWISE_THRESHOLD}: "
                "the reference attends blockwise here, which is not ported "
                "(ROADMAP.md, queue 1, item 10)")
        mask = causal_mask(S, window=window, device=x.device)
        out = _sdpa(q, k, v, mask.expand(B, S, S))
        new_cache = {"k": k, "v": v}
    else:
        if cache["k"].dtype == torch.int8:
            raise NotImplementedError("the int8 KV cache is not ported "
                                      "(ROADMAP.md, queue 1, item 10)")
        tidx = true_index if true_index is not None else cache_index
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        ck[:, cache_index:cache_index + S] = k
        cv[:, cache_index:cache_index + S] = v
        cpos[:, cache_index:cache_index + 1] = tidx
        T = ck.shape[1]
        if should_use_blockwise(B, 1, T, cfg.n_heads):
            raise NotImplementedError(
                f"B*T*H = {B * T * cfg.n_heads} > {BLOCKWISE_THRESHOLD}: the "
                "reference decodes blockwise here, which is not ported "
                "(ROADMAP.md, queue 1, item 10)")
        m = (cpos <= tidx) & (cpos >= 0)
        if window is not None:
            m = m & (cpos > tidx - window)
        out = _sdpa(q, ck, cv, m[:, None, :]).to(x.dtype)
        new_cache = cache
    out = out.reshape(B, S, cfg.n_heads * cfg.resolved_head_dim) @ p.wo
    return out, new_cache


# --------------------------------------------------------------------- MLPs
class MLP(nn.Module):
    """``wi`` / ``wo``, plus the gate ``wg`` for the gated kinds."""

    def __init__(self, d, d_ff, kind, dtype, device):
        super().__init__()
        self.wi = _weight((d, d_ff), dtype, device)
        if kind in ("swiglu", "geglu"):
            self.wg = _weight((d, d_ff), dtype, device)
        self.wo = _weight((d_ff, d), dtype, device)


def mlp(x, p, kind):
    # jax.nn.gelu defaults to the tanh approximation.
    if kind == "swiglu":
        return (F.silu(x @ p.wg) * (x @ p.wi)) @ p.wo
    if kind == "geglu":
        return (F.gelu(x @ p.wg, approximate="tanh") * (x @ p.wi)) @ p.wo
    return F.gelu(x @ p.wi, approximate="tanh") @ p.wo
