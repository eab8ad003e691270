"""Transformer layers in PyTorch: norms, RoPE/M-RoPE, GQA attention, MLPs.

The port of ``repro/models/layers.py``.  Conventions kept from the JAX
package:

  * weights keep the JAX layout, ``(in, out)``, so ``x @ w`` reads as
    there and ``models/convert.py`` copies a JAX param tree across as it is;
  * all softmax / norm statistics accumulate in fp32;
  * attention is the einsum form of ``_sdpa`` with -1e30 masking, or
    ``blockwise_attn.blockwise_sdpa`` where the score tensor would pass
    ``BLOCKWISE_THRESHOLD`` elements; the contiguous decode cache is
    ``(B, S_max, KVH, D)`` plus stored positions, int8 with per (token,
    kv-head) fp32 scales when the cache tensors are int8.  Where JAX
    returns an updated copy (``dynamic_update_slice``), the port writes
    the new token into the cache tensors in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import (all_reduce_max, copy_to_model,
                                    data_sum, global_rows, mesh_axis_size,
                                    model_rank, reduce_from_model,
                                    slot_range, sum_model)
from .blockwise_attn import blockwise_sdpa, should_use_blockwise


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


def stat(x):
    """``x`` for statistics and recurrent state: fp32, as the reference's
    ``astype(jnp.float32)``, except that a float64 tensor stays float64
    (a float64 model, as the float64 checks of the tests run one)."""
    return x if x.dtype == torch.float64 else x.float()


# -------------------------------------------------------------------- norms
def rms_norm(x, scale, eps):
    xf = stat(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def split_rms_norm(x, scale, eps):
    """:func:`rms_norm` of ``x`` whose last dim is this rank's slice of
    channels split over ``"model"`` (``scale`` the slice's): the fp32 sum
    of squares summed over the axis, forward and backward
    (``sharding.sum_model``), over the whole width."""
    xf = stat(x)
    width = x.shape[-1] * mesh_axis_size("model")
    var = sum_model(torch.sum(xf * xf, dim=-1, keepdim=True)) / width
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x, scale, bias, eps):
    xf = stat(x)
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


def mrope_angles(positions, dim, base, sections):
    """M-RoPE (Qwen2-VL): rotary dims partitioned into (t, h, w) sections.

    positions: (3, B, S), the temporal/height/width position ids.  For
    pure text the three rows are equal and M-RoPE is RoPE exactly.
    """
    half = dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} must sum to {half}")
    cos_all, sin_all = rope_angles(positions, dim, base)   # (3, B, S, half)
    chunks_c, chunks_s = [], []
    start = 0
    for i, sec in enumerate(sections):
        chunks_c.append(cos_all[i, ..., start:start + sec])
        chunks_s.append(sin_all[i, ..., start:start + sec])
        start += sec
    return torch.cat(chunks_c, -1), torch.cat(chunks_s, -1)


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


def _quantize_kv(t):
    """(B,S,KVH,D) -> int8 values + (B,S,KVH) fp32 symmetric scales
    (``torch.round`` rounds half to even, as ``jnp.round``)."""
    tf = t.float()
    scale = torch.clamp(tf.abs().amax(dim=-1), min=1e-8) / 127.0
    w = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return w.to(torch.int8), scale


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


def _sdpa_slots(q, k, v, mask):
    """:func:`_sdpa` of one decode step over slots split across
    ``"data"`` (this rank's ``k``/``v`` (B, T', KVH, D), ``mask`` (B, 1,
    T')): the same grouping, merged by :func:`split_softmax`."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    q = q.reshape(B, S, KVH, H // KVH, D)
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(),
                          k.float()) / math.sqrt(D)
    num, den = split_softmax(
        scores, mask[:, None, None, :, :],
        lambda w: torch.einsum("bkgst,btkd->bkgsd", w, v.float()))
    out = (num / den).permute(0, 3, 1, 2, 4)          # (B, S, KVH, G, D)
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
    (B,S,KVH,D), as ``attention`` computes them before attending.  H and
    KVH are the heads the weights hold: a rank's own under the sharded
    step's split over ``"model"``."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p.wq).reshape(B, S, -1, hd)
    k = (x @ p.wk).reshape(B, S, -1, hd)
    v = (x @ p.wv).reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _own_kv_heads(t, H_local: int, cfg):
    """The KV heads (B, S, KVH, D) ``t`` of every rank reduced to those
    that this rank's ``H_local`` query heads read (heads ``r * H_local``
    on, r its ``"model"`` index): a contiguous run of whole groups, one
    head shared by them all, or, where the groups straddle ranks, one KV
    head per query head."""
    G = cfg.n_heads // cfg.n_kv_heads
    first = model_rank() * H_local
    if H_local % G == 0:
        return t[:, :, first // G:(first + H_local) // G]
    if G % H_local == 0:
        return t[:, :, first // G:first // G + 1]
    idx = torch.arange(first, first + H_local, device=t.device) // G
    return t.index_select(2, idx)


def split_softmax(sc, mask, values):
    """Softmax attention over slots split across ``"data"``: ``sc`` the
    fp32 scores (..., T') over this rank's slots, ``mask`` where they
    attend, ``values(w)`` the product of weights (..., T') with this
    rank's values.  A log-sum-exp merge: the max over every rank's slots
    (all-reduced), then this rank's sum of exps and weighted values,
    summed over the axis in one all-reduce; a rank whose slots are all
    masked adds nothing.  Returns (the weighted values, the sum of exps),
    each summed over the axis, fp32: their quotient is the output."""
    sc = torch.where(mask, sc, -1e30)
    top = all_reduce_max(sc.amax(dim=-1, keepdim=True), "data")
    w = torch.exp(sc - top)
    num, den = data_sum(values(w), w.sum(dim=-1, keepdim=True))
    return num, den


def attention(x, p, cfg, *, positions, kind="causal", window=None,
              cache=None, cache_index=None, true_index=None,
              mrope_positions=None, split=frozenset(), slots=False):
    """Full-sequence or single-step (cache) attention.

    ``kind`` is ``"causal"`` or ``"bidir"``; ``window`` enables SWA (a key
    attends if it is at most ``window - 1`` positions behind the query).
    With ``cfg.mrope_sections``, M-RoPE over ``mrope_positions`` (3, B,
    S), whose rows default to ``positions``; else RoPE over ``positions``.

    Without ``cache``: x (B, S, d); returns (out, {"k", "v"}), the raw
    per-position KV for a prefill cache.  With ``cache`` = dict(k, v, pos)
    of (B, kv_len, ...), a *ring* when kv_len < context: the new KV of x
    (B, 1, d) is written in place at slot ``cache_index`` (= true_index %
    kv_len) and masking uses the stored true positions, so rolled-over
    slots are handled exactly.  An int8 cache (``k``/``v`` int8, plus
    ``k_scale``/``v_scale``) stores the token quantized and attends over
    the dequantized cache: the cache tensor's dtype picks the path, as in
    the reference.  Returns (out, cache).

    With ``"attn"`` in ``split`` (the sharded step's regions split over
    ``"model"``, ``models/transformer.py::model_plan``) the weights hold
    this rank's query heads (``wq`` column-, ``wo`` row-parallel) and,
    with ``"kv"``, its KV heads, else every KV head
    (:func:`_own_kv_heads` picks those its queries read): x enters
    through ``copy_to_model`` and the output is summed over the axis.
    The KV a prefill returns, and a cache, hold this rank's KV heads
    with ``"kv"``, else every KV head.

    ``slots`` (a decode step of one row whose cache's slots are split
    over ``"data"``, ``sharding.slots_split``): the cache holds this
    rank's run of slots, ``cache_index`` is the global slot, written by
    the rank that holds it, and the ranks merge their partial softmaxes
    (:func:`split_softmax`).  Whether to attend blockwise is decided on
    the global rows (``sharding.global_rows``), as the reference's GSPMD
    step decides on the global batch.
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H = p.wq.shape[1] // hd                   # the heads this rank holds
    heads = "attn" in split
    if heads:
        x = copy_to_model(x)
    if cfg.mrope_sections is not None:
        pos3 = mrope_positions
        if pos3 is None:
            pos3 = positions.expand((3,) + tuple(positions.shape))
        cos, sin = mrope_angles(pos3, hd, cfg.rope_base, cfg.mrope_sections)
    else:
        cos, sin = rope_angles(positions, hd, cfg.rope_base)
    q, k, v = project_qkv(x, p, cfg, cos, sin)
    new_cache = {"k": k, "v": v}
    own = heads and "kv" not in split         # the cache holds every head
    if own:
        k, v = _own_kv_heads(k, H, cfg), _own_kv_heads(v, H, cfg)
    rows = global_rows(B)

    if cache is None:
        if should_use_blockwise(rows, S, S, cfg.n_heads):
            out = blockwise_sdpa(q, k, v, qpos=positions, kpos=positions,
                                 kind=kind, window=window)
        else:
            if kind == "causal":
                mask = causal_mask(S, window=window, device=x.device)
            else:
                mask = torch.ones((S, S), dtype=torch.bool, device=x.device)
            out = _sdpa(q, k, v, mask.expand(B, S, S))
    else:
        k, v = new_cache["k"], new_cache["v"]
        tidx = true_index if true_index is not None else cache_index
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        quant = ck.dtype == torch.int8
        T = ck.shape[1]
        lo = slot_range(T)[0] if slots else 0
        if lo <= cache_index < lo + T:        # this rank holds the slot
            at = slice(cache_index - lo, cache_index - lo + S)
            if quant:
                ck[:, at], cache["k_scale"][:, at] = _quantize_kv(k)
                cv[:, at], cache["v_scale"][:, at] = _quantize_kv(v)
            else:
                ck[:, at] = k
                cv[:, at] = v
            cpos[:, at] = tidx
        ks = (cache["k_scale"], cache["v_scale"]) if quant else None
        if own:
            ck, cv = _own_kv_heads(ck, H, cfg), _own_kv_heads(cv, H, cfg)
            if quant:
                ks = tuple(_own_kv_heads(t[..., None], H, cfg)[..., 0]
                           for t in ks)
        if not slots and should_use_blockwise(rows, 1, T, cfg.n_heads):
            # decode masking == causal against the stored positions
            qpos = torch.full((B, 1), tidx, dtype=torch.int32,
                              device=x.device)
            out = blockwise_sdpa(q, ck, cv, qpos=qpos, kpos=cpos,
                                 kind="causal", window=window,
                                 kv_scales=ks)
        else:
            m = (cpos <= tidx) & (cpos >= 0)
            if window is not None:
                m = m & (cpos > tidx - window)
            if quant:
                ck = ck.float() * ks[0][..., None]
                cv = cv.float() * ks[1][..., None]
            if slots:
                out = _sdpa_slots(q, ck, cv, m[:, None, :]).to(x.dtype)
            else:
                out = _sdpa(q, ck, cv, m[:, None, :]).to(x.dtype)
        new_cache = cache
    out = out.reshape(B, S, H * hd) @ p.wo
    if heads:
        out = reduce_from_model(out)
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


def mlp(x, p, kind, split=False):
    """The MLP of ``kind``.  ``split`` (the sharded step's ``"mlp"``
    region, ``models/transformer.py::model_plan``): the weights hold this
    rank's hidden units (``wi``/``wg`` columns, ``wo`` rows), x enters
    through ``copy_to_model`` and the output is summed over the axis."""
    if split:
        return reduce_from_model(_mlp(copy_to_model(x), p, kind))
    return _mlp(x, p, kind)


def _mlp(x, p, kind):
    # jax.nn.gelu defaults to the tanh approximation.
    if kind == "swiglu":
        return (F.silu(x @ p.wg) * (x @ p.wi)) @ p.wo
    if kind == "geglu":
        return (F.gelu(x @ p.wg, approximate="tanh") * (x @ p.wi)) @ p.wo
    return F.gelu(x @ p.wi, approximate="tanh") @ p.wo
