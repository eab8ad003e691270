"""Multi-head Latent Attention (MiniCPM3-4B / DeepSeek-V2 family), in PyTorch.

The port of ``repro/models/mla.py``.  Queries go through a low-rank
bottleneck (q_lora_rank); keys/values are compressed into a small latent
c_kv (kv_lora_rank) plus a shared rotary key slice, so the decode cache
stores only (c_kv, k_rope): kv_lora_rank + qk_rope_head_dim values per
token instead of 2 * H * head_dim.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..distributed.sharding import (copy_to_model, global_rows,
                                    reduce_from_model, slot_range)
from .blockwise_attn import blockwise_sdpa, should_use_blockwise
from .layers import (_weight, apply_rope, rms_norm, rope_angles,
                     split_softmax)


class MLA(nn.Module):
    """The MLA projections, with the reference's names: ``wq_down``,
    ``q_norm`` (q_lora_rank,), ``wq_up``, ``wkv_down``, ``kv_norm``
    (kv_lora_rank,), ``wk_up``, ``wv_up``, ``wo``."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        m = cfg.mla
        d, H = cfg.d_model, cfg.n_heads
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        self.wq_down = _weight((d, m.q_lora_rank), dtype, device)
        self.q_norm = nn.Parameter(torch.ones(m.q_lora_rank, dtype=dtype,
                                              device=device),
                                   requires_grad=False)
        self.wq_up = _weight((m.q_lora_rank, H * qk_dim), dtype, device)
        self.wkv_down = _weight((d, m.kv_lora_rank + m.qk_rope_head_dim),
                                dtype, device)
        self.kv_norm = nn.Parameter(torch.ones(m.kv_lora_rank, dtype=dtype,
                                               device=device),
                                    requires_grad=False)
        self.wk_up = _weight((m.kv_lora_rank, H * m.qk_nope_head_dim), dtype,
                             device)
        self.wv_up = _weight((m.kv_lora_rank, H * m.v_head_dim), dtype, device)
        self.wo = _weight((H * m.v_head_dim, d), dtype, device)


def mla_attention(x, p, cfg, *, positions, cache=None, cache_index=None,
                  split=frozenset(), slots=False):
    """Returns (out, cache).

    Without ``cache``: x (B, S, d), causal attention over K/V built from
    the latent, blockwise past ``BLOCKWISE_THRESHOLD`` (V is
    ``v_head_dim`` wide, Q/K ``qk_nope + qk_rope``); the cache returned
    is the raw per-position dict(c_kv (B, S, R), k_rope (B, S, Dr)).  With ``cache`` (the same
    keys, (B, T, ...)): x (B, 1, d) is written in place at slot
    ``cache_index`` (int) and attends in the *absorbed* form, which reads
    only the latent cache; slots up to ``cache_index`` attend (no stored
    positions).

    With ``"attn"`` in ``split`` (the sharded step's regions split over
    ``"model"``, ``models/transformer.py::model_plan``), ``wq_up``,
    ``wk_up``, ``wv_up`` (columns) and ``wo`` (rows) hold this rank's
    heads, and the down projections and their norms every rank's
    (``wq_down``, whose cut would split the latent its norm spans,
    gathered): x enters through ``copy_to_model`` and the output is
    summed over the axis, in the prefill and in the absorbed decode alike;
    the latent cache is every rank's.  ``slots`` (one row whose latent
    slots are split over ``"data"``): the cache holds this rank's run of
    slots, the one at ``cache_index`` is written by the rank that holds
    it, and the ranks merge their partial softmaxes
    (``layers.split_softmax``).  The blockwise switch reads the global
    rows (``sharding.global_rows``).
    """
    m = cfg.mla
    B, S, _ = x.shape
    R = m.kv_lora_rank
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    qk_dim = nope + rope
    H = p.wq_up.shape[1] // qk_dim            # this rank's heads
    split = "attn" in split
    if split:
        x = copy_to_model(x)

    q = rms_norm(x @ p.wq_down, p.q_norm, cfg.norm_eps) @ p.wq_up
    q = q.reshape(B, S, H, qk_dim)
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    kv = x @ p.wkv_down                                   # (B, S, R + Dr)
    c_kv = rms_norm(kv[..., :R], p.kv_norm, cfg.norm_eps)
    k_rope_new = kv[..., R:][:, :, None, :]               # (B, S, 1, Dr)

    cos, sin = rope_angles(positions, rope, cfg.rope_base)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope_new = apply_rope(k_rope_new, cos, sin)[:, :, 0]  # (B, S, Dr)

    if cache is None:
        k_nope = (c_kv @ p.wk_up).reshape(B, S, H, nope)
        v = (c_kv @ p.wv_up).reshape(B, S, H, m.v_head_dim)
        k_cat = torch.cat([k_nope, k_rope_new[:, :, None, :].expand(
            B, S, H, rope)], -1)
        q_cat = torch.cat([q_nope, q_rope], -1)           # (B, S, H, qk_dim)
        if should_use_blockwise(global_rows(B), S, S, cfg.n_heads):
            out = blockwise_sdpa(q_cat, k_cat, v, qpos=positions,
                                 kpos=positions, kind="causal")
        else:
            sc = torch.einsum("bshd,bthd->bhst", q_cat.float(),
                              k_cat.float()) / math.sqrt(qk_dim)
            idx = torch.arange(S, device=x.device)
            mask = idx[None, :] <= idx[:, None]
            sc = torch.where(mask[None, None], sc, -1e30)
            w = torch.softmax(sc, dim=-1)
            out = torch.einsum("bhst,bthd->bshd", w, v.float())
        out = out.reshape(B, S, H * m.v_head_dim).to(x.dtype) @ p.wo
        if split:
            out = reduce_from_model(out)
        return out, {"c_kv": c_kv, "k_rope": k_rope_new}

    # ---- decode: absorbed attention ---------------------------------------
    # score = q_nope . (c_kv W_uk)^T == (q_nope W_uk^T) . c_kv, so the step
    # reads only the latent cache and never builds (B, T, H, D) keys.
    ck, kr = cache["c_kv"], cache["k_rope"]
    T = ck.shape[1]
    lo = slot_range(T)[0] if slots else 0
    if lo <= cache_index < lo + T:            # this rank holds the slot
        ck[:, cache_index - lo:cache_index - lo + S] = c_kv
        kr[:, cache_index - lo:cache_index - lo + S] = k_rope_new
    ckf = ck.float()
    wk = p.wk_up.reshape(R, H, nope).float()
    q_abs = torch.einsum("bshd,rhd->bshr", q_nope.float(), wk)    # (B,1,H,R)
    sc = (torch.einsum("bshr,btr->bhst", q_abs, ckf)
          + torch.einsum("bshd,btd->bhst", q_rope.float(), kr.float())
          ) / math.sqrt(qk_dim)
    mask = (torch.arange(T, device=x.device) + lo <= cache_index)[
        None, None, None, :]
    if slots:
        num, den = split_softmax(
            sc, mask, lambda w: torch.einsum("bhst,btr->bhsr", w, ckf))
        ctx = (num / den).transpose(1, 2)                        # (B,1,H,R)
    else:
        sc = torch.where(mask, sc, -1e30)
        w = torch.softmax(sc, dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", w, ckf)             # (B,1,H,R)
    wv = p.wv_up.reshape(R, H, m.v_head_dim).float()
    out = torch.einsum("bshr,rhd->bshd", ctx, wv)
    out = out.reshape(B, S, H * m.v_head_dim).to(x.dtype) @ p.wo
    if split:
        out = reduce_from_model(out)
    return out, cache
