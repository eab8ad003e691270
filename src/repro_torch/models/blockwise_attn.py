"""Blockwise (flash-style) attention in plain PyTorch.

The port of ``repro/models/blockwise_attn.py``.  Naive attention builds
(B, H, S, T) fp32 scores; this runs the online-softmax recurrence over
query chunks (outer loop) and KV chunks (inner loop), so a layer's
attention holds O(q_chunk * kv_chunk) scores at a time.  Masks (causal,
sliding-window, bidir, cache positions) are computed per chunk pair from
positions.

The recurrence is the reference's as written, which fixes what a query
with no valid key gets.  Masked scores are -1e30 (not -inf) and the
running max starts at -1e30, so such a row weighs every slot of every KV
chunk it visits by exp(0) = 1, padding included (padded slots hold zeros):
it returns sum(V over the real slots) / (chunks * kv_chunk), where the
naive ``layers._sdpa`` returns the mean of the real V rows (ROADMAP.md §3).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _pad_to(x, axis, mult):
    """Zero-pad ``axis`` of ``x`` up to a multiple of ``mult``; returns
    (padded, original length)."""
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x, n
    widths = [0, 0] * (x.dim() - axis - 1) + [0, pad]
    return F.pad(x, widths), n


def blockwise_sdpa(q, k, v, *, qpos, kpos, kind: str = "causal",
                   window: int | None = None, q_chunk: int = 512,
                   kv_chunk: int = 1024, kv_scales=None):
    """q (B,S,H,D), k (B,T,KVH,D), v (B,T,KVH,Dv), qpos (B,S), kpos (B,T)
    -> (B,S,H,Dv).

    ``kpos < 0`` marks invalid (unwritten cache) slots.  ``kind`` is
    ``"causal"`` (with ``window``: a key attends if it is at most
    ``window - 1`` positions behind the query) or ``"bidir"``.
    ``kv_scales`` = (k_scale, v_scale), each (B,T,KVH), takes int8 K/V and
    dequantizes each chunk; the output is then in q's dtype, else in v's.
    """
    B, S, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    Dv = v.shape[3]
    out_dtype = v.dtype if kv_scales is None else q.dtype
    # never pad queries past the actual sequence (decode: S=1 -> qc=8)
    q_chunk = min(q_chunk, max(8, -(-S // 8) * 8))

    q5 = q.reshape(B, S, KVH, G, D).float() / math.sqrt(D)
    q5, S0 = _pad_to(q5, 1, q_chunk)
    qpos_p, _ = _pad_to(qpos, 1, q_chunk)
    nq = q5.shape[1] // q_chunk

    k, T0 = _pad_to(k, 1, kv_chunk)
    v, _ = _pad_to(v, 1, kv_chunk)
    kpos, _ = _pad_to(kpos, 1, kv_chunk)
    T = k.shape[1]
    kpos = torch.where(torch.arange(T, device=kpos.device)[None, :] >= T0,
                       -1, kpos)
    nc = T // kv_chunk
    if kv_scales is not None:
        ks_, vs_ = (_pad_to(s, 1, kv_chunk)[0] for s in kv_scales)

    outs = []
    for i in range(nq):
        qs = slice(i * q_chunk, (i + 1) * q_chunk)
        qi, qpi = q5[:, qs], qpos_p[:, qs]           # (B,qc,KVH,G,D), (B,qc)
        m = torch.full((B, KVH, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KVH, G, q_chunk), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, KVH, G, q_chunk, Dv), dtype=torch.float32,
                          device=q.device)
        for c in range(nc):
            cs = slice(c * kv_chunk, (c + 1) * kv_chunk)
            kf, vf, pc = k[:, cs].float(), v[:, cs].float(), kpos[:, cs]
            if kv_scales is not None:                # per-chunk dequant
                kf = kf * ks_[:, cs, :, None]
                vf = vf * vs_[:, cs, :, None]
            s = torch.einsum("bskgd,bckd->bkgsc", qi, kf)
            pk = pc[:, None, None, None, :]
            valid = pk >= 0
            if kind == "causal":
                pq = qpi[:, None, None, :, None]
                valid = valid & (pk <= pq)
                if window is not None:
                    valid = valid & (pk > pq - window)
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgsc,bckd->bkgsd",
                                                        p, vf)
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
        outs.append((acc / l[..., None]).to(out_dtype))  # (B,KVH,G,qc,Dv)
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4)   # (B,Sp,KVH,G,Dv)
    return out[:, :S0].reshape(B, S0, H, Dv)


#: score-tensor element threshold above which attention goes blockwise
BLOCKWISE_THRESHOLD = 32 * 1024 * 1024


def should_use_blockwise(B, S, T, H) -> bool:
    return B * S * T * H > BLOCKWISE_THRESHOLD


def tile_schedule(S: int, T: int, q_chunk: int = 512, kv_chunk: int = 1024):
    """(nq, nc, qc, kc): the chunk grid ``blockwise_sdpa`` runs."""
    qc = min(q_chunk, max(8, -(-S // 8) * 8))
    Sp = -(-S // qc) * qc
    Tp = -(-T // kv_chunk) * kv_chunk
    return Sp // qc, Tp // kv_chunk, qc, kv_chunk


def analytic_costs(B, S, T, H, D, KVH, kind="train", dtype_bytes=2):
    """Per-layer attention (flops, hbm_bytes) of the chunk grid.

    flops: 4*B*qc*kc*H*D per tile (QK^T + PV), all nq*nc tiles computed
    (masked tiles still run); training counts ~3.5x the forward.
    hbm: K and V chunks re-stream once per query chunk, plus Q/out once;
    training counts 3x.
    """
    nq, nc, qc, kc = tile_schedule(S, T)
    fwd = 4.0 * B * (nq * qc) * (nc * kc) * H * D
    flops = fwd * (3.5 if kind == "train" else 1.0)
    hbm = (nq * (nc * kc) * KVH * D * 2 * dtype_bytes * B
           + 2 * B * S * H * D * dtype_bytes)
    hbm = hbm * (3.0 if kind == "train" else 1.0)
    return flops, hbm
