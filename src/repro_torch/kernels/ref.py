"""Plain PyTorch versions of the device-tier functions (``repro/kernels/ref.py``).

Each function defines the semantics its CUDA kernel must reproduce bit for
bit; the CPU tests hold these against the JAX package's oracles and Pallas
kernels on shared numpy inputs, and ``chip_smoke.py`` (the Bloom build's
kernel: ``tests/test_torch_bloom_card.py``) holds every kernel against them
on the card.

Key representation: the device tier's keys and Bloom words are uint32.
PyTorch's ``uint32`` lacks ``searchsorted``, shifts, comparisons, ``%``
and scatter-``amax`` on the CPU, so keys and words are carried as **int64
tensors holding the uint32 value**: ``KEY_MAX32 = 0xFFFFFFFF`` still sorts
last and every comparison keeps its unsigned meaning.  Values are int32.
"""
from __future__ import annotations

import torch

KEY_MAX32 = 0xFFFFFFFF
MASK32 = 0xFFFFFFFF

# Murmur3/xxhash-style 32-bit mixing constants for Bloom hashing (the JAX
# package's BLOOM_MULTS, bit for bit).
BLOOM_MULTS = (0x85EBCA6B, 0xC2B2AE35, 0x9E3779B1, 0x27D4EB2F, 0x165667B1,
               0xD3A2646C)
BLOOM_MIX1 = 0x2C1B3C6D
BLOOM_MIX2 = 0x297A2D39


def search_steps(n: int) -> int:
    """Lockstep binary-search iterations that cover a run of length n."""
    return max(1, (n).bit_length()) + 1


def merge_sorted_ref(a_keys, a_vals, b_keys, b_vals):
    """Merge sorted runs along the last dim; equal keys keep ``a`` first.

    ``a`` is the newer stream, so a leftmost-match query sees the freshest
    record (paper Sec. 3.2.2).  A stable sort of the concatenation puts the
    ``a`` copies of a key ahead of the ``b`` copies.  Works on ``(n,)`` and
    on ``(R, n)`` batches.
    """
    keys = torch.cat([a_keys, b_keys], dim=-1)
    vals = torch.cat([a_vals, b_vals], dim=-1)
    keys, order = torch.sort(keys, dim=-1, stable=True)
    return keys, torch.gather(vals, -1, order)


def sorted_search_ref(run_keys, run_vals, queries):
    """Leftmost-match search of ``queries`` in one sorted run.

    Returns ``(found bool, vals int32 (-1 where absent), idx int32)``.
    KEY_MAX padding and KEY_MAX queries never match.
    """
    idx = torch.searchsorted(run_keys, queries)
    n = run_keys.shape[0]
    safe = idx.clamp(max=n - 1)
    found = (idx < n) & (run_keys[safe] == queries) & (queries != KEY_MAX32)
    vals = torch.where(found, run_vals[safe], -1).to(torch.int32)
    return found, vals, idx.to(torch.int32)


def range_scan_ref(run_keys, run_vals, lo, hi, max_results: int = 128):
    """Inclusive scan ``[lo, hi]`` of one sorted run.

    Returns ``(keys (Q, max_results), vals int32 (Q, max_results), count
    int32 (Q,))``; ``count`` is the total number of matches and may exceed
    ``max_results`` (the truncation signal).  The upper bound is clamped to
    the live (non-KEY_MAX) prefix, so padding never matches.
    """
    n = run_keys.shape[0]
    n_live = (run_keys != KEY_MAX32).sum()
    start = torch.searchsorted(run_keys, lo)
    end = torch.minimum(torch.searchsorted(run_keys, hi, right=True), n_live)
    count = (end - start).clamp(min=0).to(torch.int32)
    idx = start[:, None] + torch.arange(max_results, device=run_keys.device)
    valid = idx < end[:, None]
    safe = idx.clamp(0, n - 1)
    keys = torch.where(valid, run_keys[safe], KEY_MAX32)
    vals = torch.where(valid, run_vals[safe], 0).to(torch.int32)
    return keys, vals, count


def _mul32(x, m: int):
    """``(x * m) mod 2**32`` for x in [0, 2**32) without int64 overflow.

    The product of two uint32 values can pass 2**63, so split the
    constant into 16-bit halves: x * m_lo < 2**48, and only the low 16
    bits of x * m_hi survive the shift by 16.
    """
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def bloom_hash_ref(keys, h: int, nbits: int):
    """``(h, N)`` int64 bit positions via 32-bit multiply-xorshift mixing."""
    out = []
    for r in range(h):
        x = _mul32(keys, BLOOM_MULTS[r])
        x = x ^ (x >> 15)
        x = _mul32(x, BLOOM_MIX1)
        x = x ^ (x >> 12)
        x = _mul32(x, BLOOM_MIX2)
        x = x ^ (x >> 15)
        out.append(x % nbits)
    return torch.stack(out)


def bloom_build_ref(keys, nbits: int, h: int = 3):
    """Bloom bit array(s) as ``(..., nbits // 32)`` words (uint32 in int64).

    Bit ``pos % 32`` of word ``pos // 32``.  The OR-scatter is a 0/1
    scatter-``amax`` into ``nbits`` cells (``max`` == OR on single bits;
    an ``index_put_`` of duplicate positions would race), then 32 cells
    per word are packed.  KEY_MAX padding sets no bits.  Takes one run
    ``(N,)`` or a batch of runs ``(R, N)``.
    """
    assert nbits % 32 == 0
    batch = keys.shape[:-1]
    keys2 = keys.reshape(-1, keys.shape[-1])
    pos = bloom_hash_ref(keys2, h, nbits)                 # (h, R, N)
    pos = pos.permute(1, 0, 2).reshape(keys2.shape[0], -1)
    valid = (keys2 != KEY_MAX32).to(torch.int64).repeat(1, h)
    cells = torch.zeros(keys2.shape[0], nbits, dtype=torch.int64,
                        device=keys.device)
    cells.scatter_reduce_(1, pos, valid, reduce="amax")
    shifts = torch.arange(32, dtype=torch.int64, device=keys.device)
    words = (cells.view(keys2.shape[0], -1, 32) << shifts).sum(-1)
    return words.reshape(*batch, nbits // 32)


def bloom_update_ref(words, keys, nbits: int, h: int = 3):
    """OR ``keys``' bits into an existing filter: O(batch), not O(run).

    ``update(build(S), B) == build(S ∪ B)`` exactly, so a run that only
    grows between rewrites keeps its filter bit-identical to a rebuild.
    """
    return words | bloom_build_ref(keys, nbits, h)


def bloom_probe_ref(words, queries, nbits: int, h: int = 3):
    """Membership probe → bool (Q,).  No false negatives by construction."""
    pos = bloom_hash_ref(queries, h, nbits)               # (h, Q)
    bit = (words[pos // 32] >> (pos % 32)) & 1
    return (bit == 1).all(dim=0)
