"""Merge of sorted runs: CUDA kernel (``csrc/merge_sorted.cu``) and plain version.

Replaces the Pallas ``_merge_kernel`` (``repro/kernels/merge_sorted.py:47``)
behind both of its entry points: ``merge_sorted`` (one pair, the root merge
of ``_insert_impl``) and ``merge_sorted_batch`` (R pairs in one launch, the
child fan-out of ``_flush_impl``).

What bounds it on the H100: bytes.  Each input element is read once and
each output written once, 12 bytes each (int64 key, int32 value): 2.46 MB
at the flush shape (R = 4 rows of 4096 + 21504), 0.73 us at 3.35 TB/s.

The design works per tile of ``T`` outputs instead of per element, so a
CTA waits on two dependent device-memory round trips rather than each
element on a ~15-step binary search: each CTA narrows its tile's two
merge-path splits by one warp-wide 32-ary search round, stages the spans
of ``a`` and ``b`` that cover them in shared memory with ``cp.async``,
finds each thread's split and merges 4 outputs a thread there, and writes
the tile back through shared memory with 16-byte stores.  ``T`` = 512 at
both entry points, from a sweep of 256 / 512 / 1024 on the card.
``nvcc -Xptxas -v``: 42 registers, 12,328 bytes of shared memory, no
spills (``chip_smoke.py`` prints it).

The JAX wrapper pads both runs to multiples of 1024 (KEY_MAX / 0), and the
pads decide where a row's stale KEY_MAX tail lands; both versions here
reproduce that (the kernel by reading past a row's end as padding).
"""
from __future__ import annotations

import torch

from . import _build
from .ref import KEY_MAX32, merge_sorted_ref

TILE = 1024

#: launches of the CUDA kernel per entry point (the plain version never
#: counts); reset and read through ``ops``.
launches = {"merge_sorted": 0, "merge_sorted_batch": 0}


def padded_len(n: int) -> int:
    """The JAX wrapper's run length: n rounded up to a TILE multiple, >= TILE."""
    return max(TILE, -(-n // TILE) * TILE)


def _pad(keys, vals, to: int):
    n = keys.shape[-1]
    if n == to:
        return keys, vals
    shape = (*keys.shape[:-1], to - n)
    return (torch.cat([keys, keys.new_full(shape, KEY_MAX32)], dim=-1),
            torch.cat([vals, vals.new_zeros(shape)], dim=-1))


def merge_sorted_plain(a_keys, a_vals, b_keys, b_vals):
    """Plain version of both entry points, on (n,) runs or (R, n) batches:
    pad as the JAX wrapper does, then a stable merge."""
    a_keys, a_vals = _pad(a_keys, a_vals, padded_len(a_keys.shape[-1]))
    b_keys, b_vals = _pad(b_keys, b_vals, padded_len(b_keys.shape[-1]))
    return merge_sorted_ref(a_keys, a_vals, b_keys, b_vals)


def _launch(a_keys, a_vals, b_keys, b_vals):
    dev = a_keys.device
    _build.require("a_keys", a_keys, torch.int64, 2)
    _build.require("a_vals", a_vals, torch.int32, 2, dev)
    _build.require("b_keys", b_keys, torch.int64, 2, dev)
    _build.require("b_vals", b_vals, torch.int32, 2, dev)
    R, a_raw = a_keys.shape
    b_raw = b_keys.shape[1]
    if a_vals.shape != a_keys.shape or b_vals.shape != b_keys.shape \
            or b_keys.shape[0] != R:
        raise ValueError("merge: a/b keys and vals must be (R, n) / (R, m)")
    n, m = padded_len(a_raw), padded_len(b_raw)
    out_k = torch.empty((R, n + m), dtype=torch.int64, device=dev)
    out_v = torch.empty((R, n + m), dtype=torch.int32, device=dev)
    if R:
        _build.launch("merge_sorted_launch", dev,
                      a_keys.data_ptr(), a_vals.data_ptr(),
                      b_keys.data_ptr(), b_vals.data_ptr(),
                      out_k.data_ptr(), out_v.data_ptr(), R, a_raw, n, b_raw, m)
    return out_k, out_v


def merge_sorted_cuda(a_keys, a_vals, b_keys, b_vals):
    """Kernel: (n,) + (m,) runs -> (n_pad + m_pad,) merged run."""
    k, v = _launch(a_keys[None], a_vals[None], b_keys[None], b_vals[None])
    launches["merge_sorted"] += 1
    return k[0], v[0]


def merge_sorted_batch_cuda(a_keys, a_vals, b_keys, b_vals):
    """Kernel: (R, n) + (R, m) runs -> (R, n_pad + m_pad); one launch."""
    out = _launch(a_keys, a_vals, b_keys, b_vals)
    if a_keys.shape[0]:
        launches["merge_sorted_batch"] += 1
    return out
