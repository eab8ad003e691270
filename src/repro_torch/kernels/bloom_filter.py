"""Bloom-filter probe: CUDA kernel (``csrc/bloom_filter.cu``) and plain version.

Replaces the Pallas ``_probe_kernel`` (``repro/kernels/bloom_filter.py:32``)
and the per-level probe that ``_query_batch_impl`` inlines
(``repro/core/jax_nbtree.py:388-395``):

* ``bloom_probe(words, q, nbits=, h=)`` — one filter, int32 0/1 per query
  (the Pallas entry's contract);
* ``bloom_probe_rows(bloom_table, rows, q, nbits=, h=)`` — query t probes
  the filter of table row ``rows[t]``; a bool mask.

Filter build and the O(batch) update stay plain PyTorch (``ref.py``): the
JAX package leaves them to XLA too.

What bounds it on the H100: latency.  A query moves ~40 bytes; what it
waits on is its dependent device-memory round trips.  The kernel is a
template on h (1-6), fully unrolled: a thread computes all h positions and
issues all h word loads before it tests a bit, so a query waits one round
trip for its row and key and one for its words.  Left for later: folding
the probe into a fused descent kernel, and uint32 word storage (half the
bytes).
"""
from __future__ import annotations

import torch

from . import _build
from .ref import bloom_hash_ref, bloom_probe_ref

launches = {"bloom_probe": 0, "bloom_probe_rows": 0}


def bloom_probe_plain(words, q, *, nbits: int, h: int = 3):
    return bloom_probe_ref(words, q, nbits, h).to(torch.int32)


def bloom_probe_rows_plain(bloom_table, rows, q, *, nbits: int, h: int = 3):
    """The descent's probe (``jax_nbtree.py:388-395``), written out."""
    pos = bloom_hash_ref(q, h, nbits)                       # (h, Q)
    w = bloom_table[rows.long()[None, :], pos // 32]
    return (((w >> (pos % 32)) & 1) == 1).all(dim=0)


def _check_hash(nbits: int, h: int, row_words: int) -> None:
    if not 1 <= h <= 6:
        raise ValueError(f"bloom: h={h} outside the 6 mixing constants")
    if not 0 < nbits <= 32 * row_words or nbits >= 2**31:
        raise ValueError(f"bloom: nbits={nbits} does not fit the filter")


def bloom_probe_cuda(words, q, *, nbits: int, h: int = 3):
    dev = words.device
    _build.require("words", words, torch.int64, 1)
    _build.require("queries", q, torch.int64, 1, dev)
    _check_hash(nbits, h, words.shape[0])
    Q = q.shape[0]
    out = torch.empty(Q, dtype=torch.int32, device=dev)
    if Q:
        _build.launch("bloom_probe_launch", dev, words.data_ptr(),
                      q.data_ptr(), out.data_ptr(), nbits, h, Q)
        launches["bloom_probe"] += 1
    return out


def bloom_probe_rows_cuda(bloom_table, rows, q, *, nbits: int, h: int = 3):
    dev = bloom_table.device
    _build.require("bloom_table", bloom_table, torch.int64, 2)
    _build.require("rows", rows, torch.int32, 1, dev)
    _build.require("queries", q, torch.int64, 1, dev)
    _check_hash(nbits, h, bloom_table.shape[1])
    Q = q.shape[0]
    if rows.shape[0] != Q:
        raise ValueError("bloom_probe_rows: rows and q lengths differ")
    out = torch.empty(Q, dtype=torch.bool, device=dev)
    if Q:
        _build.launch("bloom_probe_rows_launch", dev, bloom_table.data_ptr(),
                      bloom_table.shape[1], rows.data_ptr(), q.data_ptr(),
                      out.data_ptr(), nbits, h, Q)
        launches["bloom_probe_rows"] += 1
    return out
