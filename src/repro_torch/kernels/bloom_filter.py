"""Bloom filters: CUDA kernels (``csrc/bloom_filter.cu``) and plain versions.

The probe replaces the Pallas ``_probe_kernel``
(``repro/kernels/bloom_filter.py:32``) and the per-level probe that
``_query_batch_impl`` inlines (``repro/core/jax_nbtree.py:388-395``):

* ``bloom_probe(words, q, nbits=, h=)`` — one filter, int32 0/1 per query
  (the Pallas entry's contract);
* ``bloom_probe_rows(bloom_table, rows, q, nbits=, h=)`` — query t probes
  the filter of table row ``rows[t]``; a bool mask.

The build and the O(batch) update replace no TPU kernel: the JAX package
leaves them to XLA.  Their plain versions (``ref.py``) are a chain of ~90
small PyTorch passes, which the write path ran from the host on every
insert, flush and split; one launch takes their place on the card:

* ``bloom_build(keys, nbits, h)`` — ``(N,)`` or ``(R, N)`` keys -> the
  ``(nbits // 32,)`` or ``(R, nbits // 32)`` filter words;
* ``bloom_update(words, keys, nbits, h)`` — ``words`` ORed with the keys'
  bits, a new tensor of ``words``' shape.

What bounds the probe on the H100: latency.  A query moves ~40 bytes; what
it waits on is its dependent device-memory round trips.  The kernel is a
template on h (1-6), fully unrolled: a thread computes all h positions and
issues all h word loads before it tests a bit, so a query waits one round
trip for its row and key and one for its words.  Left for later: folding
the probe into a fused descent kernel, and uint32 word storage (half the
bytes).

What bounds the build: not its bytes.  At the flush shape (5 rows of
21,504 keys, nbits 217,088) it moves ~1.1 MB, a third of a microsecond at
3.35 TB/s, under the launch floor; it takes ~12 us on the card, one SM
hashing each row's live keys, against ~1 ms of host time the plain chain
took a call (PERF.md).  One CTA a row ORs the keys' bits into the row's
words in shared memory and writes them out once (a row too large for
shared memory is ORed in device memory instead, picked by nbits alone); OR
is order-free, so the words equal the plain version's bit for bit.  The
build and probe share one hash function on the card (``bloom_positions``).
"""
from __future__ import annotations

import torch

from . import _build
from .ref import (bloom_build_ref, bloom_hash_ref, bloom_probe_ref,
                  bloom_update_ref)

launches = {"bloom_probe": 0, "bloom_probe_rows": 0, "bloom_build": 0,
            "bloom_update": 0}


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


#: the build's and the update's plain versions, which CPU tensors take
bloom_build_plain = bloom_build_ref
bloom_update_plain = bloom_update_ref


def _build_rows(name: str, keys, old, nbits: int, h: int):
    """Launch the build over ``keys`` (rank 1 or 2), ORed onto ``old`` (the
    update's words, or None) into a new ``(..., nbits // 32)`` tensor; count
    the launch under ``name``."""
    # shape checks first, so that each refusal shows without a card
    for label, t in (("keys", keys), ("words", old)):
        if t is not None and t.dtype != torch.int64:
            raise TypeError(f"{name}: {label} must be int64, got {t.dtype}")
    if keys.dim() not in (1, 2):
        raise ValueError(f"{name}: expected (N,) or (R, N) keys, got "
                         f"{tuple(keys.shape)}")
    if nbits % 32:
        raise ValueError(f"{name}: nbits={nbits} is not a multiple of 32")
    _check_hash(nbits, h, nbits // 32)
    shape = (*keys.shape[:-1], nbits // 32)
    if old is not None and tuple(old.shape) != shape:
        raise ValueError(f"{name}: words {tuple(old.shape)} do not fit keys "
                         f"{tuple(keys.shape)} at nbits={nbits}")
    dev = keys.device
    _build.require("keys", keys, torch.int64, keys.dim())
    if old is not None:
        _build.require("words", old, torch.int64, keys.dim(), dev)
    out = torch.empty(shape, dtype=torch.int64, device=dev)
    R = keys.shape[0] if keys.dim() == 2 else 1
    if R:
        _build.launch("bloom_build_launch", dev, keys.data_ptr(),
                      None if old is None else old.data_ptr(), out.data_ptr(),
                      R, keys.shape[-1], nbits, h)
        launches[name] += 1
    return out


def bloom_build_cuda(keys, nbits: int, h: int = 3):
    """Kernel: one launch builds every row's filter."""
    return _build_rows("bloom_build", keys, None, nbits, h)


def bloom_update_cuda(words, keys, nbits: int, h: int = 3):
    """Kernel: ``words | bloom_build(keys)`` in one launch."""
    return _build_rows("bloom_update", keys, words, nbits, h)
