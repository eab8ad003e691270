"""Leftmost-match search: CUDA kernel (``csrc/sorted_search.cu``) and plain version.

Replaces the Pallas ``_search_kernel`` (``repro/kernels/sorted_search.py:34``)
and the per-level run search that ``_query_batch_impl`` inlines
(``repro/core/jax_nbtree.py:399-409``):

* ``sorted_search(run_keys, run_vals, q)`` — Q queries in one run, the
  Pallas entry's contract (``found`` int32 0/1, value or -1, index);
* ``sorted_search_rows(table_keys, table_vals, rows, counts, q)`` — query t
  searches the first ``counts[t]`` keys of row ``rows[t]`` of a node table,
  so the descent runs one launch per level.  ``found`` is a bool mask.

What bounds it on the H100: latency, not bytes (4096 queries move well
under a MB).  A binary search is ~log2(n) dependent reads, each an L2 or
device-memory round trip, and the descent's launches carry few queries
(144-205 on the main path).  The kernel gives each query a group of lanes
that search k-ary: every lane loads its probe, the group votes on the
leftmost probe >= q, and the window shrinks by the group's width plus one
a round, so a 21,504-key row takes 3-5 dependent rounds, the last one a
coalesced read of the remaining keys and their values.  Left for later:
fusing probe, search and pivot routing of every level into one descent
kernel.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import search_steps, sorted_search_ref

launches = {"sorted_search": 0, "sorted_search_rows": 0}


def sorted_search_plain(run_keys, run_vals, q):
    found, vals, idx = sorted_search_ref(run_keys, run_vals, q)
    return found.to(torch.int32), vals, idx


def sorted_search_rows_plain(table_keys, table_vals, rows, counts, q):
    """The descent's lockstep search (``jax_nbtree.py:399-409``), written out."""
    row_len = table_keys.shape[1]
    rows = rows.long()
    lo = torch.zeros_like(rows)
    hi = counts.long()
    for _ in range(search_steps(row_len)):
        mid = (lo + hi) >> 1
        key = table_keys[rows, mid.clamp(0, row_len - 1)]
        right = (lo < hi) & (key < q)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(right, hi, mid)
    safe = lo.clamp(0, row_len - 1)
    found = (lo < counts) & (table_keys[rows, safe] == q)
    vals = torch.where(found, table_vals[rows, safe], -1).to(torch.int32)
    return found, vals, lo.to(torch.int32)


def sorted_search_cuda(run_keys, run_vals, q):
    dev = run_keys.device
    _build.require("run_keys", run_keys, torch.int64, 1)
    _build.require("run_vals", run_vals, torch.int32, 1, dev)
    _build.require("queries", q, torch.int64, 1, dev)
    if run_vals.shape != run_keys.shape:
        raise ValueError("sorted_search: keys and vals differ in shape")
    Q = q.shape[0]
    found, vals, idx = (torch.empty(Q, dtype=torch.int32, device=dev)
                        for _ in range(3))
    if Q:
        _build.launch("sorted_search_launch", dev, run_keys.data_ptr(),
                      run_vals.data_ptr(), q.data_ptr(), found.data_ptr(),
                      vals.data_ptr(), idx.data_ptr(), run_keys.shape[0], Q)
        launches["sorted_search"] += 1
    return found, vals, idx


def sorted_search_rows_cuda(table_keys, table_vals, rows, counts, q):
    dev = table_keys.device
    _build.require("table_keys", table_keys, torch.int64, 2)
    _build.require("table_vals", table_vals, torch.int32, 2, dev)
    _build.require("rows", rows, torch.int32, 1, dev)
    _build.require("counts", counts, torch.int32, 1, dev)
    _build.require("queries", q, torch.int64, 1, dev)
    if table_vals.shape != table_keys.shape:
        raise ValueError("sorted_search_rows: keys and vals differ in shape")
    Q = q.shape[0]
    if rows.shape[0] != Q or counts.shape[0] != Q:
        raise ValueError("sorted_search_rows: rows/counts/q lengths differ")
    found = torch.empty(Q, dtype=torch.bool, device=dev)
    vals = torch.empty(Q, dtype=torch.int32, device=dev)
    idx = torch.empty(Q, dtype=torch.int32, device=dev)
    if Q:
        _build.launch("sorted_search_rows_launch", dev, table_keys.data_ptr(),
                      table_vals.data_ptr(), table_keys.shape[1],
                      rows.data_ptr(), counts.data_ptr(), q.data_ptr(),
                      found.data_ptr(), vals.data_ptr(), idx.data_ptr(), Q)
        launches["sorted_search_rows"] += 1
    return found, vals, idx
