"""Inclusive range scan: CUDA kernel (``csrc/range_scan.cu``) and plain version.

Replaces the Pallas ``_range_scan_kernel`` (``repro/kernels/range_scan.py:44``)
and the multi-run search + gather that ``_range_query_batch_impl`` inlines
(``repro/core/jax_nbtree.py:435-457``):

* ``range_scan(run_keys, run_vals, lo, hi, max_results=)`` — one run, the
  Pallas entry's contract: the first ``max_results`` matches in key order
  (KEY_MAX / 0 padded) and the total match count;
* ``range_scan_rows(table_keys, table_vals, nodes, counts, lo, hi, cap)`` —
  candidate (b, m) scans the first ``counts[b, m]`` keys of table row
  ``nodes[b, m]`` for query b: keys/vals ``(B, M, cap)`` and the per-
  candidate match count ``(B, M)`` before the cap.

The freshness and tombstone pass that follows in the descent stays a
stable ``torch.sort``: JAX runs it in XLA.

What bounds it on the H100: memory traffic.  The gather writes 12 bytes per
output slot (the ycsb-e path's launch, B=1024, M=16, cap=256: 50 MB, ~15
us at 3.35 TB/s), and a k-ary search pays a 32-byte sector for every key
it probes.  The kernel gives each candidate a group of 8 lanes: its two
halves find both bounds at once by a 4-lane k-ary search (7 dependent
rounds over a 21,504-key row, 4 sectors each), then the group writes the
candidate's slots with 16-byte stores, KEY_MAX / 0 past the span without
a load.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import KEY_MAX32, range_scan_ref, search_steps

launches = {"range_scan": 0, "range_scan_rows": 0}


def range_scan_plain(run_keys, run_vals, lo, hi, *, max_results: int = 128):
    return range_scan_ref(run_keys, run_vals, lo, hi, max_results)


def range_scan_rows_plain(table_keys, table_vals, nodes, counts, lo, hi,
                          cap: int):
    """The descent's lockstep bounds and masked gather, written out."""
    row_len = table_keys.shape[1]
    nid = nodes.long()
    lo_b, hi_b = lo[:, None], hi[:, None]

    def bound(q, closed: bool):
        l = torch.zeros_like(nid)
        h = counts.long()
        for _ in range(search_steps(row_len)):
            mid = (l + h) >> 1
            key = table_keys[nid, mid.clamp(0, row_len - 1)]
            go = (l < h) & ((key <= q) if closed else (key < q))
            l = torch.where(go, mid + 1, l)
            h = torch.where(go, h, mid)
        return l

    start = bound(lo_b, False)
    end = bound(hi_b, True)
    n_match = (end - start).clamp(min=0).to(torch.int32)
    idx = start[..., None] + torch.arange(cap, device=table_keys.device)
    valid = idx < end[..., None]
    safe = idx.clamp(0, row_len - 1)
    keys = torch.where(valid, table_keys[nid[..., None], safe], KEY_MAX32)
    vals = torch.where(valid, table_vals[nid[..., None], safe], 0)
    return keys, vals.to(torch.int32), n_match


def range_scan_cuda(run_keys, run_vals, lo, hi, *, max_results: int = 128):
    dev = run_keys.device
    _build.require("run_keys", run_keys, torch.int64, 1)
    _build.require("run_vals", run_vals, torch.int32, 1, dev)
    _build.require("lo", lo, torch.int64, 1, dev)
    _build.require("hi", hi, torch.int64, 1, dev)
    if run_vals.shape != run_keys.shape or lo.shape != hi.shape:
        raise ValueError("range_scan: mismatched shapes")
    Q = lo.shape[0]
    keys = torch.empty((Q, max_results), dtype=torch.int64, device=dev)
    vals = torch.empty((Q, max_results), dtype=torch.int32, device=dev)
    count = torch.empty(Q, dtype=torch.int32, device=dev)
    if Q:
        _build.launch("range_scan_launch", dev, run_keys.data_ptr(),
                      run_vals.data_ptr(), run_keys.shape[0], lo.data_ptr(),
                      hi.data_ptr(), keys.data_ptr(), vals.data_ptr(),
                      count.data_ptr(), Q, max_results)
        launches["range_scan"] += 1
    return keys, vals, count


def range_scan_rows_cuda(table_keys, table_vals, nodes, counts, lo, hi,
                         cap: int):
    dev = table_keys.device
    _build.require("table_keys", table_keys, torch.int64, 2)
    _build.require("table_vals", table_vals, torch.int32, 2, dev)
    _build.require("nodes", nodes, torch.int32, 2, dev)
    _build.require("counts", counts, torch.int32, 2, dev)
    _build.require("lo", lo, torch.int64, 1, dev)
    _build.require("hi", hi, torch.int64, 1, dev)
    B, M = nodes.shape
    if table_vals.shape != table_keys.shape or counts.shape != nodes.shape \
            or lo.shape != (B,) or hi.shape != (B,):
        raise ValueError("range_scan_rows: mismatched shapes")
    keys = torch.empty((B, M, cap), dtype=torch.int64, device=dev)
    vals = torch.empty((B, M, cap), dtype=torch.int32, device=dev)
    n_match = torch.empty((B, M), dtype=torch.int32, device=dev)
    if B * M:
        _build.launch("range_scan_rows_launch", dev, table_keys.data_ptr(),
                      table_vals.data_ptr(), table_keys.shape[1],
                      nodes.data_ptr(), counts.data_ptr(), lo.data_ptr(),
                      hi.data_ptr(), keys.data_ptr(), vals.data_ptr(),
                      n_match.data_ptr(), B * M, M, cap)
        launches["range_scan_rows"] += 1
    return keys, vals, n_match
