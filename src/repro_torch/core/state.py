"""Carry device-tier index state across: the "weights" of this system.

The state of an index is its seven node tables plus the host control
plane (the s-tree, the id counter, the pending queue and the counters).
The exchange format is plain numpy and Python, so the JAX package's
``NBTreeIndex`` can be exported on its side without either package
importing the other:

* ``tables`` — ``run_keys`` (uint32), ``run_vals`` (int32), ``run_count``
  (int32), ``bloom`` (uint32), ``pivots`` (uint32), ``children`` (int32),
  ``nchild`` (int32), each ``(max_nodes, ...)``;
* ``tree`` — ``{"root": node, "next_id": int, "pending": [[nid, count],
  ...], "counters": {...}}`` with ``node = {"nid", "skeys", "count",
  "children": [node, ...]}``.  A pending entry may name a retired node
  (a stale entry the queue will skip); it is carried with its count.
"""
from __future__ import annotations

import numpy as np
import torch

from .torch_nbtree import NBTreeIndex, _HostNode

TABLES = ("run_keys", "run_vals", "run_count", "bloom", "pivots", "children",
          "nchild")
COUNTERS = ("n_items", "units_done", "bloom_probes", "bloom_negative_skips",
            "bloom_false_positives", "dispatch_count")
_UINT32_TABLES = ("run_keys", "bloom", "pivots")


def export_state(idx: NBTreeIndex) -> tuple[dict, dict]:
    """``(tables, tree)`` of a port index, in the exchange format."""
    tables = {}
    for name in TABLES:
        arr = getattr(idx, name).cpu().numpy()
        tables[name] = arr.astype(np.uint32 if name in _UINT32_TABLES
                                  else np.int32)

    def node(n):
        return {"nid": n.nid, "skeys": [int(k) for k in n.skeys],
                "count": int(n.count),
                "children": [node(c) for c in n.children]}

    tree = {"root": node(idx.root), "next_id": idx._next_id,
            "pending": [[n.nid, int(n.count)] for n in idx._pending],
            "counters": {c: int(getattr(idx, c)) for c in COUNTERS}}
    return tables, tree


def index_from_reference(tables: dict, tree: dict, **cfg) -> NBTreeIndex:
    """A port ``NBTreeIndex`` holding exported state.

    ``cfg`` is the index configuration (``f``, ``sigma``, ``bits_per_key``,
    ``num_hashes``, ``max_levels``, ``device``); ``max_nodes`` comes from
    the tables.  Raises if the tables do not fit that configuration.
    """
    max_nodes = int(tables["run_keys"].shape[0])
    idx = NBTreeIndex(max_nodes=max_nodes, **cfg)
    for name in TABLES:
        cur = getattr(idx, name)
        arr = np.asarray(tables[name])
        if arr.shape != tuple(cur.shape):
            raise ValueError(f"{name}: shape {arr.shape}, this configuration "
                             f"needs {tuple(cur.shape)}")
        cur.copy_(torch.from_numpy(arr.astype(np.int64)).to(cur.dtype))

    by_id: dict = {}

    def build(d, parent):
        n = _HostNode(int(d["nid"]), parent)
        n.skeys = [int(k) for k in d["skeys"]]
        n.count = int(d["count"])
        n.children = [build(c, n) for c in d["children"]]
        by_id[n.nid] = n
        return n

    idx.root = build(tree["root"], None)
    idx._next_id = int(tree["next_id"])
    for nid, count in tree["pending"]:
        node = by_id.get(int(nid))
        if node is None:                     # retired id, stale entry
            node = by_id[int(nid)] = _HostNode(int(nid))
            node.count = int(count)
        idx._enqueue(node)
    for c in COUNTERS:
        setattr(idx, c, int(tree["counters"][c]))
    return idx
