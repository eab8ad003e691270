"""B^epsilon-tree baseline (paper Sec. 1.2/7, "B-tree with Buffer" [10]);
the port's copy of ``repro/core/bepsilon.py``, a host sim-clock tier.

One node = one disk page; a fraction of the page holds a pivot array
(fanout ``f_be``) and the rest an insert buffer of ``buf_pairs`` pairs.
New pairs go to the root buffer (root and upper levels cached in memory);
a full buffer flushes to the child receiving the most pending pairs
(read-modify-write of one child page per flush step).

The paper's point — that the *small* per-node buffer forces frequent
scattered single-page flushes, i.e. a seek per few pairs moved, making
both average and worst-case insertion slow — emerges directly: each flush
moves O(buf_pairs / f_be) pairs for one seek + two page transfers, versus
NB-tree's sigma/f pairs per seek.  (The paper frames B^eps-trees as the
special case of NB-trees with s-node size = one disk page.)
"""
from __future__ import annotations

import numpy as np

from .cost_model import PAIR_BYTES, CostModel, Device, HDD
from .sorted_run import KEY_DTYPE, TOMBSTONE, VAL_DTYPE, merge_runs


class _Node:
    __slots__ = ("pivots", "children", "buf", "leaf_keys", "leaf_vals", "parent")

    def __init__(self, leaf: bool, parent=None):
        self.pivots: list = []
        self.children: list = []
        self.buf: dict = {}
        self.parent = parent
        self.leaf_keys = np.empty(0, KEY_DTYPE) if leaf else None
        self.leaf_vals = np.empty(0, VAL_DTYPE) if leaf else None

    @property
    def is_leaf(self):
        return self.leaf_keys is not None


class BEpsilonTree:
    def __init__(
        self,
        *,
        fanout: int = 16,
        node_bytes: int = 4 << 20,  # TokuDB-style 4 MB nodes
        cached_levels: int = 2,     # root region pinned in memory
        device: Device = HDD,
        cost: CostModel | None = None,
    ):
        self.f = fanout
        self.node_bytes = node_bytes
        # half the node holds the buffer, leaves are full nodes of pairs.
        self.buf_pairs = max(4, (node_bytes // 2) // PAIR_BYTES)
        self.leaf_pairs = max(8, node_bytes // PAIR_BYTES)
        self.cached_levels = cached_levels
        self.cm = cost or CostModel(device)
        self.root = _Node(leaf=True)
        self.n_inserted = 0

    # ---------------------------------------------------------------- inserts
    def insert(self, key, value) -> float:
        with self.cm.measure() as t:
            self._insert(self.root, np.uint64(key), np.int64(value), depth=0)
            self.n_inserted += 1
        return t.seconds

    def delete(self, key) -> float:
        return self.insert(key, TOMBSTONE)

    def _touch(self, depth: int, write: bool) -> None:
        """Node I/O (read-modify-write) unless this level is pinned in memory.

        B^eps nodes are scattered on disk, so every touch pays a seek — the
        contrast with NB-tree's sequential d-tree streams (paper Sec. 7).
        """
        if depth >= self.cached_levels:
            self.cm.seek()
            self.cm.seq_read(self.node_bytes)
            if write:
                self.cm.seek()
                self.cm.seq_write(self.node_bytes)

    def _insert(self, node: _Node, key, val, depth: int) -> None:
        if node.is_leaf:
            self._leaf_put(node, np.asarray([key], KEY_DTYPE), np.asarray([val], VAL_DTYPE), depth)
            return
        node.buf[key] = val
        if len(node.buf) > self.buf_pairs:
            self._flush(node, depth)

    def _flush(self, node: _Node, depth: int) -> None:
        """Flush the node buffer to the single fullest child (classic B^eps)."""
        self._touch(depth, write=True)  # rewrite this node's page (buffer drained)
        keys = np.fromiter(node.buf.keys(), KEY_DTYPE, len(node.buf))
        vals = np.fromiter(node.buf.values(), VAL_DTYPE, len(node.buf))
        order = np.argsort(keys)
        keys, vals = keys[order], vals[order]
        piv = np.asarray(node.pivots, KEY_DTYPE)
        cidx = np.searchsorted(piv, keys, side="right")
        counts = np.bincount(cidx, minlength=len(node.children))
        target = int(np.argmax(counts))
        sel = cidx == target
        tk, tv = keys[sel], vals[sel]
        node.buf = {k: v for k, v, s in zip(keys, vals, ~sel) if s}
        child = node.children[target]
        if child.is_leaf:
            self._leaf_put(child, tk, tv, depth + 1)
        else:
            self._touch(depth + 1, write=True)
            for k, v in zip(tk, tv):
                child.buf[k] = v
            if len(child.buf) > self.buf_pairs:
                self._flush(child, depth + 1)
        # child-count growth (and any further splits) is handled by _replace.

    def _leaf_put(self, leaf: _Node, keys, vals, depth: int) -> None:
        self._touch(depth, write=True)
        leaf.leaf_keys, leaf.leaf_vals = merge_runs(keys, vals, leaf.leaf_keys, leaf.leaf_vals)
        self._maybe_split(leaf, depth)

    def _maybe_split(self, node: _Node, depth: int) -> None:
        if node.is_leaf:
            if len(node.leaf_keys) <= self.leaf_pairs:
                return
            mid = len(node.leaf_keys) // 2
            k_m = node.leaf_keys[mid]
            left, right = _Node(True), _Node(True)
            left.leaf_keys, left.leaf_vals = node.leaf_keys[:mid], node.leaf_vals[:mid]
            right.leaf_keys, right.leaf_vals = node.leaf_keys[mid:], node.leaf_vals[mid:]
        else:
            if len(node.children) <= self.f:
                return
            mid = len(node.pivots) // 2
            k_m = node.pivots[mid]
            left, right = _Node(False), _Node(False)
            left.pivots, right.pivots = node.pivots[:mid], node.pivots[mid + 1:]
            left.children, right.children = node.children[: mid + 1], node.children[mid + 1:]
            for c in left.children:
                c.parent = left
            for c in right.children:
                c.parent = right
            for k, v in node.buf.items():
                (left if k < k_m else right).buf[k] = v
        self.cm.seek()
        self.cm.seq_write(2 * self.node_bytes)
        self._replace(node, k_m, left, right, depth)

    def _replace(self, node: _Node, k_m, left, right, depth: int) -> None:
        if node is self.root:
            new_root = _Node(False)
            new_root.pivots = [k_m]
            new_root.children = [left, right]
            left.parent = right.parent = new_root
            self.root = new_root
            return
        parent = node.parent
        left.parent = right.parent = parent
        i = parent.children.index(node)
        parent.children[i: i + 1] = [left, right]
        parent.pivots.insert(i, k_m)
        if len(parent.children) > self.f:
            self._maybe_split(parent, depth - 1)

    # ---------------------------------------------------------------- queries
    def get(self, key):
        key = np.uint64(key)
        with self.cm.measure() as t:
            v = self._get(key)
        self._last_query_time = t.seconds
        return v

    def query(self, key):
        v = self.get(key)
        return v, self._last_query_time

    def _get(self, key):
        node, depth = self.root, 0
        while True:
            if depth >= self.cached_levels:
                self.cm.page_read()  # queries touch one basement page, not the node
            if node.is_leaf:
                i = int(np.searchsorted(node.leaf_keys, key))
                if i < len(node.leaf_keys) and node.leaf_keys[i] == key:
                    v = node.leaf_vals[i]
                    return None if v == TOMBSTONE else v
                return None
            if key in node.buf:
                v = node.buf[key]
                return None if v == TOMBSTONE else v
            i = int(np.searchsorted(np.asarray(node.pivots, KEY_DTYPE), key, side="right"))
            node = node.children[i]
            depth += 1

    def range_query(self, lo, hi):
        """Inclusive range scan [lo, hi]; returns (keys, vals) numpy arrays.

        Pre-order walk of every node whose key interval intersects the
        range, node buffer before children: buffered entries are *newer*
        than any copy of the same key below them (entries only ever flush
        downward), so first-occurrence-wins resolves freshness, and the
        cross-node pivot invariant guarantees a key appears along only one
        root-to-leaf path.  Tombstone delta records are dropped at the end.

        Cost accounting mirrors :meth:`_get`: each visited node at an
        uncached level pays one random page read (seek + page — the node's
        pivots and buffer arrive with its page); visited leaves additionally
        stream their matching span sequentially.  Many scattered node pages
        per range is exactly the B^eps read amplification the paper
        contrasts with NB-tree's few sequential d-tree spans.  ``lo > hi``
        is an empty range.
        """
        lo, hi = np.uint64(lo), np.uint64(hi)
        with self.cm.measure() as t:
            result: dict = {}

            def rec(node: _Node, depth: int) -> None:
                if depth >= self.cached_levels:
                    self.cm.page_read()
                if node.is_leaf:
                    i0 = int(np.searchsorted(node.leaf_keys, lo, side="left"))
                    i1 = int(np.searchsorted(node.leaf_keys, hi, side="right"))
                    if i1 > i0:
                        if depth >= self.cached_levels:
                            self.cm.read_pairs(i1 - i0)
                        for k, v in zip(node.leaf_keys[i0:i1].tolist(),
                                        node.leaf_vals[i0:i1].tolist()):
                            if k not in result:
                                result[k] = v
                    return
                for k, v in node.buf.items():       # keys unique within a buf
                    if lo <= k <= hi and int(k) not in result:
                        result[int(k)] = int(v)
                bounds = [None, *node.pivots, None]
                for i, c in enumerate(node.children):
                    clo, chi = bounds[i], bounds[i + 1]
                    if (chi is None or lo < chi) and (clo is None or hi >= clo):
                        rec(c, depth + 1)

            if lo <= hi:
                rec(self.root, 0)
            ks = sorted(k for k, v in result.items() if v != TOMBSTONE)
            out = (np.asarray(ks, KEY_DTYPE),
                   np.asarray([result[k] for k in ks], VAL_DTYPE))
        self._last_query_time = t.seconds
        return out

    def drain(self) -> None:
        pass

    def total_pairs(self) -> int:
        total, stack = 0, [self.root]
        while stack:
            n = stack.pop()
            total += len(n.buf) if not n.is_leaf else len(n.leaf_keys)
            stack.extend(n.children)
        return total
