"""Paper-faithful host NB-tree (Secs. 3-5 of the paper); the port's copy of
``repro/core/refimpl.py``.

This is the *verbatim* pointer-based algorithm — ``HandleFullSNode``,
``SNodeSplit``, ``flush``, the advanced-version modifications (single
recursive call, lazy removal watermarks, deamortization) and per-d-tree
Bloom filters — executed against the explicit I/O cost model of
``cost_model.py``.  In the port it serves two roles:

1. the ``nbtree`` sim-clock engine tier (``engine_api.RefNBTreeEngine``),
   whose open-loop reports are a pure function of (trace, config);
2. the manifest of ``checkpoint.checkpointer`` (a zero-cost instance).

Deamortization (paper Sec. 5.1) is implemented at *page quantum*
granularity: a pending root-buffer cascade is described by a generator that
yields once per simulated page of I/O, and every subsequent insertion
advances it by a bounded number of quanta.  Structure mutations commit
atomically at child-merge boundaries, so queries interleaved with a pending
cascade always see a consistent tree.  This realizes the paper's
``O(log_f(n/sigma) * (f/B * T_seq + f/sigma * T_seek))`` worst-case
insertion bound: per insertion, O(height * f/B) pages plus O(height * f)
seeks amortized over sigma insertions.
"""
from __future__ import annotations

import numpy as np

from .bloom import BloomFilter
from .cost_model import PAIR_BYTES, CostModel, Device, HDD
from .sorted_run import (KEY_DTYPE, TOMBSTONE, VAL_DTYPE, Run, drop_tombstones,
                         merge_runs, partition_by_pivots)


class SNode:
    """An s-node: pivots (s-keys), children, and its d-tree (a sorted run)."""

    __slots__ = ("skeys", "children", "run", "bloom", "parent")

    def __init__(self, parent=None):
        self.skeys: list = []          # sorted pivot keys, len == len(children)-1
        self.children: list = []       # empty <=> leaf s-node
        self.run: Run = Run.empty()    # the node's d-tree as an on-disk run
        self.bloom: BloomFilter | None = None
        self.parent: SNode | None = parent

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def child_for(self, key) -> "SNode":
        """Descend per the cross-s-node linkage property (Sec. 3.1.1)."""
        i = int(np.searchsorted(np.asarray(self.skeys, dtype=KEY_DTYPE), key, side="right"))
        return self.children[i]


class NBTree:
    """The final (advanced, Sec. 5) NB-tree.

    Parameters mirror the paper: ``f`` s-tree fanout, ``sigma`` d-tree
    capacity in pairs, ``bits_per_key`` Bloom sizing.  ``deamortize=False``
    recovers the basic version of Secs. 3-4 (synchronous cascades, linear
    worst-case insertion).
    """

    def __init__(
        self,
        f: int = 3,
        sigma: int = 4096,
        *,
        device: Device = HDD,
        use_bloom: bool = True,
        bits_per_key: int = 10,
        num_hashes: int = 3,
        deamortize: bool = True,
        cost: CostModel | None = None,
    ):
        assert f >= 2 and sigma >= 2 * f, "paper requires f at most a fraction of sigma"
        self.f, self.sigma = f, sigma
        self.use_bloom = use_bloom
        self.bits_per_key, self.num_hashes = bits_per_key, num_hashes
        self.deamortize = deamortize
        self.cm = cost or CostModel(device)

        self.root = SNode()
        self._buf: dict = {}            # root d-tree, in memory (Sec. 4)
        self._frozen: Run | None = None  # buffer snapshot while a cascade is pending
        self._cascade = None             # page-quantum generator
        self.n_inserted = 0
        # Bloom effectiveness counters (paper Sec. 5.2): every d-tree probe,
        # the negatives that skipped a run search, and the positives that
        # searched and missed (false positives).  Query-savings attribution
        # for nbtree vs nbtree-nobloom runs.
        self.bloom_probes = 0
        self.bloom_negative_skips = 0
        self.bloom_false_positives = 0

    # ------------------------------------------------------------------ public
    def insert(self, key, value) -> float:
        """Insert one pair; returns the *foreground* latency of this insertion.

        Deamortized mode (the paper's final version): per insertion a bounded
        number of page quanta of the pending cascade are executed.  Their
        sequential-transfer share lands on the insertion's critical path (the
        1/sigma work fraction of Sec. 5.1); seeks are overlapped with the
        in-memory insert by asynchronous I/O, as in any deamortized engine,
        and are charged to total (throughput) time only.  A forced synchronous
        drain — the buffer refilling before the cascade finishes, or
        ``deamortize=False`` (the basic Sec. 3-4 version) — stalls the
        insertion for the full remaining cascade, seeks included; this is the
        long-delay event the paper eliminates and Fig. 7 measures.
        """
        fg = 0.0
        self._buf[np.uint64(key)] = np.int64(value)
        self.n_inserted += 1
        if self._cascade is not None:
            fg += self._advance_cascade()
            if len(self._buf) >= self.sigma and self._cascade is not None:
                with self.cm.measure() as t:  # backpressure stall: full drain
                    self._drain_cascade()
                fg += t.seconds
        if len(self._buf) >= self.sigma and self._cascade is None:
            self._freeze_and_start_cascade()
            if not self.deamortize:
                with self.cm.measure() as t:
                    self._drain_cascade()
                fg += t.seconds
        return fg

    def delete(self, key) -> float:
        """Delta-record deletion (Sec. 3.2.2)."""
        return self.insert(key, TOMBSTONE)

    def update(self, key, value) -> float:
        return self.insert(key, value)

    def get(self, key):
        """Point query; returns value or None.  Freshest copy wins."""
        key = np.uint64(key)
        with self.cm.measure() as t:
            val = self._get(key)
        self._last_query_time = t.seconds
        return val

    def query(self, key):
        """Like :meth:`get` but returns (value, simulated_seconds)."""
        v = self.get(key)
        return v, self._last_query_time

    def drain(self) -> None:
        """Finish all pending deamortized work (for tests/shutdown)."""
        self._drain_cascade()

    def range_query(self, lo, hi):
        """Inclusive range scan [lo, hi]; returns (keys, vals) numpy arrays.

        Visits every s-node whose key interval intersects the range
        (pre-order, so ancestors — fresher data — resolve duplicates first),
        scans each visited d-tree's matching span sequentially, then merges
        with freshest-copy-wins and drops tombstones.  Cost accounting per
        visited node with data: one seek + one leaf-locate page + the
        sequential transfer of the matching span (internal d-nodes are
        cached in memory, as for point queries).  Bloom filters are not
        consulted — they cannot answer range predicates.  ``lo > hi`` is an
        empty range.
        """
        lo, hi = np.uint64(lo), np.uint64(hi)
        with self.cm.measure() as t:
            out = self._range_query(lo, hi)
        self._last_query_time = t.seconds
        return out

    def _range_query(self, lo, hi):
        result: dict = {}

        def add(ks, vs):
            for k, v in zip(ks.tolist(), vs.tolist()):
                if k not in result:
                    result[k] = v

        if lo <= hi:
            # 1. live buffer, then frozen buffer (in memory, newest first).
            for k, v in self._buf.items():          # keys unique: no order dep
                if lo <= k <= hi:
                    result[int(k)] = int(v)
            if self._frozen is not None:
                add(*self._frozen.range(lo, hi))

            # 2. pre-order walk of the intersecting s-nodes.
            def rec(node):
                if node is not self.root and len(node.run) > 0:
                    rk, rv = node.run.range(lo, hi)
                    self.cm.page_read()          # locate the first leaf
                    self.cm.read_pairs(len(rk))  # sequential span scan
                    add(rk, rv)
                if node.is_leaf:
                    return
                bounds = [None, *node.skeys, None]
                for i, c in enumerate(node.children):
                    clo, chi = bounds[i], bounds[i + 1]
                    if (chi is None or lo < chi) and (clo is None or hi >= clo):
                        rec(c)

            rec(self.root)
        ks = sorted(k for k, v in result.items() if v != TOMBSTONE)
        return (np.asarray(ks, KEY_DTYPE),
                np.asarray([result[k] for k in ks], VAL_DTYPE))

    # ----------------------------------------------------------------- queries
    def _get(self, key):
        # 1. live buffer, then frozen buffer (both in memory, newest first).
        if key in self._buf:
            v = self._buf[key]
            return None if v == TOMBSTONE else v
        if self._frozen is not None:
            v = self._frozen.lookup(key)
            if v is not None:
                return None if v == TOMBSTONE else v
        # 2. descend the s-tree; search each visited node's d-tree,
        #    gated by its Bloom filter (Sec. 5.2).
        node = self.root
        while True:
            if node is not self.root and len(node.run) > 0:
                positive = True
                if self.use_bloom and node.bloom is not None:
                    self.bloom_probes += 1
                    positive = bool(node.bloom.contains(np.asarray([key]))[0])
                    if not positive:
                        self.bloom_negative_skips += 1
                if positive:
                    # B+-tree search of the run: internal d-nodes are cached
                    # in memory (paper Sec. 6.2 memory accounting), so one
                    # seek + one leaf page.
                    self.cm.page_read()
                    v = node.run.lookup(key)
                    if v is not None:
                        return None if v == TOMBSTONE else v
                    if self.use_bloom and node.bloom is not None:
                        self.bloom_false_positives += 1
            if node.is_leaf:
                return None
            node = node.child_for(key)

    # ------------------------------------------------------- cascade machinery
    def _freeze_and_start_cascade(self) -> None:
        keys = np.fromiter(self._buf.keys(), dtype=KEY_DTYPE, count=len(self._buf))
        vals = np.fromiter(self._buf.values(), dtype=VAL_DTYPE, count=len(self._buf))
        order = np.argsort(keys)
        self._frozen = Run(keys[order], vals[order])
        self._buf = {}
        self._cascade = self._handle_full_root()

    def _advance_cascade(self) -> float:
        """Bounded per-insert quanta (deamortization, Sec. 5.1).

        Returns the foreground share: the sequential-transfer time of the
        quanta executed (seeks overlap with the in-memory insert path).
        """
        if self._cascade is None:
            return 0.0
        # ~2 page quanta per insert (a full cascade is ~1.5*sigma quanta in
        # the worst case, so base pace 2 always finishes within one buffer
        # refill); accelerate defensively as the live buffer refills so a
        # forced synchronous drain can never trigger in steady state.
        frac = len(self._buf) / self.sigma
        quanta = 2 if frac < 0.75 else (8 if frac < 0.95 else 64)
        executed = 0
        try:
            for _ in range(quanta):
                next(self._cascade)
                executed += 1
        except StopIteration:
            self._cascade = None
            self._frozen = None
        return executed * self.cm.device.page_bytes / self.cm.device.write_bw

    def _drain_cascade(self) -> None:
        if self._cascade is not None:
            for _ in self._cascade:
                pass
            self._cascade = None
            self._frozen = None

    # Each ``yield`` below is one page quantum of simulated I/O.
    def _page_quanta(self, nbytes: int, write: bool):
        pages = max(1, -(-nbytes // self.cm.device.page_bytes))
        for _ in range(pages):
            if write:
                self.cm.seq_write(self.cm.device.page_bytes)
            else:
                self.cm.seq_read(self.cm.device.page_bytes)
            yield

    def _handle_full_root(self):
        """HandleFullSNode(root) with the root's d-tree = frozen buffer."""
        self.root.run = self._frozen  # conceptually the root's d-tree
        yield from self._handle_full(self.root)
        self.root.run = Run.empty()

    def _handle_full(self, node: SNode):
        """HandleFullSNode (Sec. 5.1, single-recursive-call version)."""
        while True:
            if node.is_leaf:
                yield from self._split_upward(node)
                return
            yield from self._flush(node)
            # single recursive call: the largest child, if oversized.
            sizes = [len(c.run) for c in node.children]
            biggest = int(np.argmax(sizes))
            if sizes[biggest] > self.sigma:
                node = node.children[biggest]
                continue
            return

    def _flush(self, node: SNode):
        """flush(N) (Secs. 4.1, 5.1): stream-merge N's live run into children.

        Moves down at most sigma pairs; the moved prefix is lazily removed
        by advancing N's watermark (no rewrite).  Cost: sequential read of
        the moved portion + per receiving child a seek, a sequential read of
        its live run, and a sequential write of the merged run.
        """
        live_k, live_v = node.run.live_keys, node.run.live_vals
        moved = min(len(live_k), self.sigma)
        mk, mv = live_k[:moved], live_v[:moved]
        if node is not self.root:
            self.cm.seek()
            yield from self._page_quanta(moved * PAIR_BYTES, write=False)
        parts = partition_by_pivots(mk, mv, node.skeys)
        for child, (pk, pv) in zip(node.children, parts):
            if len(pk) == 0:
                continue
            self.cm.seek()
            yield from self._page_quanta(len(child.run) * PAIR_BYTES, write=False)
            nk, nv = merge_runs(pk, pv, child.run.live_keys, child.run.live_vals)
            if child.is_leaf:  # delta records resolve at the last level (Sec. 3.2.2)
                nk, nv = drop_tombstones(nk, nv)
            self.cm.seek()
            yield from self._page_quanta(len(nk) * PAIR_BYTES, write=True)
            # commit the child atomically; fresh run => watermark 0 and the
            # child's previous dead prefix is discarded (lazy-removal payoff).
            child.run = Run(nk, nv)
            self._rebuild_bloom(child)
        # lazy removal on N: advance watermark only (Sec. 5.1).
        node.run = Run(node.run.keys, node.run.vals, node.run.wm + moved)
        self._snode_page_write(node)

    def _split_upward(self, node: SNode):
        """SNodeSplit at ``node`` then ancestor splits while fanout > f."""
        yield from self._snode_split(node)
        anc = node.parent
        while anc is not None and len(anc.children) > self.f:
            yield from self._snode_split(anc)
            anc = anc.parent

    def _snode_split(self, node: SNode):
        """SNodeSplit(N) (Sec. 3.2.1): median split of N and its d-tree."""
        live_k, live_v = node.run.live_keys, node.run.live_vals
        if node.is_leaf:
            k_m = live_k[len(live_k) // 2]  # median d-key
        else:
            k_m = np.asarray(node.skeys, KEY_DTYPE)[len(node.skeys) // 2]  # median s-key

        small, large = SNode(node.parent), SNode(node.parent)
        cut = int(np.searchsorted(live_k, k_m, side="left"))
        in_memory = node is self.root
        if not in_memory:
            self.cm.seek()
            yield from self._page_quanta(len(live_k) * PAIR_BYTES, write=False)
        self.cm.seek()
        yield from self._page_quanta(cut * PAIR_BYTES, write=True)
        self.cm.seek()
        yield from self._page_quanta((len(live_k) - cut) * PAIR_BYTES, write=True)
        small.run = Run(live_k[:cut].copy(), live_v[:cut].copy())
        large.run = Run(live_k[cut:].copy(), live_v[cut:].copy())
        self._rebuild_bloom(small)
        self._rebuild_bloom(large)

        if not node.is_leaf:
            i = node.skeys.index(k_m)
            small.skeys, large.skeys = node.skeys[:i], node.skeys[i + 1:]
            small.children, large.children = node.children[: i + 1], node.children[i + 1:]
            for c in small.children:
                c.parent = small
            for c in large.children:
                c.parent = large

        parent = node.parent
        if parent is None:  # root split: s-tree height grows by one.
            new_root = SNode()
            new_root.children = [small, large]
            new_root.skeys = [k_m]
            small.parent = large.parent = new_root
            self.root = new_root
        else:
            i = parent.children.index(node)
            parent.children[i: i + 1] = [small, large]
            parent.skeys.insert(i, k_m)
            self._snode_page_write(parent)
        self._snode_page_write(small)
        self._snode_page_write(large)

    # ------------------------------------------------------------------- misc
    def _rebuild_bloom(self, node: SNode) -> None:
        if self.use_bloom:
            node.bloom = BloomFilter.build(
                node.run.live_keys, self.bits_per_key, self.num_hashes
            )

    def _snode_page_write(self, node: SNode) -> None:
        """s-tree manipulations add at most one page write (Sec. 4.2)."""
        if node is not self.root:
            self.cm.seq_write(self.cm.device.page_bytes)

    # ------------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        """Structural + cross-s-node-linkage properties (Sec. 3.1.1).

        Call after :meth:`drain`.  Raises AssertionError on violation.
        """
        assert self._cascade is None, "drain() before checking invariants"
        depths = set()
        sigma, f = self.sigma, self.f

        def rec(node: SNode, lo, hi_excl, depth):
            """Keys of ``node``'s subtree must lie in [lo, hi_excl)."""
            ks = node.run.live_keys
            if len(ks):
                assert np.all(ks[:-1] < ks[1:]), "run not strictly sorted"
                assert (lo is None or ks[0] >= lo) and (
                    hi_excl is None or ks[-1] < hi_excl
                ), "cross-s-node linkage property violated"
            # total-sibling bound of Sec. 5.1 implies |d-tree| <= f*(sigma+1).
            assert len(node.run) <= f * (sigma + 1), "d-tree size bound violated"
            if node.is_leaf:
                depths.add(depth)
                return
            assert len(node.children) == len(node.skeys) + 1
            assert len(node.children) <= f, "fanout overflow"
            if node is not self.root:
                assert len(node.children) >= -(-f // 2), "fanout underflow"
            sk = np.asarray(node.skeys, KEY_DTYPE)
            assert np.all(sk[:-1] < sk[1:]), "s-keys not sorted"
            bounds = [lo, *node.skeys, hi_excl]
            for i, c in enumerate(node.children):
                assert c.parent is node
                rec(c, bounds[i], bounds[i + 1], depth + 1)

        rec(self.root, None, None, 0)
        assert len(depths) <= 1, "leaves not at uniform depth"

    @property
    def height(self) -> int:
        h, node = 0, self.root
        while not node.is_leaf:
            node = node.children[0]
            h += 1
        return h

    def total_pairs(self) -> int:
        """Live pairs across buffer + all d-trees (may count in-flight dups)."""
        total = len(self._buf) + (len(self._frozen) if self._frozen is not None else 0)
        stack = [self.root]
        while stack:
            n = stack.pop()
            total += len(n.run)
            stack.extend(n.children)
        return total
