"""Device-tier NB-tree on PyTorch: the port of ``repro/core/jax_nbtree.py``.

The same split as the JAX index: a *host control plane* runs the paper's
s-tree algorithm (flush, SNodeSplit, the single recursive call, a bounded
maintenance quota), copied as it is, while the *device data plane* keeps
every key/value run, pivot table and Bloom bit-array as flat padded tables
on the card and runs the hot operations through the hand-written CUDA
kernels of ``repro_torch.kernels``:

* ``insert_batch`` -> ``_insert_impl``: batch sort, root merge
  (``merge_sorted``), count bump and incremental Bloom OR;
* ``maintain`` -> ``_flush_impl``: duplicate-safe cut, pivot partition, one
  ``merge_sorted_batch`` launch into all <= f children, leaf tombstone
  compaction, Bloom rebuilds; ``_split_impl`` / ``_clear_impl`` /
  ``_sync_impl`` / ``_grow_impl`` do the rest of the upkeep;
* ``query_batch`` -> ``_query_batch_impl``: per level one ``bloom_probe_rows``
  and one ``sorted_search_rows`` launch, pivot routing in torch;
* ``range_query_batch`` -> ``_range_query_batch_impl``: one
  ``range_scan_rows`` launch over every routed candidate run, then two
  stable sorts that resolve freshness and drop tombstones.

Each impl is one call through the ``_dispatch`` funnel, so one flush unit
is still one impl call (``dispatch_count``).  Where JAX donated the node
tables to a jitted impl, the impls here write into the preallocated tables
in place; only ``_grow_impl`` allocates new ones.

``fused=False`` keeps the JAX index's pre-fusion eager write path as the
differential-test oracle and the ingest benchmark's baseline: the same
host control plane and tables, but every step its own dispatch (row
writes, count sets, full Bloom rebuilds, one ``merge_sorted`` launch per
non-empty child) with host-synced ``searchsorted`` cuts between them, so
``dispatch_count`` per insert batch and per maintain unit equals the JAX
eager index's.  Both paths leave bit-identical tables.

Keys, pivots and Bloom words are int64 tensors holding uint32 values
(``kernels/ref.py``); values are int32 and ``TOMBSTONE32`` realizes
delta-record deletions (paper Sec. 3.2.2).  All seven tables stay bit-
identical to the JAX index's on the same op stream (``tests/
test_torch_nbtree.py``).
"""
from __future__ import annotations

import time
from collections import Counter, deque

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..kernels.ref import KEY_MAX32

TOMBSTONE32 = -(2**31)
TILE = 1024


def _device_call(fn, *args, **kwargs):
    """Single funnel for every device computation the index launches (one
    call == one impl); module-level so tests can intercept it."""
    return fn(*args, **kwargs)


def _tree_nbytes(x) -> int:
    """Total tensor bytes in a (possibly nested) dispatch input/output."""
    if isinstance(x, (tuple, list)):
        return sum(_tree_nbytes(e) for e in x)
    return int(getattr(x, "nbytes", 0))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class _HostNode:
    """Control-plane view of an s-node (structure only, no key data)."""

    __slots__ = ("nid", "skeys", "children", "count", "parent")

    def __init__(self, nid: int, parent=None):
        self.nid = nid
        self.skeys: list[int] = []
        self.children: list[_HostNode] = []
        self.count = 0           # live pairs in the device run row
        self.parent: _HostNode | None = parent

    @property
    def is_leaf(self):
        return not self.children


# ------------------------------------------------------------------ helpers
def _write_row(table, row: int, data) -> None:
    """``table[row] = data`` in place: one dispatch of the eager path (JAX
    donates the table to a jitted ``.at[row].set``; its eager count and
    structure sets, un-jitted ``.at[row].set`` calls, go through here too)."""
    table[row] = data


def _prepare_batch(keys, vals):
    """Sort an incoming batch newest-copy-first: reverse, then a stable sort
    (a stable sort keeps earlier, older duplicates first)."""
    keys, order = torch.sort(keys.flip(0), stable=True)
    return keys, vals.flip(0)[order]


def _window(row_k, row_v, start, length, cap: int):
    """``(..., cap)`` slices ``[start, start + length)`` of one row, KEY_MAX/0
    padded; ``start``/``length`` are tensors of matching shape."""
    ar = torch.arange(cap, device=row_k.device)
    idx = (start[..., None] + ar).clamp(0, row_k.shape[0] - 1)
    mask = ar < length[..., None]
    return (torch.where(mask, row_k[idx], KEY_MAX32),
            torch.where(mask, row_v[idx], 0))


def _build_bloom(keys, nbits: int, h: int):
    """A run's filter from scratch (the eager path rebuilds on each write)."""
    return ops.bloom_build(keys, nbits, h)


def _compact_rows(keys, vals, cap: int):
    """Leaf-level delta resolution (Sec. 3.2.2), per row: dedup, then drop
    deletes.  Stale duplicates retire together with the tombstone (dropping
    only the tombstone would resurrect the copy it deleted).  Dead keys
    become KEY_MAX and a stable sort moves them, values and all, to the
    tail — so stale values stay behind the KEY_MAX keys, as in JAX."""
    first = torch.ones_like(keys, dtype=torch.bool)
    first[..., 1:] = keys[..., 1:] != keys[..., :-1]      # leftmost = freshest
    dead = ~first | (vals == TOMBSTONE32)
    keys, order = torch.sort(torch.where(dead, KEY_MAX32, keys), dim=-1,
                             stable=True)
    vals = torch.gather(vals, -1, order)
    live = (keys != KEY_MAX32).sum(-1)
    return keys[..., :cap], vals[..., :cap], live


#: the eager path's leaf compaction of one merged row (JAX jits the same
#: function under this name)
_compact_tombstones = _compact_rows


# -------------------------------------------------------------------- impls
def _insert_impl(run_keys, run_vals, run_count, bloom, keys, vals, *,
                 run_cap: int, nbits: int, h: int):
    """One-call root ingest: sort batch, merge, incremental Bloom OR.

    In place on the four tables (JAX donates them to its jitted impl)."""
    bk, bv = _prepare_batch(keys, vals)
    mk, mv = ops.merge_sorted(bk, bv, run_keys[0], run_vals[0])
    run_keys[0] = mk[:run_cap]
    run_vals[0] = mv[:run_cap]
    run_count[0] += keys.shape[0]
    bloom[0] = ops.bloom_update(bloom[0], bk, nbits, h)


def _flush_partition(row_k, piv, count: int, *, sigma: int, run_cap: int):
    """A flush's duplicate-safe cut and pivot partition of one node's run:
    ``(moved, starts, lens)``, the pairs moved down and each child's span
    of them."""
    # never split a duplicate group across the moved boundary (the fresh
    # copy flushed down with the stale one left behind would invert the
    # ancestors-are-fresher rule); if the whole prefix is one key, move the
    # entire group.
    moved0 = min(count, sigma)
    k_cut = row_k[min(max(moved0, 0), run_cap - 1)].reshape(1)
    if moved0 < count:
        left = torch.searchsorted(row_k, k_cut)
        right = torch.searchsorted(row_k, k_cut, right=True)
        moved = torch.where(left > 0, left.clamp(max=moved0),
                            right.clamp(max=count))
    else:
        moved = torch.full((1,), moved0, dtype=torch.int64,
                           device=row_k.device)
    cuts = torch.minimum(torch.searchsorted(row_k, piv), moved)
    bounds = torch.cat([moved.new_zeros(1), cuts, moved])
    return moved, bounds[:-1], bounds[1:] - bounds[:-1]


def _flush_lens(run_keys, nid: int, piv, count: int, *, sigma: int,
                run_cap: int):
    """Each child's share of a flush of ``nid`` (the overflow guard's read)."""
    return _flush_partition(run_keys[nid], piv, count, sigma=sigma,
                            run_cap=run_cap)[2]


def _flush_impl(run_keys, run_vals, run_count, bloom, nid: int, child_ids,
                piv, count: int, *, nc: int, leaf: bool, sigma: int,
                sigma_pad: int, run_cap: int, nbits: int, h: int):
    """One-call emptying-cascade step for one internal node.

    In place on the four tables (JAX donates them).  Duplicate-safe cut and
    pivot partition stay on the device, one ``merge_sorted_batch`` launch
    merges into all ``nc`` children, leaf rows are compacted, every touched
    row's filter is rebuilt; untouched children (empty partition) keep rows,
    counts and filters bit for bit.  Returns the ``(nc+1,)`` count vector
    (children, then parent): the flush's one device-to-host read.
    """
    row_k, row_v = run_keys[nid], run_vals[nid]
    # ---- duplicate-safe cut and pivot partition of the moved prefix
    moved, starts, lens = _flush_partition(row_k, piv, count, sigma=sigma,
                                           run_cap=run_cap)
    pk, pv = _window(row_k, row_v, starts, lens, sigma_pad)    # (nc, sigma_pad)

    # ---- one batched merge across all children
    ck, cv = run_keys[child_ids], run_vals[child_ids]
    old_counts = run_count[child_ids]
    mk, mv = ops.merge_sorted_batch(pk, pv, ck, cv)
    if leaf:
        mk, mv, new_counts = _compact_rows(mk, mv, run_cap)
    else:
        mk, mv = mk[:, :run_cap], mv[:, :run_cap]
        new_counts = old_counts + lens
    touched = lens > 0
    mk = torch.where(touched[:, None], mk, ck)
    mv = torch.where(touched[:, None], mv, cv)
    new_counts = torch.where(touched, new_counts, old_counts)

    # ---- parent remainder (immediate compaction, DESIGN.md §2)
    rest = count - moved
    rk, rv = _window(row_k, row_v, moved, rest, run_cap)         # (1, run_cap)
    blooms = ops.bloom_build(torch.cat([mk, rk]), nbits, h)      # (nc+1, nw)
    new_blooms = torch.where(touched[:, None], blooms[:nc], bloom[child_ids])

    run_keys[child_ids] = mk
    run_vals[child_ids] = mv
    run_count[child_ids] = new_counts.to(torch.int32)
    bloom[child_ids] = new_blooms
    run_keys[nid] = rk[0]
    run_vals[nid] = rv[0]
    run_count[nid] = rest[0].to(torch.int32)
    bloom[nid] = blooms[nc]
    return torch.cat([new_counts, rest])


def _split_impl(run_keys, run_vals, run_count, bloom, nid: int, left_id: int,
                right_id: int, count: int, at_key: int, *, has_key: bool,
                run_cap: int, nbits: int, h: int):
    """One-call run split: windows, counts and filters for both halves.

    In place on the four tables.  Returns ``[k_m, cut]``: the split key for
    the host pivot structure and the left-half length."""
    dev = run_keys.device
    row_k, row_v = run_keys[nid], run_vals[nid]
    if has_key:
        k_m = torch.full((1,), at_key, dtype=torch.int64, device=dev)
        cut = torch.searchsorted(row_k, k_m).clamp(max=count)
    else:
        k_m = row_k[min(max(count // 2, 0), run_cap - 1)].reshape(1)
        cut = torch.searchsorted(row_k, k_m)
    halves_k, halves_v = _window(row_k, row_v, torch.cat([cut.new_zeros(1), cut]),
                                 torch.cat([cut, count - cut]), run_cap)
    ids = torch.tensor([left_id, right_id], device=dev)
    run_keys[ids] = halves_k
    run_vals[ids] = halves_v
    run_count[ids] = torch.cat([cut, count - cut]).to(torch.int32)
    bloom[ids] = ops.bloom_build(halves_k, nbits, h)
    return torch.cat([k_m, cut])


def _clear_impl(run_keys, run_vals, run_count, bloom, nid: int):
    """One-call row retire: keys, values, count and filter of one node."""
    run_keys[nid] = KEY_MAX32
    run_vals[nid] = 0
    run_count[nid] = 0
    bloom[nid] = 0


def _sync_impl(pivots, children, nchild, nid: int, pv, ch, n: int):
    """One-call structure mirror: pivots, child ids, fanout of one node."""
    pivots[nid] = pv
    children[nid] = ch
    nchild[nid] = n


def _grow_impl(pivots, children, nchild, run_keys, run_vals, run_count, bloom):
    """Capacity doubling of all seven node tables (new tensors; the old ones
    are freed as the caller drops them)."""
    def pad(t, fill):
        return torch.cat([t, torch.full_like(t, fill)])

    return (pad(pivots, KEY_MAX32), pad(children, 0), pad(nchild, 0),
            pad(run_keys, KEY_MAX32), pad(run_vals, 0), pad(run_count, 0),
            pad(bloom, 0))


def _query_batch_impl(pivots, nchild, children, run_keys, run_vals, run_count,
                      bloom, q, *, f: int, levels: int, nbits: int, h: int):
    """Point-lookup descent: at each level one Bloom probe launch and one
    run search launch over every query's current node; first (= freshest)
    hit wins.  Returns ``(present, vals, tallies)`` with the Bloom
    effectiveness tallies (probes, negative skips, false positives)
    reduced on the device."""
    B = q.shape[0]
    dev = q.device
    node = torch.zeros(B, dtype=torch.int32, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    out = torch.full((B,), -1, dtype=torch.int32, device=dev)
    tallies = torch.zeros(3, dtype=torch.int64, device=dev)
    # the descent parks on its leaf once there; `prev` masks the repeats out
    # of the tallies (one logical probe per node on each root-to-leaf path).
    prev = torch.full((B,), -1, dtype=torch.int32, device=dev)
    for _ in range(levels + 1):
        cnt = run_count[node]
        positive = ops.bloom_probe_rows(bloom, node, q, nbits=nbits, h=h)
        probe = ~found & (cnt > 0) & (node != prev)      # filter consulted
        do = positive & probe
        hit_l, val_l, _ = ops.sorted_search_rows(run_keys, run_vals, node, cnt, q)
        hit = do & hit_l
        out = torch.where(hit & ~found, val_l, out)
        found = found | hit
        tallies += torch.stack([probe.sum(), (probe & ~positive).sum(),
                                (do & ~hit).sum()])
        # ---- descend via pivots (cross-s-node linkage)
        ci = (q[:, None] >= pivots[node]).sum(dim=1).clamp(0, f - 1)
        child = children[node, ci]
        prev = node
        node = torch.where(nchild[node] > 0, child, node)
    present = found & (out != TOMBSTONE32)
    return present, out, tallies


def _range_query_batch_impl(run_keys, run_vals, run_count, nodes, lo, hi, *,
                            cap: int, max_results: int):
    """Range descent over routed candidates ``nodes`` (B, M), -1 = padding.

    One ``range_scan_rows`` launch bounds and gathers every candidate run;
    candidates are level-major with ancestors first and in-run order within
    a run (newer duplicates first), so a *stable* sort by key puts the
    freshest copy of each key first — the range form of first-hit-wins.
    """
    B, M = nodes.shape
    valid_node = nodes >= 0
    nid = nodes.clamp(min=0)
    cnt = torch.where(valid_node, run_count[nid], 0).to(torch.int32)
    ck, cv, n_match = ops.range_scan_rows(run_keys, run_vals, nid, cnt, lo,
                                          hi, cap)
    sk, order = torch.sort(ck.reshape(B, M * cap), dim=1, stable=True)
    sv = torch.gather(cv.reshape(B, M * cap), 1, order)
    fresh = torch.ones_like(sk, dtype=torch.bool)
    fresh[:, 1:] = sk[:, 1:] != sk[:, :-1]
    live = fresh & (sk != KEY_MAX32) & (sv != TOMBSTONE32)
    sk, order2 = torch.sort(torch.where(live, sk, KEY_MAX32), dim=1,
                            stable=True)
    sv = torch.gather(torch.where(live, sv, 0), 1, order2)
    total = live.sum(dim=1)
    truncated = (total > max_results) | (n_match > cap).any(dim=1)
    return (sk[:, :max_results], sv[:, :max_results],
            total.clamp(max=max_results).to(torch.int32), truncated)


class NBTreeIndex:
    """Composable device-backed NB-tree index (see module docstring).

    ``device`` defaults to ``cuda`` and raises without it; ``device="cpu"``
    runs every kernel's plain PyTorch version (the tests' setting).
    ``fused=True`` (the default) runs the one-call maintenance impls;
    ``fused=False`` the JAX index's pre-fusion eager write path: the same
    state, ~25x the dispatches per flush.
    """

    def __init__(self, f: int = 4, sigma: int = 4096, *, bits_per_key: int = 10,
                 num_hashes: int = 3, max_nodes: int = 256, max_levels: int = 12,
                 fused: bool = True, device=None):
        assert f >= 2 and sigma >= 2 * f
        self.device = resolve_device(device)
        self.f, self.sigma = f, sigma
        self.h = num_hashes
        self.sigma_pad = _round_up(sigma, TILE)
        self.run_cap = _round_up(f * (sigma + 1) + sigma, TILE)
        self.nbits = _round_up(self.run_cap * bits_per_key, 32 * 128)
        self.max_levels = max_levels
        self._fused = bool(fused)

        self.max_nodes = max_nodes
        nw = self.nbits // 32
        dev = self.device
        i32, i64 = torch.int32, torch.int64
        self.pivots = torch.full((max_nodes, f - 1), KEY_MAX32, dtype=i64,
                                 device=dev)
        self.children = torch.zeros((max_nodes, f), dtype=i32, device=dev)
        self.nchild = torch.zeros((max_nodes,), dtype=i32, device=dev)
        self.run_keys = torch.full((max_nodes, self.run_cap), KEY_MAX32,
                                   dtype=i64, device=dev)
        self.run_vals = torch.zeros((max_nodes, self.run_cap), dtype=i32,
                                    device=dev)
        self.run_count = torch.zeros((max_nodes,), dtype=i32, device=dev)
        self.bloom = torch.zeros((max_nodes, nw), dtype=i64, device=dev)

        self.root = _HostNode(0)
        self._next_id = 1
        # oversized nodes awaiting work: deque + membership counter keep the
        # dequeue and the "already queued?" check O(1).
        self._pending: deque[_HostNode] = deque()
        self._pending_n: Counter = Counter()
        self.n_items = 0
        self.units_done = 0   # cumulative flush/split work units executed
        # Bloom effectiveness (paper Sec. 5.2); see query_batch.
        self.bloom_probes = 0
        self.bloom_negative_skips = 0
        self.bloom_false_positives = 0
        #: impl calls issued by THIS index (``EngineStats.device_dispatches``).
        self.dispatch_count = 0
        #: per-impl totals ``{name: {count, wall_s, bytes}}``, populated only
        #: while a tracer is attached.
        self.dispatch_stats: dict = {}
        self._tracer = None
        self._t_origin = 0.0

    # ------------------------------------------------------------ dispatch
    def attach_tracer(self, tracer, *, t_origin: float | None = None) -> None:
        """Record per-dispatch wall spans (category ``dispatch``, via
        ``tracer.complete``) and per-impl timing/byte totals.  The spans
        time the host call: kernels run asynchronously on the card, so a
        span ends when the impl has enqueued its work or read its result."""
        self._tracer = tracer
        self._t_origin = (time.perf_counter() if t_origin is None
                          else t_origin)

    def _dispatch(self, fn, *args, **kwargs):
        """Per-instance shim over :func:`_device_call`: counting is always
        on; timing and span emission only while a tracer is attached."""
        self.dispatch_count += 1
        if self._tracer is None:
            return _device_call(fn, *args, **kwargs)
        name = getattr(fn, "__name__", None) or repr(fn)
        t0 = time.perf_counter()
        out = _device_call(fn, *args, **kwargs)
        dt = time.perf_counter() - t0
        st = self.dispatch_stats.setdefault(
            name, {"count": 0, "wall_s": 0.0, "bytes": 0})
        st["count"] += 1
        st["wall_s"] += dt
        st["bytes"] += _tree_nbytes(args) + _tree_nbytes(out)
        self._tracer.complete("dispatch", name, t0 - self._t_origin, dt)
        return out

    def _keys(self, keys) -> torch.Tensor:
        """uint32 keys (numpy/list/tensor) as the int64 device representation."""
        if isinstance(keys, torch.Tensor):
            return keys.to(device=self.device, dtype=torch.int64)
        arr = np.asarray(keys, np.uint32).astype(np.int64)
        return torch.from_numpy(arr).to(self.device)

    def _vals(self, vals) -> torch.Tensor:
        if isinstance(vals, torch.Tensor):
            return vals.to(device=self.device, dtype=torch.int32)
        return torch.from_numpy(np.asarray(vals, np.int32)).to(self.device)

    # --------------------------------------------------------- pending queue
    def _enqueue(self, node: _HostNode, front: bool = False) -> None:
        (self._pending.appendleft if front else self._pending.append)(node)
        self._pending_n[node.nid] += 1

    def _dequeue(self) -> _HostNode:
        node = self._pending.popleft()
        self._pending_n[node.nid] -= 1
        if not self._pending_n[node.nid]:
            del self._pending_n[node.nid]
        return node

    # ------------------------------------------------------------------ public
    def insert_batch(self, keys, vals) -> None:
        """Merge a batch into the root run (merge kernel).

        Oversized batches are split into sigma-sized chunks with
        backpressure maintenance between them: the bounded-latency contract
        holds per chunk.
        """
        keys, vals = self._keys(keys), self._vals(vals)
        n = int(keys.shape[0])
        if self.root.count + n > self.run_cap or n > self.sigma:
            for i in range(0, n, self.sigma):
                while self.root.count + self.sigma > self.run_cap:
                    if self.maintain(4) == 0 and self.root.count + self.sigma > self.run_cap:
                        break  # tree fully maintained; capacity guaranteed
                self._insert_chunk(keys[i:i + self.sigma], vals[i:i + self.sigma])
            return
        self._insert_chunk(keys, vals)

    def _device_int(self, i: int) -> torch.Tensor:
        """A host int as a 0-d device tensor (an eager window's bound)."""
        return torch.tensor(i, device=self.device)

    def _insert_chunk(self, keys, vals) -> None:
        n = int(keys.shape[0])
        if self._fused:
            self._dispatch(_insert_impl, self.run_keys, self.run_vals,
                           self.run_count, self.bloom, keys, vals,
                           run_cap=self.run_cap, nbits=self.nbits, h=self.h)
            self.root.count += n
        else:
            bk, bv = self._dispatch(_prepare_batch, keys, vals)
            mk, mv = self._dispatch(ops.merge_sorted, bk, bv,
                                    self.run_keys[0, : self.run_cap],
                                    self.run_vals[0])
            self._dispatch(_write_row, self.run_keys, 0, mk[: self.run_cap])
            self._dispatch(_write_row, self.run_vals, 0, mv[: self.run_cap])
            self.root.count += n
            self._dispatch(_write_row, self.run_count, 0, self.root.count)
            self._dispatch(_write_row, self.bloom, 0, self._dispatch(
                _build_bloom, self.run_keys[0], self.nbits, self.h))
        assert self.root.count <= self.run_cap, "root run overflow: call maintain()"
        self.n_items += n
        if self.root.count > self.sigma and self.root.nid not in self._pending_n:
            self._enqueue(self.root)

    def delete_batch(self, keys) -> None:
        keys = self._keys(keys)
        self.insert_batch(keys, torch.full(keys.shape, TOMBSTONE32,
                                           dtype=torch.int32, device=self.device))

    def query_batch(self, keys):
        """``(present bool (B,), vals int32 (B,))`` — one descent call.

        The descent stops after ``height + 1`` levels: leaves sit at uniform
        depth and the parked repeats past a leaf change nothing, so answers
        and Bloom tallies equal those of the JAX index's ``max_levels + 1``
        levels.  The tallies accumulate into ``bloom_probes`` /
        ``bloom_negative_skips`` / ``bloom_false_positives``.
        """
        q = self._keys(keys)
        present, out, tallies = self._dispatch(
            _query_batch_impl, self.pivots, self.nchild, self.children,
            self.run_keys, self.run_vals, self.run_count, self.bloom, q,
            f=self.f, levels=min(self.height, self.max_levels),
            nbits=self.nbits, h=self.h)
        n_probe, n_neg, n_fp = tallies.tolist()
        self.bloom_probes += n_probe
        self.bloom_negative_skips += n_neg
        self.bloom_false_positives += n_fp
        return present, out

    def range_query_batch(self, lo, hi, max_results: int = 256):
        """Batched inclusive range scan ``[lo_b, hi_b]`` — one descent call.

        Returns ``(keys (B, max_results), vals int32 (B, max_results), count
        int32 (B,), truncated bool (B,))``: per query the up-to-
        ``max_results`` freshest live pairs in the range, sorted by key and
        KEY_MAX-padded; ``truncated`` flags queries whose full result did
        not fit.  ``lo > hi`` is an empty range.  The host routes each query
        to the nodes whose key interval intersects it (pre-order, ancestors
        first); the candidate count is padded to a power of two, as in JAX.
        """
        lo = np.asarray(lo, np.uint32)
        hi = np.asarray(hi, np.uint32)
        assert lo.shape == hi.shape and lo.ndim == 1
        B = lo.shape[0]
        routes = [self._route_range(int(l), int(h)) for l, h in zip(lo, hi)]
        M = max(1, *(len(r) for r in routes)) if routes else 1
        M = 1 << (M - 1).bit_length()
        nodes = np.full((B, M), -1, np.int32)
        for b, r in enumerate(routes):
            nodes[b, : len(r)] = r
        return self._dispatch(
            _range_query_batch_impl, self.run_keys, self.run_vals,
            self.run_count, torch.from_numpy(nodes).to(self.device),
            self._keys(lo), self._keys(hi), cap=int(max_results),
            max_results=int(max_results))

    def _route_range(self, lo: int, hi: int) -> list[int]:
        """Pre-order ids of nodes whose key interval intersects [lo, hi]."""
        if lo > hi:
            return []
        out: list[int] = []

        def rec(node, nlo, nhi):
            out.append(node.nid)
            if node.is_leaf:
                return
            bounds = [nlo, *node.skeys, nhi]
            for i, c in enumerate(node.children):
                clo, chi = bounds[i], bounds[i + 1]
                if (chi is None or lo < chi) and (clo is None or hi >= clo):
                    rec(c, clo, chi)

        rec(self.root, None, None)
        return out

    def maintain(self, max_units: int = 1) -> int:
        """Run up to ``max_units`` flush/split units; returns pending count.

        The deamortization knob: a serving loop calls ``maintain(k)`` once
        per step, so index upkeep never stalls a step for more than k
        units.  On the fused path a flush unit is ONE impl call (plus its
        count read).
        """
        units = 0
        while self._pending and units < max_units:
            node = self._dequeue()
            if node.count <= self.sigma:
                continue
            units += self._handle_full(node)
        return len(self._pending)

    def drain(self) -> None:
        while self.maintain(64):
            pass

    # -------------------------------------------------------- paper operations
    def _handle_full(self, node: _HostNode) -> int:
        """One HandleFullSNode step (Sec. 5.1).  Returns work units done.

        If flushing ``node`` would push a child's run past ``run_cap``, the
        unit goes to that child instead (``node`` keeps its place at the
        head of the queue): see :meth:`_overflowing_child`.
        """
        while not node.is_leaf:
            child = self._overflowing_child(node)
            if child is None:
                break
            self._enqueue(node, front=True)
            node = child
        self.units_done += 1
        if node.is_leaf:
            if node is self.root:
                self._split_root_leaf()
            else:
                self._split_upward(node)
            return 1
        self._flush(node)
        sizes = [c.count for c in node.children]
        big = int(np.argmax(sizes))
        if sizes[big] > self.sigma:
            # single recursive call — queued as a separate work unit.
            self._enqueue(node.children[big], front=True)
        if node.count > self.sigma:
            # node absorbed multiple batches; it still owes another flush.
            self._enqueue(node)
        return 1

    def _overflowing_child(self, node: _HostNode):
        """The child a flush of ``node`` would overfill, or None.

        A child whose run plus its share of the moved pairs exceeds
        ``run_cap`` would lose its tail: the JAX package's index asserts
        ("child run overflow") after the flush has written the truncated
        row.  One large batch (a bulk load, a recovery's snapshot) reaches
        that state, since the insert path's backpressure watches only the
        root.  A flush moves at most ``sigma`` pairs (unless one key's
        copies fill the head of the run: that group moves whole, and this
        check does not see it), so only a child within ``sigma`` of
        ``run_cap`` can overflow, and the shares are read from the device
        only then, outside the dispatch funnel (the JAX index makes no such
        read; dispatch counts stay comparable).  Wherever the JAX index
        does not overflow, the port's tables stay bit-identical to it.
        """
        if all(c.count + self.sigma <= self.run_cap for c in node.children):
            return None
        lens = _device_call(
            _flush_lens, self.run_keys, node.nid,
            self._keys([int(k) for k in node.skeys]), node.count,
            sigma=self.sigma, run_cap=self.run_cap).tolist()
        for c, n in zip(node.children, lens):
            if c.count + n > self.run_cap:
                return c
        return None

    def _alloc(self, parent) -> _HostNode:
        if self._next_id >= self.max_nodes:
            self._grow_tables()
        n = _HostNode(self._next_id, parent)
        self._next_id += 1
        return n

    def _grow_tables(self) -> None:
        (self.pivots, self.children, self.nchild, self.run_keys,
         self.run_vals, self.run_count, self.bloom) = self._dispatch(
            _grow_impl, self.pivots, self.children, self.nchild,
            self.run_keys, self.run_vals, self.run_count, self.bloom)
        self.max_nodes *= 2

    def _flush(self, node: _HostNode) -> None:
        """Stream-merge the first sigma live pairs into the children."""
        if self._fused:
            self._flush_fused(node)
        else:
            self._flush_eager(node)

    def _flush_fused(self, node: _HostNode) -> None:
        nc = len(node.children)
        counts = self._dispatch(
            _flush_impl, self.run_keys, self.run_vals, self.run_count,
            self.bloom, node.nid,
            torch.tensor([c.nid for c in node.children], device=self.device),
            self._keys([int(k) for k in node.skeys]), node.count,
            nc=nc, leaf=node.children[0].is_leaf, sigma=self.sigma,
            sigma_pad=self.sigma_pad, run_cap=self.run_cap,
            nbits=self.nbits, h=self.h)
        counts = counts.tolist()          # the flush's one device->host sync
        for child, c in zip(node.children, counts[:-1]):
            child.count = int(c)
            assert child.count <= self.run_cap, "child run overflow"
        node.count = int(counts[-1])

    def _flush_eager(self, node: _HostNode) -> None:
        """Pre-fusion write path: ~25 dispatches and host syncs per flush."""
        nid = node.nid
        moved = min(node.count, self.sigma)
        row_k, row_v = self.run_keys[nid], self.run_vals[nid]
        if moved < node.count:
            # never split a duplicate group across the moved boundary (see
            # _flush_partition)
            k_cut = self._keys([int(row_k[moved])])
            left = int(self._dispatch(torch.searchsorted, row_k, k_cut))
            if left > 0:
                moved = min(left, moved)
            else:
                moved = min(int(self._dispatch(torch.searchsorted, row_k,
                                               k_cut, right=True)),
                            node.count)
        piv = self._keys([int(k) for k in node.skeys])
        cuts = self._dispatch(torch.searchsorted, row_k, piv)
        bounds = [0, *cuts.clamp(max=moved).tolist(), moved]
        for i, child in enumerate(node.children):
            lo, hi = bounds[i], bounds[i + 1]
            if hi <= lo:
                continue
            part_k, part_v = self._dispatch(_window, row_k, row_v,
                                            self._device_int(lo),
                                            self._device_int(hi - lo),
                                            self.sigma_pad)
            mk, mv = self._dispatch(ops.merge_sorted, part_k, part_v,
                                    self.run_keys[child.nid],
                                    self.run_vals[child.nid])
            new_count = child.count + (hi - lo)
            if child.is_leaf:
                mk, mv, live = self._dispatch(_compact_tombstones, mk, mv,
                                              self.run_cap)
                new_count = int(live)
            else:
                mk, mv = mk[: self.run_cap], mv[: self.run_cap]
            assert new_count <= self.run_cap, "child run overflow"
            self._dispatch(_write_row, self.run_keys, child.nid, mk)
            self._dispatch(_write_row, self.run_vals, child.nid, mv)
            child.count = new_count
            self._dispatch(_write_row, self.run_count, child.nid, new_count)
            self._dispatch(_write_row, self.bloom, child.nid, self._dispatch(
                _build_bloom, mk, self.nbits, self.h))
        # the paper advances a lazy watermark; a device row rewrite is a
        # stream copy, so the parent is compacted at once (DESIGN.md §2).
        rest = node.count - moved
        rk, rv = self._dispatch(_window, row_k, row_v,
                                self._device_int(moved),
                                self._device_int(rest), self.run_cap)
        self._dispatch(_write_row, self.run_keys, nid, rk)
        self._dispatch(_write_row, self.run_vals, nid, rv)
        node.count = rest
        self._dispatch(_write_row, self.run_count, nid, rest)
        self._dispatch(_write_row, self.bloom, nid, self._dispatch(
            _build_bloom, rk, self.nbits, self.h))

    def _split_root_leaf(self) -> None:
        """First split: the root leaf becomes a root with two leaf children."""
        left, right = self._alloc(self.root), self._alloc(self.root)
        k_m = self._split_run(self.root, left, right)
        self.root.skeys = [k_m]
        self.root.children = [left, right]
        self._sync_structure(self.root)
        # root keeps an empty run (the in-memory buffer of the paper).
        self._clear_run(self.root)

    def _split_upward(self, node: _HostNode) -> None:
        self._split_node(node)
        anc = node.parent
        while anc is not None and len(anc.children) > self.f:
            if anc is self.root:
                self._split_root_internal()
                return
            self._split_node(anc)
            anc = anc.parent

    def _split_node(self, node: _HostNode) -> None:
        parent = node.parent
        left, right = self._alloc(parent), self._alloc(parent)
        k_m = self._split_structure(node, left, right)
        i = parent.children.index(node)
        parent.children[i: i + 1] = [left, right]
        parent.skeys.insert(i, k_m)
        self._sync_structure(parent)

    def _split_root_internal(self) -> None:
        """Root fanout exceeded f: grow the s-tree height by one."""
        old = self.root
        left = self._alloc(None)
        right = self._alloc(None)
        k_m = self._split_structure(old, left, right)
        old.skeys = [k_m]
        old.children = [left, right]
        left.parent = right.parent = old
        self._sync_structure(old)

    def _split_structure(self, node, left, right) -> int:
        """Split node's run (and pivots/children for internal nodes)."""
        if node.is_leaf:
            k_m = self._split_run(node, left, right)
        else:
            mid = len(node.skeys) // 2
            k_m = node.skeys[mid]
            left.skeys, right.skeys = node.skeys[:mid], node.skeys[mid + 1:]
            left.children, right.children = node.children[: mid + 1], node.children[mid + 1:]
            for c in left.children:
                c.parent = left
            for c in right.children:
                c.parent = right
            self._split_run(node, left, right, at_key=k_m)
            self._sync_structure(left)
            self._sync_structure(right)
        # the original node id is retired (ids are cheap; production would
        # recycle them).
        self._clear_run(node)
        node.count = 0
        return k_m

    def _split_run(self, node, left, right, at_key: int | None = None) -> int:
        if self._fused:
            has_key = at_key is not None
            out = self._dispatch(
                _split_impl, self.run_keys, self.run_vals, self.run_count,
                self.bloom, node.nid, left.nid, right.nid, node.count,
                int(at_key) if has_key else 0, has_key=has_key,
                run_cap=self.run_cap, nbits=self.nbits, h=self.h)
            k_m, cut = out.tolist()       # the split's one device->host sync
            left.count, right.count = cut, node.count - cut
            return k_m
        row_k, row_v = self.run_keys[node.nid], self.run_vals[node.nid]
        k_m = int(row_k[node.count // 2]) if at_key is None else int(at_key)
        cut = int(self._dispatch(torch.searchsorted, row_k,
                                 self._keys([k_m])))
        if at_key is not None:
            cut = min(cut, node.count)
        for dst, lo, ln in ((left, 0, cut), (right, cut, node.count - cut)):
            dk, dv = self._dispatch(_window, row_k, row_v,
                                    self._device_int(lo),
                                    self._device_int(ln), self.run_cap)
            self._dispatch(_write_row, self.run_keys, dst.nid, dk)
            self._dispatch(_write_row, self.run_vals, dst.nid, dv)
            dst.count = ln
            self._dispatch(_write_row, self.run_count, dst.nid, ln)
            self._dispatch(_write_row, self.bloom, dst.nid, self._dispatch(
                _build_bloom, dk, self.nbits, self.h))
        return k_m

    def _clear_run(self, node) -> None:
        nid = node.nid
        if self._fused:
            self._dispatch(_clear_impl, self.run_keys, self.run_vals,
                           self.run_count, self.bloom, nid)
        else:
            self._dispatch(_write_row, self.run_keys, nid, KEY_MAX32)
            self._dispatch(_write_row, self.run_vals, nid, 0)
            self._dispatch(_write_row, self.run_count, nid, 0)
            self._dispatch(_write_row, self.bloom, nid, 0)
        node.count = 0

    def _sync_structure(self, node: _HostNode) -> None:
        """Mirror a host node's pivots/children into the device tables."""
        pv = np.full(self.f - 1, KEY_MAX32, np.int64)
        ch = np.zeros(self.f, np.int32)
        for i, k in enumerate(node.skeys[: self.f - 1]):
            pv[i] = int(k)
        for i, c in enumerate(node.children[: self.f]):
            ch[i] = c.nid
        pv = torch.from_numpy(pv).to(self.device)
        ch = torch.from_numpy(ch).to(self.device)
        if self._fused:
            self._dispatch(_sync_impl, self.pivots, self.children,
                           self.nchild, node.nid, pv, ch, len(node.children))
        else:
            self._dispatch(_write_row, self.pivots, node.nid, pv)
            self._dispatch(_write_row, self.children, node.nid, ch)
            self._dispatch(_write_row, self.nchild, node.nid,
                           len(node.children))

    # ------------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        assert not self._pending, "drain() before checking invariants"

        def rec(node, lo, hi_excl, depth, depths):
            ks = self.run_keys[node.nid, : node.count].cpu().numpy()
            if len(ks):
                assert np.all(ks[:-1] <= ks[1:]), "run not sorted"
                assert lo is None or ks[0] >= lo
                assert hi_excl is None or ks[-1] < hi_excl
            if node.is_leaf:
                depths.add(depth)
                return
            assert len(node.children) == len(node.skeys) + 1 <= self.f
            bounds = [lo, *node.skeys, hi_excl]
            for i, c in enumerate(node.children):
                assert c.parent is node
                rec(c, bounds[i], bounds[i + 1], depth + 1, depths)

        depths: set = set()
        rec(self.root, None, None, 0, depths)
        assert len(depths) <= 1, "leaves at non-uniform depth"

    @property
    def height(self) -> int:
        h, n = 0, self.root
        while not n.is_leaf:
            n, h = n.children[0], h + 1
        return h

    def total_pairs(self) -> int:
        total, stack = 0, [self.root]
        while stack:
            n = stack.pop()
            total += n.count
            stack.extend(n.children)
        return total

    def table_bytes(self) -> int:
        """Bytes held by the seven node tables on the device."""
        return sum(t.nbytes for t in (self.pivots, self.children, self.nchild,
                                      self.run_keys, self.run_vals,
                                      self.run_count, self.bloom))
