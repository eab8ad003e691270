"""StorageEngine protocol of the port, its engines and its registry.

The port's own copy of the protocol surface of ``repro/core/engine_api.py``
(``OpKind``, ``OpBatch``, ``OpResult``, ``EngineStats``, the
``StorageEngine`` base and an engine registry), plus the tiers:

* :class:`TorchNBTreeEngine`, the port of ``DeviceNBTreeEngine``: the
  PyTorch/CUDA device tier under the protocol, registered as
  ``torch-nbtree``;
* the host tiers on the explicit I/O cost model (sim-clock, so an
  open-loop run over them is a pure function of (trace, config)):
  :class:`RefNBTreeEngine` over the host NB-tree (``refimpl``) as
  ``nbtree``, ``nbtree-basic`` (no deamortization) and
  ``nbtree-nobloom``; :class:`LSMEngine` as ``lsm`` and ``blsm`` (three
  levels at most); :class:`BTreeEngine` as ``btree``;
  :class:`BEpsilonEngine` as ``bepsilon``; and the static
  :class:`BulkBTreeEngine` (``btree-bulk``, reads only), which, as in the
  JAX package, is built from its keys and is not in the registry.

:data:`FIVE_TIERS` names the paper's comparison set, with the port's
device tier in the JAX package's ``jax-nbtree`` place.  The
``sharded:<base>`` prefix of :func:`make_engine` builds a partitioned
ensemble of any registered engine (``shard.ShardedEngine``).

Semantics are sequential within a batch: op i+1 observes op i.  The device
engine groups maximal same-kind op runs into one device call, which
preserves them because ``insert_batch`` resolves intra-batch duplicates
newest-wins and queries cannot appear inside an insert group.

Key/value domain: keys are uint64 on the host tier and uint32 on the device
(carried as uint64 in an ``OpBatch``), so a stream for both keeps its keys
in ``[1, 2^31)``; values are non-negative int32-representable.  Reserved:
the value ``TOMBSTONE32`` (a device delete) and the key ``KEY_MAX32`` =
``0xFFFFFFFF``, the device's padding sentinel: an inserted key 2^32 - 1
reads back absent, as in the JAX package.
"""
from __future__ import annotations

import abc
import dataclasses
import enum
import time

import numpy as np
import torch

from ..obs.metrics import LogBucketHistogram
from .bepsilon import BEpsilonTree
from .btree import BPlusTree, BPlusTreeBulk
from .cost_model import HDD, CostModel, Device
from .lsm import LSMTree
from .refimpl import NBTree
from .sorted_run import KEY_DTYPE, VAL_DTYPE
from .torch_nbtree import TOMBSTONE32, NBTreeIndex


class OpKind(enum.IntEnum):
    INSERT = 0
    DELETE = 1
    QUERY = 2
    RANGE = 3


class UnsupportedOp(RuntimeError):
    """Raised by an engine that cannot serve an op kind."""


@dataclasses.dataclass
class OpBatch:
    """Columnar operation batch: parallel arrays, one row per op.

    ``keys`` is the op key (RANGE: inclusive lower bound), ``vals`` the
    INSERT payload (ignored elsewhere), ``his`` the RANGE inclusive upper
    bound (ignored elsewhere).
    """

    kinds: np.ndarray   # int8   (B,)
    keys: np.ndarray    # uint64 (B,)
    vals: np.ndarray    # int64  (B,)
    his: np.ndarray     # uint64 (B,)

    def __post_init__(self):
        self.kinds = np.asarray(self.kinds, np.int8)
        self.keys = np.asarray(self.keys, KEY_DTYPE)
        self.vals = np.asarray(self.vals, VAL_DTYPE)
        self.his = np.asarray(self.his, KEY_DTYPE)
        n = len(self.kinds)
        if not self.keys.shape == self.vals.shape == self.his.shape == (n,):
            raise ValueError("OpBatch arrays must be parallel 1-d arrays of "
                             "one length")

    def __len__(self) -> int:
        return len(self.kinds)

    @staticmethod
    def inserts(keys, vals) -> "OpBatch":
        keys = np.asarray(keys, KEY_DTYPE)
        return OpBatch(np.full(len(keys), OpKind.INSERT, np.int8), keys,
                       np.asarray(vals, VAL_DTYPE), np.zeros(len(keys), KEY_DTYPE))

    @staticmethod
    def deletes(keys) -> "OpBatch":
        keys = np.asarray(keys, KEY_DTYPE)
        z = np.zeros(len(keys), KEY_DTYPE)
        return OpBatch(np.full(len(keys), OpKind.DELETE, np.int8), keys,
                       np.zeros(len(keys), VAL_DTYPE), z)

    @staticmethod
    def queries(keys) -> "OpBatch":
        keys = np.asarray(keys, KEY_DTYPE)
        z = np.zeros(len(keys), KEY_DTYPE)
        return OpBatch(np.full(len(keys), OpKind.QUERY, np.int8), keys,
                       np.zeros(len(keys), VAL_DTYPE), z)

    @staticmethod
    def ranges(los, his) -> "OpBatch":
        los = np.asarray(los, KEY_DTYPE)
        return OpBatch(np.full(len(los), OpKind.RANGE, np.int8), los,
                       np.zeros(len(los), VAL_DTYPE), np.asarray(his, KEY_DTYPE))

    @staticmethod
    def empty() -> "OpBatch":
        return OpBatch(np.zeros(0, np.int8), np.zeros(0, KEY_DTYPE),
                       np.zeros(0, VAL_DTYPE), np.zeros(0, KEY_DTYPE))

    @staticmethod
    def concat(batches) -> "OpBatch":
        """Concatenate batches in order (sequential semantics kept); no
        batches, or only empty ones, give the empty batch."""
        batches = [b for b in batches if len(b)]
        if not batches:
            return OpBatch.empty()
        return OpBatch(np.concatenate([b.kinds for b in batches]),
                       np.concatenate([b.keys for b in batches]),
                       np.concatenate([b.vals for b in batches]),
                       np.concatenate([b.his for b in batches]))


@dataclasses.dataclass
class OpResult:
    """Visible results + per-op latency for one applied :class:`OpBatch`.

    ``found``/``values`` are meaningful on QUERY rows, ``range_hits[i]`` is
    a ``(keys, vals)`` pair on RANGE rows (None elsewhere), ``latency_s``
    (host wall clock, a group's time amortized over its ops) on every row;
    ``range_truncated[i]`` flags RANGE rows whose result hit the capacity
    limit and is incomplete.
    """

    kinds: np.ndarray
    found: np.ndarray        # bool  (B,)
    values: np.ndarray       # int64 (B,) — -1 where not found / not a query
    range_hits: list         # list[Optional[tuple[np.ndarray, np.ndarray]]]
    latency_s: np.ndarray    # float64 (B,)
    range_truncated: np.ndarray = None  # bool (B,)

    def __post_init__(self):
        if self.range_truncated is None:
            self.range_truncated = np.zeros(len(self.kinds), bool)

    def latencies(self, kind: OpKind | None = None) -> np.ndarray:
        if kind is None:
            return self.latency_s
        return self.latency_s[self.kinds == int(kind)]


@dataclasses.dataclass
class EngineStats:
    """Uniform engine snapshot; every field is cumulative since construction.

    ``io_time_s`` is the engine's charged cost: simulated seconds on the
    host tier, accumulated host wall clock on the device tier.
    ``total_pairs`` is the logical live pair count, ``physical_pairs`` the
    resident count (stale duplicates and tombstones included).
    ``pending_debt`` is the deferred maintenance still owed.  The ``bloom_*``
    counters are the Bloom effectiveness tallies of paper Sec. 5.2; the
    ``maintain_*`` fields time each maintenance work unit on the wall clock
    (percentiles from the bounded log-bucket histogram: exact p100).
    ``device_dispatches`` counts impl calls of this engine's index.
    ``applied_lsn`` is the highest WAL commit applied (written through
    :meth:`StorageEngine.note_applied`; 0 outside a durable frontend).
    ``shards``/``shard_debt`` are the shard count and per-shard debt of a
    sharded ensemble (1 and empty for a single engine).
    """

    engine: str
    clock: str
    io_time_s: float
    io_seeks: int
    io_bytes_read: int
    io_bytes_written: int
    height: int
    total_pairs: int
    physical_pairs: int
    pending_debt: int
    n_inserts: int
    n_deletes: int
    n_queries: int
    n_ranges: int
    shards: int = 1
    shard_debt: list = dataclasses.field(default_factory=list)
    bloom_probes: int = 0
    bloom_negative_skips: int = 0
    bloom_false_positives: int = 0
    maintain_units: int = 0
    maintain_wall_s: float = 0.0
    maintain_unit_p50_s: float = 0.0
    maintain_unit_p99_s: float = 0.0
    maintain_unit_p100_s: float = 0.0
    device_dispatches: int = 0
    applied_lsn: int = 0


class StorageEngine(abc.ABC):
    """The engine protocol: ``apply``, ``maintain``/``drain``, observers.

    The default :meth:`apply` runs op by op through four scalar hooks (the
    host tier); the device engine overrides it wholesale.
    """

    name: str = "engine"

    def __init__(self):
        self._counts = {k: 0 for k in OpKind}
        self.applied_lsn = 0        # highest durably-logged commit applied

    def apply(self, batch: OpBatch) -> OpResult:
        """Apply a batch with sequential semantics; visible results."""
        n = len(batch)
        found = np.zeros(n, bool)
        values = np.full(n, -1, VAL_DTYPE)
        range_hits: list = [None] * n
        lat = np.zeros(n, np.float64)
        for i in range(n):
            kind = OpKind(int(batch.kinds[i]))
            k = int(batch.keys[i])
            if kind is OpKind.INSERT:
                lat[i] = self._do_insert(k, int(batch.vals[i]))
            elif kind is OpKind.DELETE:
                lat[i] = self._do_delete(k)
            elif kind is OpKind.QUERY:
                found[i], values[i], lat[i] = self._do_query(k)
            else:
                rk, rv, lat[i] = self._do_range(k, int(batch.his[i]))
                range_hits[i] = (rk, rv)
            self._counts[kind] += 1
        return OpResult(batch.kinds.copy(), found, values, range_hits, lat)

    def _do_insert(self, key: int, val: int) -> float:
        raise UnsupportedOp(f"{self.name} does not support INSERT")

    def _do_delete(self, key: int) -> float:
        raise UnsupportedOp(f"{self.name} does not support DELETE")

    def _do_query(self, key: int):
        raise UnsupportedOp(f"{self.name} does not support QUERY")

    def _do_range(self, lo: int, hi: int):
        raise UnsupportedOp(f"{self.name} does not support RANGE")

    def attach_tracer(self, tracer) -> None:
        """Attach an ``obs.trace.Tracer``; engines with nothing structured
        to report ignore it (the device engine forwards it to its index)."""

    def maintain(self, budget: int = 1) -> int:
        """Run up to ``budget`` units of deferred work; returns pending debt."""
        return 0

    def drain(self) -> None:
        """Finish all deferred work (tests / shutdown)."""
        while self.maintain(64):
            pass

    def note_applied(self, lsn: int) -> None:
        """Record that every WAL commit up to ``lsn`` has been applied.

        Called by the durable ingest frontend after each group commit's
        ``apply`` and by WAL replay during recovery; surfaced as
        ``EngineStats.applied_lsn``.  Monotone: a stale LSN never moves it
        back.
        """
        if lsn > self.applied_lsn:
            self.applied_lsn = int(lsn)

    @abc.abstractmethod
    def dump_live(self) -> tuple:
        """``(keys, vals)`` of every visible pair, key-sorted, cost-free:
        the snapshot primitive of the durability layer."""

    def dump_live_range(self, lo: int, hi: int) -> tuple:
        """``(keys, vals)`` of visible pairs with ``lo <= key <= hi``
        (a cost-free observer, like :meth:`dump_live`)."""
        keys, vals = self.dump_live()
        a = int(np.searchsorted(keys, np.asarray(lo, KEY_DTYPE), "left"))
        b = int(np.searchsorted(keys, np.asarray(hi, KEY_DTYPE), "right"))
        return keys[a:b], vals[a:b]

    def count_live_range(self, lo: int, hi: int) -> int:
        """Exact number of visible keys in ``[lo, hi]`` (cost-free)."""
        return len(self.dump_live_range(lo, hi)[0])

    @abc.abstractmethod
    def io_time_s(self) -> float:
        """Cumulative charged cost (O(1))."""

    @abc.abstractmethod
    def height(self) -> int:
        """Index height (O(height))."""

    @abc.abstractmethod
    def stats(self) -> EngineStats:
        """Full snapshot (O(n): ``total_pairs`` is an exact count)."""

    @abc.abstractmethod
    def count_live(self) -> int:
        """Exact number of visible (non-deleted, deduplicated) keys."""


# =========================================================== cost-model tiers
class CostModelEngine(StorageEngine):
    """Adapter base for the host tiers: scalar impl + explicit CostModel."""

    clock = "sim"

    def __init__(self, impl):
        super().__init__()
        self.impl = impl

    @property
    def cm(self) -> CostModel:
        return self.impl.cm

    def _do_insert(self, key, val):
        return float(self.impl.insert(key, val))

    def _do_delete(self, key):
        return float(self.impl.delete(key))

    def _do_query(self, key):
        v, t = self.impl.query(key)
        return v is not None, -1 if v is None else int(v), float(t)

    def _do_range(self, lo, hi):
        rk, rv = self.impl.range_query(lo, hi)
        return rk, rv, float(self.impl._last_query_time)

    def dump_live(self) -> tuple:
        # an all-keyspace range scan is exact; the cost counters are saved
        # and restored so that observing charges nothing.
        cm = self.cm
        saved = (cm.seeks, cm.bytes_read, cm.bytes_written, cm.pages)
        try:
            rk, rv = self.impl.range_query(0, int(np.iinfo(KEY_DTYPE).max))
        finally:
            cm.seeks, cm.bytes_read, cm.bytes_written, cm.pages = saved
        return (np.asarray(rk, KEY_DTYPE), np.asarray(rv, VAL_DTYPE))

    def count_live(self) -> int:
        return len(self.dump_live()[0])

    def height(self) -> int:
        return 1

    def _pending_debt(self) -> int:
        return 0

    def _bloom_stats(self) -> tuple:
        """(probes, negative_skips, false_positives); zeros by default."""
        return (0, 0, 0)

    def io_time_s(self) -> float:
        return self.cm.time

    def stats(self) -> EngineStats:
        cm = self.cm
        probes, skips, fps = self._bloom_stats()
        return EngineStats(
            engine=self.name, clock=self.clock, io_time_s=cm.time,
            io_seeks=cm.seeks, io_bytes_read=cm.bytes_read,
            io_bytes_written=cm.bytes_written, height=self.height(),
            total_pairs=self.count_live(),
            physical_pairs=int(self.impl.total_pairs()),
            pending_debt=self._pending_debt(),
            n_inserts=self._counts[OpKind.INSERT],
            n_deletes=self._counts[OpKind.DELETE],
            n_queries=self._counts[OpKind.QUERY],
            n_ranges=self._counts[OpKind.RANGE],
            bloom_probes=int(probes), bloom_negative_skips=int(skips),
            bloom_false_positives=int(fps),
            applied_lsn=self.applied_lsn)


class RefNBTreeEngine(CostModelEngine):
    """The paper-faithful host NB-tree (``refimpl``) under the protocol."""

    name = "nbtree"

    def __init__(self, f: int = 3, sigma: int = 4096, *, device: Device = HDD,
                 **kw):
        super().__init__(NBTree(f=f, sigma=sigma, device=device, **kw))

    def maintain(self, budget: int = 1) -> int:
        """Advance the pending cascade by up to ``budget`` page quanta."""
        t = self.impl
        if t._cascade is None:
            return 0
        try:
            for _ in range(budget):
                next(t._cascade)
        except StopIteration:
            t._cascade = None
            t._frozen = None
        return 0 if t._cascade is None else 1

    def height(self) -> int:
        return self.impl.height

    def _pending_debt(self) -> int:
        return 0 if self.impl._cascade is None else 1

    def _bloom_stats(self) -> tuple:
        t = self.impl
        return (t.bloom_probes, t.bloom_negative_skips,
                t.bloom_false_positives)


class LSMEngine(CostModelEngine):
    name = "lsm"

    def __init__(self, mem_pairs: int = 4096, ratio: int = 10, *,
                 device: Device = HDD, **kw):
        super().__init__(LSMTree(mem_pairs=mem_pairs, ratio=ratio,
                                 device=device, **kw))

    def height(self) -> int:
        return len(self.impl.levels)

    def _bloom_stats(self) -> tuple:
        t = self.impl
        return (t.bloom_probes, t.bloom_negative_skips,
                t.bloom_false_positives)


class BTreeEngine(CostModelEngine):
    """Incremental B+-tree (per-insert leaf read-modify-write)."""

    name = "btree"

    def __init__(self, *, device: Device = HDD, **kw):
        super().__init__(BPlusTree(device=device, **kw))


class BEpsilonEngine(CostModelEngine):
    name = "bepsilon"

    def __init__(self, *, fanout: int = 16, node_bytes: int = 4 << 20,
                 cached_levels: int = 2, device: Device = HDD, **kw):
        super().__init__(BEpsilonTree(fanout=fanout, node_bytes=node_bytes,
                                      cached_levels=cached_levels,
                                      device=device, **kw))

    def height(self) -> int:
        h, node = 0, self.impl.root
        while not node.is_leaf:
            node = node.children[0]
            h += 1
        return h


class BulkBTreeEngine(CostModelEngine):
    """Static bulk-loaded B+-tree: QUERY/RANGE only (the paper's
    yardstick)."""

    name = "btree-bulk"

    def __init__(self, keys, vals, *, device: Device = HDD, **kw):
        super().__init__(BPlusTreeBulk(keys, vals, device=device, **kw))

    def _do_insert(self, key, val):
        raise UnsupportedOp("btree-bulk is static: INSERT unsupported")

    def _do_delete(self, key):
        raise UnsupportedOp("btree-bulk is static: DELETE unsupported")

    def count_live(self) -> int:
        return len(self.impl.keys)


# ================================================================ device tier
def _pad_pow2(a: np.ndarray, max_copies: int | None = None) -> np.ndarray:
    """Pad a 1-d array to the next power-of-two length by repeating a[-1],
    unless that takes ``max_copies`` or more repeats (then ``a`` as is)."""
    n = len(a)
    target = 1 << max(0, n - 1).bit_length()
    if n in (0, target) or (max_copies is not None
                            and target - n >= max_copies):
        return a
    return np.concatenate([a, np.repeat(a[-1:], target - n)])


class TorchNBTreeEngine(StorageEngine):
    """The PyTorch/CUDA device tier under the protocol.

    ``apply`` groups maximal same-kind op runs into one device call; latency
    is the group's host wall clock amortized over its ops.  A group is
    padded to a power-of-two length as the JAX engine pads it: the padded
    duplicate insert (the last op repeated verbatim, a blind re-write that
    newest-wins dedup makes invisible) is part of the physical state the
    two engines share.  QUERY/RANGE pads repeat the last op and drop the
    extra outputs.  The one exception: an INSERT/DELETE pad of ``sigma`` or
    more copies (a group far above ``sigma``: a bulk load, a recovery's
    snapshot) is left out.  The root keeps duplicates, and a flush moves a key's copies
    as one group, so such a pad would reach one child as a duplicate group
    larger than any run may take; the JAX engine, which pads it, fails
    there.  Every group of at most ``sigma`` ops is padded as in JAX.
    Other keywords go to :class:`NBTreeIndex` (``device``, ``fused``, ...):
    ``make_engine("torch-nbtree", fused=False)`` serves on the eager write
    path.
    """

    name = "torch-nbtree"
    clock = "wall"

    def __init__(self, f: int = 4, sigma: int = 2048, *, max_nodes: int = 256,
                 max_results: int = 512, **kw):
        super().__init__()
        self.idx = NBTreeIndex(f=f, sigma=sigma, max_nodes=max_nodes, **kw)
        self._max_results = max_results
        self._wall_s = 0.0
        # wall clock per maintenance work unit (each maintain(1) timed on
        # its own): the service cost of the emptying cascade.
        self._maintain_unit_s = LogBucketHistogram()
        self._tracer = None

    def _sync(self) -> None:
        if self.idx.device.type == "cuda":
            torch.cuda.synchronize(self.idx.device)

    # ------------------------------------------------------------------ apply
    def apply(self, batch: OpBatch) -> OpResult:
        n = len(batch)
        found = np.zeros(n, bool)
        values = np.full(n, -1, VAL_DTYPE)
        range_hits: list = [None] * n
        truncated = np.zeros(n, bool)
        lat = np.zeros(n, np.float64)
        kinds = np.asarray(batch.kinds)
        sigma = self.idx.sigma
        i = 0
        while i < n:
            j = i + 1
            while j < n and kinds[j] == kinds[i]:
                j += 1
            kind = OpKind(int(kinds[i]))
            sl = slice(i, j)
            real = j - i
            t0 = time.perf_counter()
            if kind is OpKind.INSERT:
                self.idx.insert_batch(
                    _pad_pow2(batch.keys[sl].astype(np.uint32), sigma),
                    _pad_pow2(batch.vals[sl].astype(np.int32), sigma))
                self._sync()
            elif kind is OpKind.DELETE:
                self.idx.delete_batch(
                    _pad_pow2(batch.keys[sl].astype(np.uint32), sigma))
                self._sync()
            elif kind is OpKind.QUERY:
                pres, vals = self.idx.query_batch(
                    _pad_pow2(batch.keys[sl].astype(np.uint32)))
                pres = pres.cpu().numpy()[:real]
                vals = vals.cpu().numpy()[:real]
                found[sl] = pres
                values[sl] = np.where(pres, vals.astype(np.int64), -1)
            else:
                self._apply_ranges(batch, sl, range_hits, truncated)
            dt = time.perf_counter() - t0
            self._wall_s += dt
            lat[sl] = dt / real
            self._counts[kind] += real
            i = j
        return OpResult(kinds.copy(), found, values, range_hits, lat,
                        truncated)

    def _apply_ranges(self, batch: OpBatch, sl: slice, range_hits: list,
                      truncated: np.ndarray) -> None:
        los = _pad_pow2(batch.keys[sl].astype(np.uint32))
        his = _pad_pow2(batch.his[sl].astype(np.uint32))
        while True:
            rk, rv, cnt, trunc = self.idx.range_query_batch(
                los, his, max_results=self._max_results)
            trunc = trunc.cpu().numpy()
            if not trunc.any() or self._max_results >= (1 << 20):
                break
            self._max_results *= 2      # sticky: later batches start larger
        rk, rv, cnt = rk.cpu().numpy(), rv.cpu().numpy(), cnt.cpu().numpy()
        for b in range(sl.stop - sl.start):
            c = int(cnt[b])
            range_hits[sl.start + b] = (rk[b, :c].astype(KEY_DTYPE),
                                        rv[b, :c].astype(VAL_DTYPE))
            truncated[sl.start + b] = bool(trunc[b])

    # ------------------------------------------------------------- maintenance
    def maintain(self, budget: int = 1) -> int:
        """Run up to ``budget`` units, timing each unit on its own.

        ``budget <= 0`` is the free debt poll.  A unit ends in a device-to-
        host read of its counts, so its wall time covers the device work.
        """
        if budget <= 0:
            return self.idx.maintain(0)
        pending = self.idx.maintain(0)
        for _ in range(int(budget)):
            if not pending:
                break
            u0 = self.idx.units_done
            t0 = time.perf_counter()
            pending = self.idx.maintain(1)
            dt = time.perf_counter() - t0
            self._wall_s += dt
            if self.idx.units_done > u0:   # not a stale-entry-only pop
                self._maintain_unit_s.add(dt)
                if self._tracer is not None:
                    kind, depth = self.idx.last_unit
                    self._tracer.complete(
                        "flush_unit", "maintain_unit", t0, dt,
                        unit=int(self.idx.units_done), kind=kind,
                        depth=depth)
        return pending

    # ------------------------------------------------------------------- stats
    def dump_live(self) -> tuple:
        """Every visible pair, key-sorted, in one vectorised pass.

        Rows are concatenated in pre-order (ancestors first) and in-run
        order (newer duplicates first) — the freshest-copy-wins order both
        query paths resolve by — so after a stable sort by key the first
        copy of each key is the visible one; tombstones are then dropped.
        """
        idx = self.idx
        order = []
        stack = [idx.root]
        while stack:
            node = stack.pop()
            if node.count:
                order.append(node)
            stack.extend(reversed(node.children))
        if not order:
            return np.zeros(0, KEY_DTYPE), np.zeros(0, VAL_DTYPE)
        keys = torch.cat([idx.run_keys[n.nid, :n.count] for n in order])
        vals = torch.cat([idx.run_vals[n.nid, :n.count] for n in order])
        keys, perm = torch.sort(keys, stable=True)
        vals = vals[perm]
        first = torch.ones_like(keys, dtype=torch.bool)
        first[1:] = keys[1:] != keys[:-1]
        live = first & (vals != TOMBSTONE32)
        return (keys[live].cpu().numpy().astype(KEY_DTYPE),
                vals[live].cpu().numpy().astype(VAL_DTYPE))

    def count_live(self) -> int:
        return len(self.dump_live()[0])

    def io_time_s(self) -> float:
        return self._wall_s

    def height(self) -> int:
        return self.idx.height

    def attach_tracer(self, tracer) -> None:
        """Per-dispatch and backpressure-unit spans from the index,
        flush-unit spans (with the unit's kind and depth) from
        :meth:`maintain`; all in ``time.perf_counter()`` seconds."""
        self._tracer = tracer
        self.idx.attach_tracer(tracer)

    def stats(self) -> EngineStats:
        mu = self._maintain_unit_s
        return EngineStats(
            engine=self.name, clock=self.clock, io_time_s=self._wall_s,
            io_seeks=0, io_bytes_read=0, io_bytes_written=0,
            height=self.height(), total_pairs=self.count_live(),
            physical_pairs=int(self.idx.total_pairs()),
            pending_debt=len(self.idx._pending),
            n_inserts=self._counts[OpKind.INSERT],
            n_deletes=self._counts[OpKind.DELETE],
            n_queries=self._counts[OpKind.QUERY],
            n_ranges=self._counts[OpKind.RANGE],
            bloom_probes=self.idx.bloom_probes,
            bloom_negative_skips=self.idx.bloom_negative_skips,
            bloom_false_positives=self.idx.bloom_false_positives,
            maintain_units=mu.count,
            maintain_wall_s=mu.total,
            maintain_unit_p50_s=mu.quantile(0.50),
            maintain_unit_p99_s=mu.quantile(0.99),
            maintain_unit_p100_s=mu.max if mu.count else 0.0,
            device_dispatches=self.idx.dispatch_count,
            applied_lsn=self.applied_lsn)


# =================================================================== registry
_REGISTRY: dict = {}

#: the paper's comparison set: one engine per tier, every benchmark's axis.
FIVE_TIERS = ("nbtree", "lsm", "btree", "bepsilon", "torch-nbtree")


def register_engine(name: str, factory) -> None:
    if name in _REGISTRY:
        raise ValueError(f"duplicate engine name {name!r}")
    _REGISTRY[name] = factory


def make_engine(name: str, **kw) -> StorageEngine:
    if name.startswith("sharded:"):
        # a partitioned ensemble of any registered engine:
        # make_engine("sharded:nbtree", shards=4, **base_kw).  Imported
        # here: the shard package programs against this module.
        from ..shard import ShardedEngine
        base = name.split(":", 1)[1]
        if base not in _REGISTRY:
            raise KeyError(f"unknown base engine {base!r} for {name!r}; "
                           f"registered: {sorted(_REGISTRY)}")
        eng = ShardedEngine(base, **kw)
        eng.name = name
        return eng
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown engine {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None
    eng = factory(**kw)
    eng.name = name
    return eng


def available_engines() -> tuple:
    return tuple(sorted(_REGISTRY))


register_engine("nbtree", RefNBTreeEngine)
register_engine("nbtree-basic",
                lambda **kw: RefNBTreeEngine(deamortize=False, **kw))
register_engine("nbtree-nobloom",
                lambda **kw: RefNBTreeEngine(use_bloom=False, **kw))
register_engine("lsm", LSMEngine)
register_engine("blsm", lambda **kw: LSMEngine(**{"max_levels": 3, **kw}))
register_engine("btree", BTreeEngine)
register_engine("bepsilon", BEpsilonEngine)
register_engine("torch-nbtree", TorchNBTreeEngine)
