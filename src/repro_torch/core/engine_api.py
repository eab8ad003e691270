"""StorageEngine protocol of the port, and the ``torch-nbtree`` engine.

The port's own copy of the protocol surface of ``repro/core/engine_api.py``
(``OpKind``, ``OpBatch``, ``OpResult``, ``EngineStats``, the
``StorageEngine`` base and an engine registry), plus
:class:`TorchNBTreeEngine`, the port of ``DeviceNBTreeEngine``: the
PyTorch/CUDA device tier under the protocol, registered as
``torch-nbtree``.

Semantics are sequential within a batch: op i+1 observes op i.  The engine
groups maximal same-kind op runs into one device call, which preserves
them because ``insert_batch`` resolves intra-batch duplicates newest-wins
and queries cannot appear inside an insert group.

Key/value domain: keys are uint32 on the device (carried as uint64 in an
``OpBatch``), values non-negative int32-representable; ``TOMBSTONE32`` is
reserved.
"""
from __future__ import annotations

import abc
import dataclasses
import enum
import time

import numpy as np
import torch

from ..obs.metrics import LogBucketHistogram
from .torch_nbtree import TOMBSTONE32, NBTreeIndex

KEY_DTYPE = np.uint64
VAL_DTYPE = np.int64


class OpKind(enum.IntEnum):
    INSERT = 0
    DELETE = 1
    QUERY = 2
    RANGE = 3


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

    ``io_time_s`` is the engine's accumulated host wall clock.
    ``total_pairs`` is the logical live pair count, ``physical_pairs`` the
    resident count (stale duplicates and tombstones included).
    ``pending_debt`` is the deferred maintenance still owed.  The ``bloom_*``
    counters are the Bloom effectiveness tallies of paper Sec. 5.2; the
    ``maintain_*`` fields time each maintenance work unit on the wall clock
    (percentiles from the bounded log-bucket histogram: exact p100).
    ``device_dispatches`` counts impl calls of this engine's index.
    ``shards``/``shard_debt``/``applied_lsn`` keep the JAX package's report
    shape; the port has no sharding or WAL yet, so they hold defaults.
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
    """The engine protocol: ``apply``, ``maintain``/``drain``, observers."""

    name: str = "engine"

    def __init__(self):
        self._counts = {k: 0 for k in OpKind}

    @abc.abstractmethod
    def apply(self, batch: OpBatch) -> OpResult:
        """Apply a batch with sequential semantics; visible results."""

    def maintain(self, budget: int = 1) -> int:
        """Run up to ``budget`` units of deferred work; returns pending debt."""
        return 0

    def drain(self) -> None:
        """Finish all deferred work (tests / shutdown)."""
        while self.maintain(64):
            pass

    @abc.abstractmethod
    def dump_live(self) -> tuple:
        """``(keys, vals)`` of every visible pair, key-sorted."""

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


def _pad_pow2(a: np.ndarray) -> np.ndarray:
    """Pad a 1-d array to the next power-of-two length by repeating a[-1]."""
    n = len(a)
    target = 1 << max(0, n - 1).bit_length()
    if n in (0, target):
        return a
    return np.concatenate([a, np.repeat(a[-1:], target - n)])


class TorchNBTreeEngine(StorageEngine):
    """The PyTorch/CUDA device tier under the protocol.

    ``apply`` groups maximal same-kind op runs into one device call; latency
    is the group's host wall clock amortized over its ops.  Every group is
    padded to a power-of-two length, exactly as the JAX engine pads: the
    padded duplicate insert (the last op repeated verbatim, a blind re-write
    that newest-wins dedup makes invisible) is part of the physical state
    the two engines share.  QUERY/RANGE pads repeat the last op and drop
    the extra outputs.
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
        self._t_origin = time.perf_counter()
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
                    _pad_pow2(batch.keys[sl].astype(np.uint32)),
                    _pad_pow2(batch.vals[sl].astype(np.int32)))
                self._sync()
            elif kind is OpKind.DELETE:
                self.idx.delete_batch(_pad_pow2(batch.keys[sl].astype(np.uint32)))
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
                    self._tracer.complete(
                        "flush_unit", "maintain_unit",
                        t0 - self._t_origin, dt,
                        unit=int(self.idx.units_done))
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
        """Per-dispatch spans from the index's funnel, flush-unit spans from
        :meth:`maintain`, on this engine's wall clock."""
        self._tracer = tracer
        self.idx.attach_tracer(tracer, t_origin=self._t_origin)

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
            device_dispatches=self.idx.dispatch_count)


# =================================================================== registry
_REGISTRY: dict = {}


def register_engine(name: str, factory) -> None:
    if name in _REGISTRY:
        raise ValueError(f"duplicate engine name {name!r}")
    _REGISTRY[name] = factory


def make_engine(name: str, **kw) -> StorageEngine:
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


register_engine("torch-nbtree", TorchNBTreeEngine)
