"""Deterministic workload-mix generator (YCSB-style).

The port's copy of ``repro/workloads/generator.py`` over the port's
``OpBatch``: the same spec gives the same op stream, bit for bit, as the
JAX package's generator (``tests/test_torch_nbtree.py``), so the two
engines can be driven by one stream.

A :class:`WorkloadSpec` names an operation mix (per-kind probabilities), a
key distribution (uniform, zipfian, or a moving zipfian hotspot over a
bounded key space), a range selectivity and sizes.  Keys live in
``[1, key_space]`` with ``key_space + range span < 2^31`` and values are an
increasing non-negative counter below 2^31, so freshest-copy-wins is
observable.  Zipfian draws use the bounded power-law inverse CDF and
scatter ranks over the key space with splitmix64 (YCSB's hashed key order).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.engine_api import OpBatch, OpKind
from ..core.splitmix import splitmix64 as _splitmix64

#: named operation mixes (probabilities per op kind).
MIXES: dict = {
    # the paper's own regime: ingestion-dominated with occasional reads.
    "insert-heavy":    {OpKind.INSERT: 0.95, OpKind.QUERY: 0.05},
    "point-read-heavy": {OpKind.INSERT: 0.05, OpKind.QUERY: 0.95},
    "range-heavy":     {OpKind.INSERT: 0.05, OpKind.RANGE: 0.95},
    # YCSB-style blends (A: update-heavy, B: read-mostly, E: short scans);
    # updates are inserts on existing keys (blind writes), as in YCSB.
    "ycsb-a":          {OpKind.INSERT: 0.50, OpKind.QUERY: 0.50},
    "ycsb-b":          {OpKind.INSERT: 0.05, OpKind.QUERY: 0.95},
    "ycsb-e":          {OpKind.INSERT: 0.05, OpKind.RANGE: 0.95},
    # tombstone churn: exercises delta-record deletion.
    "delete-churn":    {OpKind.INSERT: 0.45, OpKind.DELETE: 0.25,
                        OpKind.QUERY: 0.25, OpKind.RANGE: 0.05},
    # moving hotspot: insert-dominated zipfian mass inside a narrow window
    # that sweeps across the key space over the stream.
    "hotspot-shift":   {OpKind.INSERT: 0.80, OpKind.QUERY: 0.15,
                        OpKind.RANGE: 0.05},
}

#: mixes that default to a skewed key distribution (YCSB's default).
_ZIPF_BY_DEFAULT = ("ycsb-a", "ycsb-b", "ycsb-e")

#: mixes that default to the moving-hotspot distribution.
_HOTSPOT_BY_DEFAULT = ("hotspot-shift",)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    mix: dict                      # OpKind -> probability, sums to 1
    dist: str = "uniform"          # "uniform" | "zipfian" | "hotspot"
    theta: float = 0.8             # zipfian skew (0 = uniform, <1)
    key_space: int = 1 << 24       # keys drawn from [1, key_space]
    #: "hotspot" dist: fraction of draws inside the moving hot window and
    #: the window's width as a fraction of the key space; the window's base
    #: sweeps the key space linearly with stream progress.
    hotspot_frac: float = 0.9
    hotspot_width: float = 0.05
    range_selectivity: float = 1e-3
    preload: int = 4096            # distinct keys loaded before the mix runs
    n_ops: int = 8192
    batch_size: int = 256
    seed: int = 0
    #: emit each batch's ops grouped by kind (INSERT, DELETE, QUERY, RANGE),
    #: so the device tier serves a batch in <= 4 calls.
    group_kinds: bool = True

    def __post_init__(self):
        total = sum(self.mix.values())
        if abs(total - 1.0) >= 1e-9:
            raise ValueError(f"mix must sum to 1, got {total}")
        if self.key_space + self.range_span >= (1 << 31):
            raise ValueError("key_space + range span must stay below 2^31 "
                             "(uint32 device tier)")
        if not 0.0 <= self.theta < 1.0:
            raise ValueError(f"theta {self.theta} outside [0, 1)")
        if self.dist not in ("uniform", "zipfian", "hotspot"):
            raise ValueError(f"unknown dist {self.dist!r}")
        if not (0.0 <= self.hotspot_frac <= 1.0
                and 0.0 < self.hotspot_width <= 1.0):
            raise ValueError("hotspot_frac / hotspot_width out of range")

    @property
    def range_span(self) -> int:
        return max(1, int(self.key_space * self.range_selectivity))


def make_workload(mix_name: str, **overrides) -> "Workload":
    """Build a workload from a named mix; keyword overrides win."""
    mix = MIXES[mix_name]
    if mix_name in _ZIPF_BY_DEFAULT:
        overrides.setdefault("dist", "zipfian")
    if mix_name in _HOTSPOT_BY_DEFAULT:
        overrides.setdefault("dist", "hotspot")
    return Workload(WorkloadSpec(name=mix_name, mix=mix, **overrides))


class Workload:
    """Expands a :class:`WorkloadSpec` into deterministic OpBatch streams."""

    def __init__(self, spec: WorkloadSpec):
        self.spec = spec

    def _zipf_ranks(self, rng: np.random.Generator, n: int,
                    space: int) -> np.ndarray:
        """Zipfian ranks in [0, space) via the bounded power-law inverse CDF."""
        u = rng.random(n)
        g = 1.0 - self.spec.theta
        ranks = ((u * (float(space) ** g - 1.0)) + 1.0) ** (1.0 / g)
        return np.minimum(ranks.astype(np.uint64), np.uint64(space)) - 1

    def _draw_keys(self, rng: np.random.Generator, n: int,
                   progress: float = 0.0) -> np.ndarray:
        space = self.spec.key_space
        if self.spec.dist == "zipfian" and self.spec.theta > 0.0:
            ranks = self._zipf_ranks(rng, n, space)
            # scatter hot ranks over the key space (YCSB hashed key order).
            return (_splitmix64(ranks) % np.uint64(space)) + np.uint64(1)
        if self.spec.dist == "hotspot":
            width = max(1, int(space * self.spec.hotspot_width))
            base = int(progress * (space - 1))          # 0-based sweep
            hot = rng.random(n) < self.spec.hotspot_frac
            offs = self._zipf_ranks(rng, n, width)      # clustered near 0
            cold = rng.integers(0, space, n, dtype=np.uint64)
            keys0 = np.where(
                hot, (np.uint64(base) + offs) % np.uint64(space), cold)
            return keys0 + np.uint64(1)
        return rng.integers(1, space + 1, n, dtype=np.uint64)

    def preload_batch(self) -> OpBatch:
        """Distinct-key initial load (YCSB load phase), deterministic."""
        spec = self.spec
        keys = (_splitmix64(np.arange(spec.preload, dtype=np.uint64))
                % np.uint64(spec.key_space)) + np.uint64(1)
        keys = np.unique(keys)[: spec.preload]       # drop rare collisions
        vals = np.arange(1, len(keys) + 1, dtype=np.int64)
        return OpBatch.inserts(keys, vals)

    def batches(self):
        """Yield the mixed-op stream, ``batch_size`` ops per OpBatch."""
        spec = self.spec
        rng = np.random.default_rng(spec.seed)
        kinds_pool = np.array([int(k) for k in spec.mix], np.int8)
        probs = np.array([spec.mix[OpKind(int(k))] for k in kinds_pool])
        val_counter = spec.preload + 1
        emitted = 0
        while emitted < spec.n_ops:
            b = min(spec.batch_size, spec.n_ops - emitted)
            kinds = rng.choice(kinds_pool, b, p=probs).astype(np.int8)
            if spec.group_kinds:
                kinds = kinds[np.argsort(kinds, kind="stable")]
            keys = self._draw_keys(rng, b, progress=emitted / spec.n_ops)
            vals = np.zeros(b, np.int64)
            his = np.zeros(b, np.uint64)
            ins = kinds == int(OpKind.INSERT)
            n_ins = int(ins.sum())
            # increasing int32-safe values: freshest-wins is observable.
            vals[ins] = (np.arange(val_counter, val_counter + n_ins)
                         % ((1 << 31) - 1))
            val_counter += n_ins
            rng_mask = kinds == int(OpKind.RANGE)
            his[rng_mask] = keys[rng_mask] + np.uint64(spec.range_span)
            yield OpBatch(kinds, keys, vals, his)
            emitted += b
