"""The one traffic generator: a mix file of parameters in, op batches out.

A mix (``nbbench/mixes/<name>.json``) names YCSB core-workload properties:
the ops of a batch and their shares, the insert order, the zipfian
constant of the requests, the scan lengths, and whether the
configuration's ``recordcount`` records are loaded before the window.  A
configuration (``nbbench/configs/<name>.json``) gives the record count and
the key space.  Everything is drawn from the run's seed: the same seed gives
the same batches, whatever order they are asked for in.

Records and keys.  Record ``i`` is the ``i``-th record ever inserted.  Its
key is ``scramble(i) + 1`` in YCSB's hashed insert order, a bijection of
``[0, key_space)`` keyed by the seed (in place of YCSB's FNV hash, so keys
never collide), or ``i + 1`` in the ordered one.  Values are int32 record
references drawn from the seed.

Ops.  Each batch holds the same number of each op (shares times the batch,
largest remainder), grouped as the engine serves them: writes (inserts of
new records, then updates of loaded ones), reads, scans.  Reads, updates and
scans pick a loaded record by YCSB's scrambled zipfian.  A scan covers
``L`` records, ``L`` uniform in ``[scan_length_min, scan_length_max]``: its
bounds are the start record's key and the key ``L - 1`` places after it in
the loaded table.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: op codes of a batch's ``kinds``: the values of the program's ``OpKind``
WRITE, READ, SCAN = 0, 2, 3
#: batches generated together (one seed stream each)
CHUNK = 64
#: numpy stream ids under the run's seed
_PRELOAD, _STREAM, _WARMUP = 1, 2, 3
_MASK64 = (1 << 64) - 1
_OPS = ("insert", "update", "read", "scan")


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Frozen copy of ``repro_torch/core/splitmix.py::splitmix64``."""
    x = np.asarray(x).astype(np.uint64)
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def zipf_ranks(rng: np.random.Generator, n, space: int,
               theta: float) -> np.ndarray:
    """Zipfian ranks in ``[0, space)`` by the bounded power-law inverse CDF
    (frozen copy of ``Workload._zipf_ranks`` in
    ``repro_torch/workloads/generator.py``, with the constant passed in)."""
    u = rng.random(n)
    g = 1.0 - theta
    ranks = ((u * (float(space) ** g - 1.0)) + 1.0) ** (1.0 / g)
    return np.minimum(ranks.astype(np.uint64), np.uint64(space)) - 1


class KeyMap:
    """Record number -> key: a seed-keyed bijection of ``[0, 2^bits)``
    (odd multiplies and right xorshifts, each invertible mod 2^bits), plus
    one; or the record number plus one in the ordered insert order."""

    def __init__(self, key_space: int, seed: int, ordered: bool):
        bits = key_space.bit_length() - 1
        if key_space != 1 << bits or not 8 <= bits <= 32:
            raise ValueError(f"key_space {key_space} must be 2^8..2^32")
        self.bits, self.ordered = bits, ordered
        words = splitmix64(np.arange(4, dtype=np.uint64)
                           + np.uint64((seed * 4) & _MASK64))
        self._mul = [int(w) | 1 for w in words[:3]]
        self._add = int(words[3])

    def __call__(self, records) -> np.ndarray:
        x = np.asarray(records, np.uint64)
        if self.ordered:
            return x + np.uint64(1)
        mask, b = np.uint64((1 << self.bits) - 1), self.bits
        x = (x * np.uint64(self._mul[0]) + np.uint64(self._add)) & mask
        x ^= x >> np.uint64(b // 2)
        x = (x * np.uint64(self._mul[1])) & mask
        x ^= x >> np.uint64(b // 3 + 1)
        x = (x * np.uint64(self._mul[2])) & mask
        x ^= x >> np.uint64(b // 2)
        return x + np.uint64(1)


@dataclasses.dataclass
class Batch:
    """One batch of ops, parallel arrays: ``kinds`` (op codes), ``keys``
    (a scan's low bound), ``vals`` (a write's value), ``his`` (a scan's
    inclusive high bound)."""

    kinds: np.ndarray   # int8
    keys: np.ndarray    # uint64
    vals: np.ndarray    # int64
    his: np.ndarray     # uint64

    def __len__(self) -> int:
        return len(self.kinds)


def per_batch_counts(batch: int, shares: dict) -> dict:
    """Ops of each kind in a batch: shares times the batch, rounded by
    largest remainder so that they sum to the batch."""
    unknown = set(shares) - set(_OPS)
    if unknown:
        raise ValueError(f"unknown ops {sorted(unknown)}; known: {_OPS}")
    if abs(sum(shares.values()) - 1.0) > 1e-9:
        raise ValueError(f"op shares must sum to 1, got {shares}")
    exact = {k: shares.get(k, 0.0) * batch for k in _OPS}
    counts = {k: int(np.floor(v)) for k, v in exact.items()}
    left = batch - sum(counts.values())
    for k in sorted(_OPS, key=lambda k: counts[k] - exact[k])[:left]:
        counts[k] += 1
    return counts


class Traffic:
    """Batches of one mix over one configuration, drawn from ``seed``."""

    def __init__(self, config: dict, mix: dict, seed: int):
        self.seed = int(seed)
        self.batch_size = int(mix["batch"])
        self.counts = per_batch_counts(self.batch_size, mix["ops"])
        self.preload = bool(mix.get("preload", False))
        self.preload_batch = int(mix.get("preload_batch", 4096))
        self.recordcount = int(config["recordcount"]) if self.preload else 0
        self.key_space = int(config["key_space"])
        self.theta = float(mix.get("zipfian_constant", 0.99))
        self.scan_min = int(mix.get("scan_length_min", 1))
        self.scan_max = int(mix.get("scan_length_max", 100))
        self.prefetch_batches = int(mix.get("prefetch_batches", 0))
        self.warmup_batches = int(mix.get("warmup_batches", 0))
        self.keymap = KeyMap(self.key_space, self.seed,
                             mix.get("insert_order", "hashed") == "ordered")
        c = self.counts
        self.writes = c["insert"] + c["update"]
        if (c["read"] or c["scan"] or c["update"]) and not self.recordcount:
            raise ValueError("reads, scans and updates pick loaded records: "
                             "the mix must preload")
        if not 1 <= self.scan_min <= self.scan_max:
            raise ValueError("scan lengths must satisfy 1 <= min <= max")
        self._chunks: dict = {}
        self._sorted_keys = None

    # ------------------------------------------------------------- records
    @property
    def has_writes(self) -> bool:
        return self.writes > 0

    def sorted_loaded_keys(self) -> np.ndarray:
        """The loaded table's keys in key order (a scan's bounds)."""
        if self._sorted_keys is None:
            self._sorted_keys = np.sort(
                self.keymap(np.arange(self.recordcount, dtype=np.uint64)))
        return self._sorted_keys

    def _values(self, rng, shape) -> np.ndarray:
        return rng.integers(0, (1 << 31) - 1, shape, dtype=np.int64)

    def _choose(self, rng, shape) -> np.ndarray:
        """Loaded records by YCSB's scrambled zipfian: a zipfian rank,
        scattered over the records by splitmix64."""
        ranks = zipf_ranks(rng, shape, self.recordcount, self.theta)
        return splitmix64(ranks) % np.uint64(self.recordcount)

    def preload_batches(self):
        """``(keys, vals)`` of the load, record order, ``preload_batch`` at
        a time; record ``i`` is written at time ``i``."""
        step = self.preload_batch
        for c, start in enumerate(range(0, self.recordcount, step)):
            stop = min(start + step, self.recordcount)
            rng = np.random.default_rng([self.seed, _PRELOAD, c])
            yield (self.keymap(np.arange(start, stop, dtype=np.uint64)),
                   self._values(rng, stop - start))

    # --------------------------------------------------------------- batches
    def _chunk(self, c: int, stream: int) -> list:
        """Batches ``c * CHUNK ..`` of one stream, generated together."""
        rng = np.random.default_rng([self.seed, stream, c])
        cnt, n = self.counts, CHUNK
        t = np.arange(c * n, (c + 1) * n, dtype=np.uint64)
        first = np.uint64(self.recordcount) + t * np.uint64(cnt["insert"])
        ins = self.keymap((first[:, None] + np.arange(cnt["insert"],
                                                      dtype=np.uint64))
                          % np.uint64(self.key_space))
        ins_v = self._values(rng, (n, cnt["insert"]))
        upd = self.keymap(self._choose(rng, (n, cnt["update"])))
        upd_v = self._values(rng, (n, cnt["update"]))
        rd = self.keymap(self._choose(rng, (n, cnt["read"])))
        lo_rec = self._choose(rng, (n, cnt["scan"]))
        length = rng.integers(self.scan_min, self.scan_max + 1,
                              (n, cnt["scan"]))
        lo = self.keymap(lo_rec)
        hi = lo
        if cnt["scan"]:
            sk = self.sorted_loaded_keys()
            pos = np.searchsorted(sk, lo)
            hi = sk[np.minimum(pos + length - 1, len(sk) - 1)]
        kinds = np.concatenate([
            np.full(self.writes, WRITE, np.int8),
            np.full(cnt["read"], READ, np.int8),
            np.full(cnt["scan"], SCAN, np.int8)])
        zeros_k = np.zeros(cnt["read"], np.uint64)
        out = []
        for i in range(n):
            keys = np.concatenate([ins[i], upd[i], rd[i], lo[i]])
            vals = np.concatenate([ins_v[i], upd_v[i],
                                   np.zeros(cnt["read"] + cnt["scan"],
                                            np.int64)])
            his = np.concatenate([np.zeros(self.writes, np.uint64), zeros_k,
                                  hi[i]])
            out.append(Batch(kinds, keys, vals, his))
        return out

    def batch(self, t: int) -> Batch:
        """Batch ``t`` of the window's stream."""
        c = t // CHUNK
        if c not in self._chunks:
            self._chunks[c] = self._chunk(c, _STREAM)
        return self._chunks[c][t % CHUNK]

    def warmup(self) -> list:
        """``warmup_batches`` batches of the mix's own shapes from a stream
        of their own (for a throwaway engine)."""
        out: list = []
        c = 0
        while len(out) < self.warmup_batches:
            out += self._chunk(c, _WARMUP)
            c += 1
        return out[: self.warmup_batches]

    def prefetch(self) -> int:
        """Generate the first ``prefetch_batches`` batches (set-up)."""
        n = self.prefetch_batches
        for t in range(0, n, CHUNK):
            self.batch(t)
        return n

    def op_time(self, t: int) -> int:
        """Time of batch ``t``'s first op: ops are numbered from the load's
        first record, one per op, batch after batch."""
        return self.recordcount + t * self.batch_size
