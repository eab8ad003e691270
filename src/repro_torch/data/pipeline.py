"""Streaming data pipeline with an NB-tree ingest index (the port's copy of
``repro/data/pipeline.py``, over the port's ``core/refimpl.NBTree``).

The training-side application of the paper: examples arrive at a high,
sustained rate (log streams, user events — the paper's Facebook/Nasdaq
motivation) and must be (a) ingested with bounded per-record latency,
(b) deduplicated, (c) queryable for batch assembly — exactly the
insert-intensive + point-query profile the NB-tree targets.

``StreamingIngest`` indexes sample-hash -> store offset in a host NB-tree
(refimpl, zero-cost instance); duplicates are dropped via index queries
before they reach the store.  ``PackedBatches`` draws indexed samples into
fixed (B, S) token batches for the trainer.  Synthetic deterministic data
keeps everything reproducible offline.  Everything here is numpy: the
batches are numpy arrays, which the trainer moves to its device.
"""
from __future__ import annotations

import numpy as np

from ..core.cost_model import CostModel, Device
from ..core.refimpl import NBTree

_NULL = Device("null", 4096, 0.0, 1e18, 1e18)


def _mix64(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(33))) * np.uint64(0xFF51AFD7ED558CCD)
        x = (x ^ (x >> np.uint64(33))) * np.uint64(0xC4CEB9FE1A85EC53)
        return x ^ (x >> np.uint64(33))


def synthetic_documents(n_docs: int, doc_len: int, vocab: int, seed: int = 0):
    """Deterministic token documents (hash-chain PRNG, no RNG state)."""
    base = _mix64(np.arange(n_docs, dtype=np.uint64) + np.uint64(seed * 1_000_003))
    pos = np.arange(doc_len, dtype=np.uint64)
    toks = _mix64(base[:, None] * np.uint64(0x9E3779B97F4A7C15) + pos[None, :])
    return (toks % np.uint64(max(2, vocab - 2))).astype(np.int32) + 1


class StreamingIngest:
    """High-rate ingest with dedup; bounded per-record index latency."""

    def __init__(self, sigma: int = 4096, f: int = 4):
        self.index = NBTree(f=f, sigma=sigma, cost=CostModel(_NULL))
        self.store: list[np.ndarray] = []
        self.dups = 0

    def ingest(self, doc: np.ndarray) -> bool:
        """Returns True if stored, False if deduplicated."""
        key = np.uint64(_mix64(np.asarray(doc[: 32], np.uint64)).sum())
        if self.index.get(key) is not None:
            self.dups += 1
            return False
        self.index.insert(key, len(self.store))
        self.store.append(doc)
        return True

    def __len__(self):
        return len(self.store)

    def get_by_hash(self, key) -> np.ndarray | None:
        off = self.index.get(key)
        return None if off is None else self.store[int(off)]


class PackedBatches:
    """Iterator of {tokens: (B, S)} batches packed from the ingest store."""

    def __init__(self, ingest: StreamingIngest, batch: int, seq_len: int,
                 seed: int = 0):
        self.ingest, self.B, self.S = ingest, batch, seq_len
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self):
        docs = self.ingest.store
        if not docs:
            raise StopIteration
        rows = []
        for _ in range(self.B):
            buf = np.empty(0, np.int32)
            while len(buf) < self.S + 1:
                d = docs[int(self.rng.integers(len(docs)))]
                buf = np.concatenate([buf, d])
            rows.append(buf[: self.S + 1])
        toks = np.stack(rows)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
