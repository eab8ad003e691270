"""Bloom filters (paper Sec. 5.2) — host (numpy) implementation; the
port's copy of ``repro/core/bloom.py``, used by the host NB-tree
(``refimpl``).

One filter per d-tree; k bits/key and h hash functions.  The paper's
configuration (k=8, h=3 → <5% FP; experiments use 10 bits/key) is the
default.  Hashing is multiply-shift over uint64 keys (the device tier's
``bloom_filter`` kernel hashes uint32 keys with its own constants).
"""
from __future__ import annotations

import numpy as np

# odd 64-bit multipliers (splitmix64 / Murmur finalizer constants).
_MULTS = np.array(
    [
        0xFF51AFD7ED558CCD,
        0xC4CEB9FE1A85EC53,
        0x9E3779B97F4A7C15,
        0xBF58476D1CE4E5B9,
        0x94D049BB133111EB,
        0x2545F4914F6CDD1D,
    ],
    dtype=np.uint64,
)


def _hashes(keys: np.ndarray, h: int, nbits: int) -> np.ndarray:
    """(h, n) array of bit positions in [0, nbits)."""
    keys = keys.astype(np.uint64)[None, :]
    m = _MULTS[:h, None]
    with np.errstate(over="ignore"):
        x = keys * m
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xC2B2AE3D27D4EB4F)
        x ^= x >> np.uint64(29)
    return (x % np.uint64(nbits)).astype(np.int64)


class BloomFilter:
    def __init__(self, capacity: int, bits_per_key: int = 10, num_hashes: int = 3):
        self.nbits = max(64, int(capacity * bits_per_key))
        self.h = num_hashes
        self.bits = np.zeros((self.nbits + 63) // 64, dtype=np.uint64)

    @property
    def size_bytes(self) -> int:
        return self.bits.nbytes

    def add(self, keys: np.ndarray) -> None:
        keys = np.atleast_1d(np.asarray(keys, dtype=np.uint64))
        if keys.size == 0:
            return
        pos = _hashes(keys, self.h, self.nbits).ravel()
        np.bitwise_or.at(self.bits, pos >> 6, np.uint64(1) << (pos & 63).astype(np.uint64))

    def contains(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized membership test → bool array (no false negatives)."""
        keys = np.atleast_1d(np.asarray(keys, dtype=np.uint64))
        if keys.size == 0:
            return np.zeros(0, bool)
        pos = _hashes(keys, self.h, self.nbits)  # (h, n)
        word = self.bits[pos >> 6]
        bit = (word >> (pos & 63).astype(np.uint64)) & np.uint64(1)
        return bit.all(axis=0) == 1

    @staticmethod
    def build(keys: np.ndarray, bits_per_key: int = 10, num_hashes: int = 3) -> "BloomFilter":
        bf = BloomFilter(max(1, len(keys)), bits_per_key, num_hashes)
        bf.add(keys)
        return bf
