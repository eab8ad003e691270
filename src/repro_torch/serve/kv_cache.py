"""Paged KV cache with an NB-tree block index (the paper -> serving bridge).

The port of ``repro/serve/kv_cache.py``.  vLLM-style paging: physical KV
pages are rows of (L, KVH, P, S, D) tensors on the card; the *logical ->
physical* page mapping is the port's NB-tree
(``core/torch_nbtree.NBTreeIndex``) keyed by pack(seq_id, logical_block):

  * decode inserts one mapping per sequence per S tokens: the paper's
    insertion-intensive workload, at engine rate;
  * block tables and write slots are batched NB-tree queries (Bloom-gated
    descent through the port's kernels);
  * ``maintain(budget)`` runs per engine step with a bounded unit budget:
    index upkeep never stalls a serve step beyond the budget.

Page ids equal the JAX cache's for the same call sequence: page 0 is the
null page, and the free list pops in the same order.  Writes scatter with
explicit index tensors: ``k_pages[layer, :, pages, slots] = k`` would put
the KV-head axis first under PyTorch's indexing rules (numpy puts the
batch axis first), a transpose that goes unseen when B == KVH.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.torch_nbtree import NBTreeIndex
from ..device import resolve_device

SEQ_BITS = 18
BLOCK_BITS = 32 - SEQ_BITS
MAX_BLOCKS_PER_SEQ = (1 << BLOCK_BITS) - 1


def pack_key(seq_id, block) -> np.ndarray:
    seq_id = np.asarray(seq_id, np.uint32)
    block = np.asarray(block, np.uint32)
    assert (block < MAX_BLOCKS_PER_SEQ).all()
    return (seq_id << np.uint32(BLOCK_BITS)) | block


class PagedKVCache:
    def __init__(self, n_layers: int, n_kv_heads: int, head_dim: int, *,
                 n_pages: int = 256, page_size: int = 16,
                 dtype=torch.bfloat16, f: int = 4, sigma: int = 2048,
                 device=None):
        self.device = resolve_device(device)
        self.L, self.KVH, self.D = n_layers, n_kv_heads, head_dim
        self.P, self.S = n_pages, page_size
        shape = (n_layers, n_kv_heads, n_pages, page_size, head_dim)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        # page 0 is reserved as the null page (masked-out reads land there).
        self.free = list(range(n_pages - 1, 0, -1))
        self.index = NBTreeIndex(f=f, sigma=sigma, device=self.device)
        self.seq_len: dict[int, int] = {}
        self._heads = torch.arange(n_kv_heads, device=self.device)

    # ------------------------------------------------------------- allocation
    def add_sequence(self, seq_id: int, length: int = 0) -> None:
        assert seq_id not in self.seq_len
        self.seq_len[seq_id] = 0
        if length:
            self.extend(seq_id, length)

    def extend(self, seq_id: int, new_len: int) -> list[int]:
        """Ensure pages exist to hold ``new_len`` tokens; returns new pages."""
        have = -(-self.seq_len[seq_id] // self.S) if self.seq_len[seq_id] else 0
        need = -(-new_len // self.S)
        fresh = []
        for b in range(have, need):
            if not self.free:
                raise RuntimeError("KV cache out of pages (preemption needed)")
            fresh.append((b, self.free.pop()))
        if fresh:
            keys = pack_key(seq_id, np.asarray([b for b, _ in fresh]))
            vals = np.asarray([p for _, p in fresh], np.int32)
            self.index.insert_batch(keys, vals)
        self.seq_len[seq_id] = new_len
        return [p for _, p in fresh]

    def free_sequence(self, seq_id: int) -> None:
        n_blocks = -(-self.seq_len[seq_id] // self.S)
        if n_blocks:
            keys = pack_key(seq_id, np.arange(n_blocks))
            present, pages = self.index.query_batch(keys)
            self.free.extend(pages[present].tolist())
            self.index.delete_batch(keys)
        del self.seq_len[seq_id]

    def maintain(self, budget: int = 2) -> int:
        """Bounded per-step index upkeep (deamortization)."""
        return self.index.maintain(budget)

    # ------------------------------------------------------------ block table
    def block_tables(self, seq_ids, max_pages: int) -> torch.Tensor:
        """(B, max_pages) int32 physical page table for paged_attention."""
        seq_ids = np.asarray(seq_ids)
        keys = pack_key(seq_ids[:, None], np.arange(max_pages)[None, :]).reshape(-1)
        present, pages = self.index.query_batch(keys)
        table = torch.where(present, pages, 0).reshape(len(seq_ids), max_pages)
        return table.to(torch.int32)

    def seq_lens(self, seq_ids) -> torch.Tensor:
        """(B,) int32 token counts of ``seq_ids``, on the cache's device."""
        return torch.tensor([self.seq_len[int(s)] for s in np.asarray(seq_ids)],
                            dtype=torch.int32, device=self.device)

    # ---------------------------------------------------------------- writes
    def lookup(self, seq_ids, positions):
        """Physical (page, slot) of each (seq_ids[i], positions[i]), one
        descent for the whole batch; any shape, broadcast together."""
        seq_ids, positions = np.broadcast_arrays(np.asarray(seq_ids),
                                                 np.asarray(positions))
        keys = pack_key(seq_ids, positions // self.S).reshape(-1)
        present, pages = self.index.query_batch(keys)
        assert bool(present.all()), "write to unallocated block"
        slots = torch.from_numpy(np.ascontiguousarray(positions % self.S))
        return (pages.long().reshape(positions.shape),
                slots.to(self.device).reshape(positions.shape))

    def write_slots(self, layer: int, pages, slots, k, v) -> None:
        """Scatter k/v (*batch, KVH, D) into ``layer`` at (pages, slots) of
        shape (*batch): element [..., h, :] lands in head h's page row."""
        idx = (self._heads, pages[..., None], slots[..., None])
        self.k_pages[layer].index_put_(idx, k.to(self.k_pages.dtype))
        self.v_pages[layer].index_put_(idx, v.to(self.v_pages.dtype))

    def write_token(self, layer: int, seq_ids, positions, k, v) -> None:
        """Write per-sequence new-token KV: k/v (B, KVH, D) at ``positions``."""
        pages, slots = self.lookup(seq_ids, positions)
        self.write_slots(layer, pages, slots, k, v)

    def layer_pages(self, layer: int):
        return self.k_pages[layer], self.v_pages[layer]
