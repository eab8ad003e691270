"""Continuous-batching serving engine over the NB-tree paged KV cache.

The port of ``repro/serve/engine.py``: the paper's index as the
allocator/indexing layer of an LM server.

  * admission: waiting requests claim decode slots as batches finish;
  * prefill: full-sequence forward (``Transformer.forward``) whose
    per-position KV is scattered into *pages* through the NB-tree index;
  * decode: every step builds block tables by a batched NB-tree query and
    attends with the hand-written ``paged_attention`` kernel
    (``kernels/ops.py``; the plain version on CPU tensors);
  * upkeep: ``cache.maintain(2)`` runs each step: bounded index work per
    step (deamortization).

Where the JAX engine descends the page index once per written position
and layer (prefill: S x L descents; decode: L per step), the port looks a
batch's write slots up once (one descent for all B x S prefill positions,
one per decode step) and scatters per layer.  No index write happens
between those lookups, so the pages written are the same.

The paged decoder serves ``dense`` and ``swa`` stacks, as the JAX
engine's does; MoE, MLA, recurrent and hybrid stacks decode through
``serve/steps.py``, where an encoder-only stack encodes.  On
``swa`` layers the paged decode attends over every position with no
window, as the JAX engine does (its prefill is windowed); the contiguous
``decode_step`` applies the window (ROADMAP.md §3 records the gap).
The decode applies plain RoPE, as the JAX engine does; for an M-RoPE
config (qwen2-vl-2b) over text positions that equals M-RoPE bit for bit.

Pages stay fp32 whatever the model dtype, as in the JAX engine.  The
decoder times its page-index work per decode step (``index_s``), the
engine its prefills and steps (``prefill_s``, ``step_s``), on the host
clock; a step's time ends when its tokens reach the host.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..kernels import ops
from ..models.layers import apply_norm, mlp, project_qkv, rope_angles
from .kv_cache import PagedKVCache

INDEX_PARTS = ("extend", "maintain", "block_tables", "lookup")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


#: block kinds the paged decoder serves (the JAX engine's)
PAGED_KINDS = ("dense", "swa")


class PagedDecoder:
    """Single-token decode for dense/swa stacks over paged KV."""

    def __init__(self, cfg, model, cache: PagedKVCache):
        if any(k not in PAGED_KINDS for k, _ in cfg.segments):
            raise ValueError(f"{cfg.name}: the paged decode path supports "
                             f"attention backbones ({'/'.join(PAGED_KINDS)} "
                             f"blocks), not {cfg.segments}")
        self.cfg, self.model, self.cache = cfg, model, cache
        #: host seconds of page-index work per decode step, by part
        self.index_s: dict[str, list[float]] = {k: [] for k in INDEX_PARTS}
        self.last_logits = None

    @torch.no_grad()
    def prefill(self, seq_ids, tokens):
        """tokens (B, S) -> runs forward, writes all KV into pages."""
        B, S = tokens.shape
        seq_ids = np.asarray(seq_ids)
        for sid in seq_ids:
            self.cache.extend(int(sid), S)
        logits, _aux, kv_cache = self.model(tokens, build_cache_len=S,
                                            last_logit_only=True)
        if any(c["k"].shape[1] != S for c in kv_cache):
            raise ValueError(
                f"a {S}-token prompt is past an swa layer's prefill ring of "
                f"window + 128 = {self.cfg.swa_window + 128} slots; the paged "
                "prefill copies every prompt position (the JAX engine "
                "cannot serve it either)")
        pages, slots = self.cache.lookup(seq_ids[:, None],
                                         np.arange(S)[None, :])
        for li, c in enumerate(kv_cache):
            self.cache.write_slots(li, pages, slots, c["k"], c["v"])
        self.cache.maintain(4)
        return torch.argmax(logits[:, -1], -1).to(torch.int32)

    @torch.no_grad()
    def decode(self, seq_ids, tokens, position: int):
        """One decode step for all sequences at the same position."""
        cfg, cache, model = self.cfg, self.cache, self.model
        B = tokens.shape[0]
        seq_ids = np.asarray(seq_ids)
        t0 = time.perf_counter()
        for sid in seq_ids:
            cache.extend(int(sid), position + 1)
        t1 = time.perf_counter()
        cache.maintain(2)
        t2 = time.perf_counter()
        tables = cache.block_tables(seq_ids, -(-(position + 1) // cache.S))
        t3 = time.perf_counter()
        pages, slots = cache.lookup(seq_ids, np.full(B, position))
        t4 = time.perf_counter()
        for part, dt in zip(INDEX_PARTS, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            self.index_s[part].append(dt)

        dev = model.device
        lens = torch.full((B,), position + 1, dtype=torch.int32, device=dev)
        x = model.embed[tokens.long()][:, None, :]
        positions = torch.full((B, 1), position, dtype=torch.int32, device=dev)
        hd, kvh = cfg.resolved_head_dim, cfg.n_kv_heads
        cos, sin = rope_angles(positions, hd, cfg.rope_base)
        for li, blk in enumerate(model.layers):
            h = apply_norm(x, blk.norm1, cfg.norm_kind, cfg.norm_eps)
            q, k, v = project_qkv(h, blk.attn, cfg, cos, sin)
            cache.write_slots(li, pages, slots, k[:, 0], v[:, 0])
            kp, vp = cache.layer_pages(li)
            qh = q[:, 0].reshape(B, kvh, cfg.n_heads // kvh, hd)
            out = ops.paged_attention(qh, kp, vp, tables, lens)
            x = x + out.reshape(B, 1, cfg.n_heads * hd) @ blk.attn.wo
            h2 = apply_norm(x, blk.norm2, cfg.norm_kind, cfg.norm_eps)
            x = x + mlp(h2, blk.mlp, cfg.mlp_kind)
        x = apply_norm(x, model.final_norm, cfg.norm_kind, cfg.norm_eps)
        self.last_logits = (x[:, 0] @ model.unembed_weight()).float()
        return torch.argmax(self.last_logits, -1).to(torch.int32)


class Engine:
    """Minimal continuous-batching loop (same-length prompts batched)."""

    def __init__(self, cfg, model, *, max_batch: int = 4, n_pages: int = 512,
                 page_size: int = 16):
        self.cfg, self.model = cfg, model
        self.max_batch = max_batch
        self.cache = PagedKVCache(cfg.n_layers, cfg.n_kv_heads,
                                  cfg.resolved_head_dim,
                                  n_pages=n_pages, page_size=page_size,
                                  dtype=torch.float32, device=model.device)
        self.decoder = PagedDecoder(cfg, model, self.cache)
        self._next_sid = 0
        self.prefill_s: list[float] = []
        self.step_s: list[float] = []

    def run(self, requests: list[Request]) -> list[Request]:
        """Serve a request list to completion (same-length prompts batched)."""
        queue = list(requests)
        while queue:
            batch = queue[: self.max_batch]
            queue = queue[self.max_batch:]
            sids = []
            for _ in batch:
                sid = self._next_sid
                self._next_sid += 1
                self.cache.add_sequence(sid)
                sids.append(sid)
            sids = np.asarray(sids)
            toks = torch.tensor([r.prompt for r in batch], dtype=torch.long,
                                device=self.model.device)
            S = toks.shape[1]
            t0 = time.perf_counter()
            nxt = self.decoder.prefill(sids, toks)
            for r, t in zip(batch, nxt.tolist()):
                r.out.append(t)
            self.prefill_s.append(time.perf_counter() - t0)
            steps = max(r.max_new_tokens for r in batch) - 1
            for s in range(steps):
                t0 = time.perf_counter()
                nxt = self.decoder.decode(sids, nxt, S + s)
                for r, t in zip(batch, nxt.tolist()):
                    if len(r.out) < r.max_new_tokens:
                        r.out.append(t)
                self.step_s.append(time.perf_counter() - t0)
            for r, sid in zip(batch, sids):
                r.done = True
                self.cache.free_sequence(int(sid))
        return requests
