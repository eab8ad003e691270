"""Serving steps (prefill and decode) over a port ``Transformer``.

The port of ``repro/serve/steps.py``'s token paths (the encoder-only step
is not ported: ROADMAP.md, queue 1, item 9g).  These are the entry
points of every ported arch; the MoE and MLA stacks decode only here (the
paged engine serves dense and swa stacks, as the reference's).
"""
from __future__ import annotations

import torch


def make_prefill_step(cfg, cache_len: int):
    """(model, {"tokens"}) -> (last_logits (B,1,V), cache)."""
    def prefill(model, batch):
        logits, _aux, cache = model(batch["tokens"], build_cache_len=cache_len,
                                    last_logit_only=True)
        return logits, cache
    return prefill


def make_serve_step(cfg):
    """One decode step: (model, cache, tokens (B,), index) -> (next, cache).

    Greedy argmax here; the engine layer samples (serve/engine.py).
    """
    def serve_step(model, cache, tokens, index):
        logits, new_cache = model.decode_step(tokens, cache, index)
        return torch.argmax(logits, dim=-1).to(torch.int32), new_cache
    return serve_step
