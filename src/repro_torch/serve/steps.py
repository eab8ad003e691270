"""Serving steps (prefill, decode, encode) over a port ``Transformer``.

The port of ``repro/serve/steps.py``.  These are the entry points of
every arch; the MoE, MLA, recurrent (mlstm/slstm) and hybrid stacks
decode only here (the paged engine serves dense and swa stacks, as the
reference's), and encoder-only archs run ``make_encode_step``.  Each step
runs under ``torch.no_grad()``: serving never builds an autograd graph,
even over a model whose parameters require grad.
"""
from __future__ import annotations

import torch


def make_prefill_step(cfg, cache_len: int):
    """(model, {"tokens"} or, encoder-only, {"embeds"}) -> (last_logits
    (B,1,V), cache)."""
    @torch.no_grad()
    def prefill(model, batch):
        kw = ({"embeds": batch["embeds"]} if cfg.encoder_only
              else {"tokens": batch["tokens"]})
        logits, _aux, cache = model(build_cache_len=cache_len,
                                    last_logit_only=True, **kw)
        return logits, cache
    return prefill


def make_encode_step(cfg):
    """Encoder-only archs: (model, {"embeds"}) -> logits (B, S, V), the
    full-sequence forward (no cache, no decode)."""
    @torch.no_grad()
    def encode(model, batch):
        logits, _aux = model(embeds=batch["embeds"])
        return logits
    return encode


def make_serve_step(cfg):
    """One decode step: (model, cache, tokens (B,), index) -> (next, cache).

    Greedy argmax here; the engine layer samples (serve/engine.py).
    """
    def serve_step(model, cache, tokens, index):
        logits, new_cache = model.decode_step(tokens, cache, index)
        return torch.argmax(logits, dim=-1).to(torch.int32), new_cache
    return serve_step
