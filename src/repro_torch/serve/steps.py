"""Serving steps (prefill, decode, encode) over a port ``Transformer``.

The port of ``repro/serve/steps.py``.  These are the entry points of
every arch; the MoE, MLA, recurrent (mlstm/slstm) and hybrid stacks
decode only here (the paged engine serves dense and swa stacks, as the
reference's), and encoder-only archs run ``make_encode_step``.  Each step
runs under ``torch.no_grad()``: serving never builds an autograd graph,
even over a model whose parameters require grad.

On a sharded model (``distributed/sharding.py::shard_model``) the steps
run as the reference's dry-run jits them on a mesh: every rank is handed
the global batch and serves its rows (``sharding.row_axes``: over pod x
data where that divides them, else data, else every row), each block on
its weights fetched by its plan and split over ``"model"`` as in
training (no weight is gathered along ``"model"`` but the plan's
exceptions), the cache a ``sharding.RankCache`` (its rows, its KV heads
where the plan splits them, for one row its run of slots over
``"data"``).  Each step returns what the one-rank step returns, whole on
every rank: the rows and the vocab columns are gathered at the end
(counted, as every collective, by ``sharding.wire_counts``); the cache
stays the rank's (``sharding.gather_cache`` assembles the global one).
"""
from __future__ import annotations

import torch

from ..distributed import sharding


def _scope(model, B: int):
    """The scope of a step over a ``B``-row batch on ``model``: its mesh
    with the axes its rows split over (a null context on a model that is
    not sharded, whose rows, vocab and collectives are then its own)."""
    mesh = getattr(model.embed, "device_mesh", None)
    return model.mesh_scope(sharding.row_axes(B, sharding.mesh_sizes(mesh)))


def _whole(model, logits):
    """A sharded model's logits (this rank's rows and vocab columns) as
    the global batch's (the vocab gathered first, then the rows)."""
    if "vocab" in model.top_plan().split:
        logits = sharding.gather_model(logits, -1)
    return sharding.gather_rows(logits)


def make_prefill_step(cfg, cache_len: int):
    """(model, {"tokens"} or, encoder-only, {"embeds"}) -> (last_logits
    (B,1,V), cache); on a sharded model the cache is the rank's."""
    @torch.no_grad()
    def prefill(model, batch):
        key = "embeds" if cfg.encoder_only else "tokens"
        with _scope(model, batch[key].shape[0]):
            logits, _aux, cache = model(
                build_cache_len=cache_len, last_logit_only=True,
                **{key: sharding.local_rows(batch[key])})
            return _whole(model, logits), cache
    return prefill


def make_encode_step(cfg):
    """Encoder-only archs: (model, {"embeds"}) -> logits (B, S, V), the
    full-sequence forward (no cache, no decode)."""
    @torch.no_grad()
    def encode(model, batch):
        e = batch["embeds"]
        with _scope(model, e.shape[0]):
            logits, _aux = model(embeds=sharding.local_rows(e))
            return _whole(model, logits)
    return encode


def make_serve_step(cfg):
    """One decode step: (model, cache, tokens (B,), index) -> (next, cache).

    Greedy argmax here (over a vocab split along ``"model"``,
    ``sharding.vocab_argmax``: ties to the lowest id); the engine layer
    samples (serve/engine.py).
    """
    @torch.no_grad()
    def serve_step(model, cache, tokens, index):
        with _scope(model, tokens.shape[0]):
            logits, new_cache = model.decode_step(
                sharding.local_rows(tokens), cache, index)
            nxt = sharding.vocab_argmax(logits,
                                        "vocab" in model.top_plan().split)
            return sharding.gather_rows(nxt.to(torch.int32)), new_cache
    return serve_step
