"""The segmented transformer in PyTorch, dense attention blocks only.

The port of ``repro/models/transformer.py``: ``Transformer`` holds one
``Block`` per layer (the JAX package scans stacked parameters; the port
runs a Python loop over modules).  Entry points:

  init_params(cfg, seed, device)                -> Transformer, random weights
  Transformer.forward(tokens, ...)              -> logits (B, S, V) [, cache]
  Transformer.init_cache(B, max_seq)            -> contiguous decode cache
  Transformer.decode_step(tokens, cache, index) -> logits (B, V) fp32, cache

``forward`` returns no aux loss: the JAX package's is the MoE balance
term, always zero for dense blocks.  The caches are lists with one dict
per layer (JAX: one stacked dict per segment).

Only the ``dense`` block kind is ported.  ``swa`` (its ring cache),
``moe``/``moe_swa``, ``mla``, ``mlstm``/``slstm``, ``encoder`` and the
``hybrid`` kinds raise (ROADMAP.md, queue 1, item 9).
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .layers import (MLP, Attention, Norm, _dense_init, apply_norm, attention,
                     mlp)

PORTED_KINDS = ("dense",)


def check_supported(cfg) -> None:
    """Raise unless the port runs every part of ``cfg``."""
    bad = sorted({k for k, _ in cfg.segments} - set(PORTED_KINDS))
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {bad} are not ported; the port runs "
            f"{list(PORTED_KINDS)} (ROADMAP.md, queue 1, item 9)")
    if cfg.encoder_only:
        raise NotImplementedError(f"{cfg.name}: encoder-only models are not "
                                  "ported (ROADMAP.md, queue 1, item 9)")
    if cfg.mrope_sections is not None or cfg.kv_cache_dtype != "model":
        raise NotImplementedError(f"{cfg.name}: M-RoPE and the int8 KV cache "
                                  "are not ported (ROADMAP.md, queue 1, item 10)")


class Block(nn.Module):
    """One dense block: norm1 -> attention -> norm2 -> MLP, both residual."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.norm1 = Norm(cfg.d_model, cfg.norm_kind, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.norm2 = Norm(cfg.d_model, cfg.norm_kind, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype, device)

    def _mlp(self, x, cfg):
        h2 = apply_norm(x, self.norm2, cfg.norm_kind, cfg.norm_eps)
        return x + mlp(h2, self.mlp, cfg.mlp_kind)

    def forward(self, x, cfg, positions):
        """Full sequence; returns (x, raw per-position {"k", "v"})."""
        h = apply_norm(x, self.norm1, cfg.norm_kind, cfg.norm_eps)
        a, kv = attention(h, self.attn, cfg, positions=positions)
        return self._mlp(x + a, cfg), kv

    def decode(self, x, c, cfg, index, positions):
        """One token against the contiguous cache ``c`` (written in place)."""
        h = apply_norm(x, self.norm1, cfg.norm_kind, cfg.norm_eps)
        slot = index % c["k"].shape[1]          # identity for full-length caches
        a, nc = attention(h, self.attn, cfg, positions=positions, cache=c,
                          cache_index=slot, true_index=index)
        return self._mlp(x + a, cfg), nc


def _pad_cache_to(kv, max_seq):
    """Pad full-sequence KV (B, S, ...) to cache length with pos tracking."""
    k, v = kv["k"], kv["v"]
    B, S = k.shape[:2]
    pos = torch.full((B, max_seq), -1, dtype=torch.int32, device=k.device)
    pos[:, :S] = torch.arange(S, dtype=torch.int32, device=k.device)
    pad = (0, 0) * (k.dim() - 2) + (0, max_seq - S)
    return {"k": nn.functional.pad(k, pad), "v": nn.functional.pad(v, pad),
            "pos": pos}


class Transformer(nn.Module):
    """Weights are allocated uninitialised on ``device`` in ``cfg.dtype``;
    fill them with :func:`init_params` or ``convert.params_from_reference``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        dtype = getattr(torch, cfg.dtype)
        self.embed = nn.Parameter(torch.empty((cfg.vocab, cfg.d_model),
                                              dtype=dtype, device=dev),
                                  requires_grad=False)
        self.final_norm = Norm(cfg.d_model, cfg.norm_kind, dtype, dev)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(torch.empty((cfg.d_model, cfg.vocab),
                                                    dtype=dtype, device=dev),
                                        requires_grad=False)
        self.layers = nn.ModuleList(Block(cfg, dtype, dev)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def unembed_weight(self):
        return self.embed.T if self.cfg.tie_embeddings else self.unembed

    @torch.no_grad()
    def forward(self, tokens, build_cache_len=None, last_logit_only=False):
        """Token ids (B, S) -> logits (B, S, V) in the model dtype; with
        ``build_cache_len`` (prefill) also the decode cache filled up to
        position S-1.  ``last_logit_only`` unembeds the last position only."""
        cfg = self.cfg
        x = self.embed[tokens]
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        caches = []
        for blk in self.layers:
            x, kv = blk(x, cfg, positions)
            if build_cache_len is not None:
                caches.append(_pad_cache_to(kv, build_cache_len))
        x = apply_norm(x, self.final_norm, cfg.norm_kind, cfg.norm_eps)
        if last_logit_only:
            x = x[:, -1:]
        logits = x @ self.unembed_weight()
        if build_cache_len is not None:
            return logits, caches
        return logits

    def init_cache(self, B, max_seq):
        cfg, dev = self.cfg, self.device
        shape = (B, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        return [{"k": torch.zeros(shape, dtype=self.embed.dtype, device=dev),
                 "v": torch.zeros(shape, dtype=self.embed.dtype, device=dev),
                 "pos": torch.full((B, max_seq), -1, dtype=torch.int32,
                                   device=dev)}
                for _ in range(cfg.n_layers)]

    @torch.no_grad()
    def decode_step(self, tokens, cache, index: int):
        """One decode step: tokens (B,) at position ``index``.

        Returns (logits (B, V) fp32, cache); the cache is updated in place.
        """
        cfg = self.cfg
        B = tokens.shape[0]
        x = self.embed[tokens][:, None, :]
        positions = torch.full((B, 1), index, dtype=torch.int32,
                               device=x.device)
        for blk, c in zip(self.layers, cache):
            x, _ = blk.decode(x, c, cfg, index, positions)
        x = apply_norm(x, self.final_norm, cfg.norm_kind, cfg.norm_eps)
        return (x[:, 0] @ self.unembed_weight()).float(), cache


def init_params(cfg, seed: int = 0, device=None) -> Transformer:
    """A Transformer with random weights drawn on ``device`` from ``seed``:
    matrices normal / sqrt(fan_in) (fan_in = d_model for the embedding),
    norm scales 1, biases 0, as the JAX init; not its bits."""
    model = Transformer(cfg, device=device)
    g = torch.Generator(device=model.device)
    g.manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 2:
                fan_in = cfg.d_model if name == "embed" else p.shape[0]
                p.copy_(_dense_init(p.shape, p.dtype, g, p.device, fan_in))
    return model
