"""The segmented transformer in PyTorch: every block kind of the reference.

The port of ``repro/models/transformer.py``: ``Transformer`` holds one
``Block`` per layer (the JAX package scans stacked parameters; the port
runs a Python loop over modules).  Entry points:

  init_params(cfg, seed, device)                -> Transformer, random weights
  Transformer.forward(tokens | embeds, ...)     -> logits (B, S, V), aux [, cache]
  Transformer.init_cache(B, max_seq)            -> decode cache (a rank's, sharded)
  Transformer.decode_step(tokens, cache, index) -> logits (B, V) fp32, cache
  cross_entropy(logits, labels, mask=None)      -> mean token CE (fp32)
  vocab_parallel_cross_entropy(...)             -> the same, logits split over "model"
  param_count(model)                            -> number of weights

Parameters are made with ``requires_grad=False``, so serving builds no
autograd graph; training turns gradients on (``model.requires_grad_(True)``,
``train/train_step.py``) and differentiates ``forward``, which under
``cfg.remat == "layer"`` recomputes each block in the backward pass, as
the reference's ``jax.checkpoint`` of the block body.  ``decode_step`` and
the serving steps run under ``torch.no_grad()``.

A model whose parameters are DTensors (``distributed/sharding.py::
shard_model``, the sharded train step) sets ``gather``: ``forward`` then
runs each block by its :func:`model_plan`: on its weights fetched in the
plan's modes (gathered over ``"data"``, and over ``"model"`` only where
the block does not split there), with the plan's split regions handed
to the layer functions (their ``split``), inside the block's checkpoint
under ``remat == "layer"`` so that the backward fetches them again
instead of keeping them, and the embedding, final norm and unembedding
on theirs (:func:`vocab_plan`).  Split over ``"model"``, the embedding
is vocab-parallel (each rank looks up the ids of its vocab rows, summed
over the axis) and so are the logits: each rank's hold its own vocab
columns, for :func:`vocab_parallel_cross_entropy`.

Sharded serving (``serve/steps.py``) runs the same plan: ``decode_step``
fetches each block's weights as the forward does and hands the block its
split regions (``Block.decode``'s ``split``), on this rank's rows, in
the layout of a ``sharding.RankCache`` that ``init_cache`` or a prefill
(``build_cache_len``) returns: the rank's rows, its KV heads where a
block splits ``"kv"`` (every KV head otherwise), for one row its run of
the slots over ``"data"`` (``sharding.slots_split``: attention and MLA
then merge their softmaxes across the axis), its share of each
recurrent state whose cell the block splits over ``"model"``; MLA's
latent is every rank's of the axis.

``forward`` returns the reference's aux term with the logits: the sum of
every ``moe``/``moe_swa`` layer's load-balancing loss (fp32 scalar, zero
for a stack without MoE).  The caches are lists with one entry per layer
(JAX: one stacked pytree per segment): a KV dict for the attention
kinds, the recurrent state tuple for ``mlstm``/``slstm``, and
``{"kv": KV dict, "ssm": (s, conv tail)}`` for the hybrid kinds.

Block kinds: ``dense``, ``swa`` (sliding-window attention over a ring
cache), ``moe``, ``moe_swa``, ``mla``, ``encoder`` (bidirectional
attention), ``mlstm``/``slstm`` (xLSTM cells, ``models/ssm.py``) and
``hybrid``/``hybrid_global`` (hymba: attention, windowed for ``hybrid``,
beside a Mamba SSM on the same input).
"""
from __future__ import annotations

import contextlib
import types
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..distributed import sharding
from ..launch.mesh import current_dp_axes, current_mesh, mesh_context
from . import mla as mla_lib
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import (MLP, Attention, Norm, _dense_init, apply_norm, attention,
                     mlp, stat)

HYBRID_KINDS = ("hybrid", "hybrid_global")
CELLS = {"mlstm": (ssm_lib.MLSTM, ssm_lib.mlstm_block),
         "slstm": (ssm_lib.SLSTM, ssm_lib.slstm_block)}


def _window(kind, cfg):
    return cfg.swa_window if kind in ("swa", "moe_swa", "hybrid") else None


def kv_len(kind, cfg, max_seq) -> int:
    """The slots of a ``kind`` layer's decode cache of ``max_seq``
    (``Transformer.init_cache``)."""
    if _window(kind, cfg) is not None:
        # SWA layers keep a ring of window + slack slots; masking uses the
        # stored true positions, so decode carries O(window) state.
        return min(max_seq, max(cfg.swa_window + 128, 256))
    return max_seq


def _norm(x, p, cfg):
    return apply_norm(x, p, cfg.norm_kind, cfg.norm_eps)


class Block(nn.Module):
    """One block of ``kind``.  Attention kinds: norm1 -> attention (GQA,
    bidirectional for ``encoder``; MLA for ``mla``) -> norm2 -> MLP (an MoE
    for ``moe``/``moe_swa``), both residual.  ``mlstm``/``slstm``: norm1 ->
    the cell, residual.  Hybrid kinds: norm1 -> attention and a Mamba
    ``cell`` on the same input, each normed (``attn_norm``, ``ssm_norm``),
    ``x + 0.5 * (a + s)``, then norm2 -> MLP."""

    def __init__(self, kind, cfg, dtype, device):
        super().__init__()
        self.kind = kind
        self.norm1 = Norm(cfg.d_model, cfg.norm_kind, dtype, device)
        if kind in CELLS:
            self.cell = CELLS[kind][0](cfg, dtype, device)
            return
        if kind == "mla":
            self.attn = mla_lib.MLA(cfg, dtype, device)
        else:
            self.attn = Attention(cfg, dtype, device)
        if kind in HYBRID_KINDS:
            self.cell = ssm_lib.Mamba(cfg, dtype, device)
            self.attn_norm = Norm(cfg.d_model, cfg.norm_kind, dtype, device)
            self.ssm_norm = Norm(cfg.d_model, cfg.norm_kind, dtype, device)
        self.norm2 = Norm(cfg.d_model, cfg.norm_kind, dtype, device)
        if kind in ("moe", "moe_swa"):
            self.moe = moe_lib.MoE(cfg, dtype, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype, device)

    def _ffn(self, x, cfg, split=frozenset()):
        """The second residual half; returns (x, its normed input)."""
        h2 = _norm(x, self.norm2, cfg)
        if self.kind in ("moe", "moe_swa"):
            return x + moe_lib.moe_mlp(h2, self.moe, cfg, split), h2
        return x + mlp(h2, self.mlp, cfg.mlp_kind, "mlp" in split), h2

    def _mix(self, x, a, s, cfg):
        """The hybrid kinds' join of attention ``a`` and SSM ``s``."""
        a = _norm(a, self.attn_norm, cfg)
        s = _norm(s, self.ssm_norm, cfg)
        return x + 0.5 * (a + s)

    def forward(self, x, cfg, positions, cache_len=None,
                mrope_positions=None, split=frozenset()):
        """Full sequence; returns (x, aux, cache|None): the MoE balance
        term (fp32 scalar) and, with ``cache_len``, this layer's decode
        cache filled up to position S-1.  ``split``: the regions split
        over ``"model"`` (``Plan.split`` of :func:`model_plan`)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        h = _norm(x, self.norm1, cfg)
        if self.kind in CELLS:
            out, st = CELLS[self.kind][1](h, self.cell, cfg, split=split)
            return x + out, aux, st if cache_len is not None else None
        window = _window(self.kind, cfg)
        if self.kind == "mla":
            a, kv = mla_lib.mla_attention(h, self.attn, cfg,
                                          positions=positions, split=split)
        else:
            a, kv = attention(h, self.attn, cfg, positions=positions,
                              kind="bidir" if self.kind == "encoder"
                              else "causal", window=window,
                              mrope_positions=mrope_positions, split=split)
        if self.kind in HYBRID_KINDS:
            s, st = ssm_lib.mamba_block(h, self.cell, cfg, split=split)
            x, h2 = self._ffn(self._mix(x, a, s, cfg), cfg, split)
        else:
            x, h2 = self._ffn(x + a, cfg, split)
        if self.kind in ("moe", "moe_swa"):
            aux = aux + moe_lib.aux_load_balance_loss(h2, self.moe, cfg)
        cache = None
        if cache_len is not None:
            if self.kind == "mla":
                cache = {n: _pad_seq(t, cache_len) for n, t in kv.items()}
            elif window is not None:
                # min(cache_len, window + 128) slots; init_cache's ring
                # has at least 256: both decode the same (as in JAX)
                ring = min(cache_len, window + 128)
                cache = _ring_from_full(kv["k"], kv["v"], ring)
            else:
                cache = _pad_cache_to(kv, cache_len)
            if self.kind in HYBRID_KINDS:
                cache = {"kv": cache, "ssm": st}
        return x, aux, cache

    def decode(self, x, c, cfg, index, positions, split=frozenset(),
               slots=False):
        """One token against this layer's cache entry ``c`` (KV written in
        place); returns (x, the layer's new cache entry).  ``split`` as in
        :meth:`forward`; ``slots``: the entry holds this rank's run of
        slots split over ``"data"`` (``sharding.slots_split``)."""
        h = _norm(x, self.norm1, cfg)
        if self.kind in CELLS:
            out, st = CELLS[self.kind][1](h, self.cell, cfg, state=c,
                                          split=split)
            return x + out, st
        if self.kind == "mla":
            a, nc = mla_lib.mla_attention(h, self.attn, cfg,
                                          positions=positions, cache=c,
                                          cache_index=index, split=split,
                                          slots=slots)
            return self._ffn(x + a, cfg, split)[0], nc
        kv = c["kv"] if self.kind in HYBRID_KINDS else c
        T = kv["k"].shape[1]
        if slots:
            T = sharding.slot_range(T)[1]
        slot = index % T                    # identity for full-length caches
        a, kv = attention(h, self.attn, cfg, positions=positions,
                          window=_window(self.kind, cfg), cache=kv,
                          cache_index=slot, true_index=index, split=split,
                          slots=slots)
        if self.kind not in HYBRID_KINDS:
            return self._ffn(x + a, cfg, split)[0], kv
        s, st = ssm_lib.mamba_block(h, self.cell, cfg, state=c["ssm"],
                                    split=split)
        return self._ffn(self._mix(x, a, s, cfg), cfg, split)[0], {
            "kv": kv, "ssm": st}


def _ring_from_full(k, v, kv_len):
    """Ring cache from full-sequence KV (B, S, KVH, D).

    Slot s holds the *latest* position p = s (mod kv_len), p < S: a pure
    gather, so the prefill -> decode handoff is exact for SWA ring caches.
    ``S - 1 - slots`` is negative past S: floor division, as JAX's ``//``.
    """
    B, S = k.shape[:2]
    slots = torch.arange(kv_len, device=k.device)
    pos = slots + kv_len * torch.div(S - 1 - slots, kv_len,
                                     rounding_mode="floor")
    valid = (pos < S) & (pos >= 0) & (slots < S)
    safe = pos.clamp(0, S - 1)
    keep = valid[None, :, None, None]
    return {"k": torch.where(keep, k[:, safe], 0),
            "v": torch.where(keep, v[:, safe], 0),
            "pos": torch.where(valid, pos, -1).to(torch.int32)
                        .expand(B, kv_len).contiguous()}


def _pad_seq(t, max_seq):
    """Zero-pad (B, S, ...) to (B, max_seq, ...)."""
    pad = (0, 0) * (t.dim() - 2) + (0, max_seq - t.shape[1])
    return nn.functional.pad(t, pad)


def _pad_cache_to(kv, max_seq):
    """Pad full-sequence KV (B, S, ...) to cache length with pos tracking."""
    k, v = kv["k"], kv["v"]
    B, S = k.shape[:2]
    pos = torch.full((B, max_seq), -1, dtype=torch.int32, device=k.device)
    pos[:, :S] = torch.arange(S, dtype=torch.int32, device=k.device)
    return {"k": _pad_seq(k, max_seq), "v": _pad_seq(v, max_seq), "pos": pos}


def _slot_dicts(entry) -> list:
    """The dicts of a layer's cache entry whose tensors hold KV slots
    (dim 1): a KV or MLA latent dict, a hybrid layer's ``"kv"``; none for
    a recurrent state."""
    if isinstance(entry, tuple):
        return []
    return [entry["kv"]] if "kv" in entry else [entry]


def _n_slots(entry) -> int:
    return next(iter(_slot_dicts(entry)[0].values())).shape[1]


def _own_slots(entry):
    """``entry`` with its slots cut to this rank's run of ``T / data``
    (copies, so the whole sequence is not kept alive)."""
    if "kv" in entry:
        return {"kv": _own_slots(entry["kv"]), "ssm": entry["ssm"]}
    n = _n_slots(entry) // sharding.mesh_axis_size("data")
    lo = sharding.slot_range(n)[0]
    return {k: t[:, lo:lo + n].clone() for k, t in entry.items()}


def _cell_region(layer: int, split) -> dict:
    """``{layer: region}`` where ``split`` (a block's ``Plan.split``)
    splits its recurrent cell over ``"model"``, else ``{}``."""
    return {layer: r for r in split & ssm_lib.CELL_REGIONS}


def _keep_all(cuts: dict, units: dict) -> bool:
    """Whether every weight of ``units`` (``{name: unit}``) keeps its
    ``"model"`` cut on its unit (``sharding.keeps_model_cut``)."""
    return all(sharding.keeps_model_cut(cuts.get(n), u)
               for n, u in units.items())


#: the regions that the sharded step can split over ``"model"``
#: (``Plan.split``): attention's or MLA's heads ("attn") and, with them,
#: the KV heads ("kv"; without it every rank holds all of them); the
#: MLP's hidden units; the routed experts, whole ("experts") or each by
#: its hidden units ("expert_hidden"); the shared experts' hidden units;
#: the vocab of the embedding, the logits and the loss; a recurrent cell
#: ("cell": an mLSTM's heads, an sLSTM's or a Mamba's channels) or an
#: mLSTM's value columns of one head ("cell_values", where its heads are
#: fewer than the ranks; ``models/ssm.py``)
REGIONS = ("attn", "kv", "mlp", "experts", "expert_hidden", "shared",
           "vocab", "cell", "cell_values")

#: the cut dims of (``wi``, ``wg``, ``wo``) that split a feed-forward part,
#: and the region each split is (a GELU MLP has no ``wg``: the last two)
_FFN_CUTS = (("mlp.", {(1, 1, 0): "mlp"}),
             ("moe.shared.", {(1, 1, 0): "shared"}),
             ("moe.", {(0, 0, 0): "experts", (2, 2, 1): "expert_hidden"}))


class Plan(NamedTuple):
    """How the sharded step runs a block or the top weights: ``modes``
    (``{name: mode}``, ``sharding.MODES``; "full" where it names none) and
    ``split``, the :data:`REGIONS` that it splits over ``"model"``.  The
    layer functions take ``split`` and do what it says; no other code
    decides where the model is split."""
    modes: dict
    split: frozenset


def model_plan(kind, cfg, cuts: dict) -> Plan:
    """The :class:`Plan` of a block of ``kind`` whose weights have the
    ``"model"`` cuts ``cuts`` (``{name within the block:
    sharding.model_cut}``): which weights keep their ``"model"`` slice
    ("local"), which are gathered for compute every rank repeats ("full",
    the default: norms, the router) and which are gathered for use inside
    a split region ("partial").  A region splits only where all of its
    sliced weights keep whole units: attention's heads (``wq`` columns
    and ``wo`` rows of ``head_dim``), MLA's heads, the MLP's and the
    shared experts' hidden units, the routed experts (whole experts, or
    the hidden units of each), the recurrent cells (:func:`_cell_plan`).
    """
    modes, split = _cell_plan(kind, cfg, cuts)
    hd = cfg.resolved_head_dim
    if kind == "mla":
        m = cfg.mla
        heads = {"attn.wq_up": m.qk_nope_head_dim + m.qk_rope_head_dim,
                 "attn.wk_up": m.qk_nope_head_dim,
                 "attn.wv_up": m.v_head_dim, "attn.wo": m.v_head_dim}
        if _keep_all(cuts, heads):
            split.add("attn")
            modes.update(dict.fromkeys(heads, "local"))
            modes.update(dict.fromkeys(("attn.wq_down", "attn.q_norm",
                                        "attn.wkv_down", "attn.kv_norm"),
                                       "partial"))
    elif kind not in CELLS and _keep_all(cuts, {"attn.wq": hd,
                                                "attn.wo": hd}):
        kv = ("attn.wk", "attn.wv")
        split.add("attn")
        modes.update({"attn.wq": "local", "attn.wo": "local"})
        if _keep_all(cuts, dict.fromkeys(kv, hd)):
            split.add("kv")
        modes.update(dict.fromkeys(kv, "local" if "kv" in split
                                   else "partial"))
        modes.update({n: "partial" for n in ("attn.q_norm", "attn.k_norm")
                      if n in cuts})
    for prefix, regions in _FFN_CUTS:
        ws = [prefix + w for w in ("wi", "wg", "wo") if prefix + w in cuts]
        if not ws or not _keep_all(cuts, dict.fromkeys(ws, 1)):
            continue
        region = {d[-len(ws):]: r for d, r in regions.items()}.get(
            tuple(cuts[n][0] for n in ws))
        if region is not None:
            split.add(region)
            modes.update(dict.fromkeys(ws, "local"))
    return Plan(modes, frozenset(split))


def _cell_plan(kind, cfg, cuts: dict):
    """(modes, split regions) of a block's recurrent cell
    (``models/ssm.py``): an mLSTM by heads ("cell") where each rank's
    ``wq wk wv wo_gate`` columns, ``wo`` rows and gate columns hold whole
    heads, else by value columns ("cell_values") where each rank's ``wv``
    columns lie in one head (``wq wk wi wf`` then gathered, "partial");
    an sLSTM by channels ("cell") where every weight is cut over
    ``"model"``; a hybrid block's Mamba by channels ("cell") where
    ``w_bcdt`` and ``w_out`` are (``w_in`` then gathered, its halves
    sliced to the rank's channels, as the replicated ``conv``, ``a_log``,
    ``d_skip`` and ``dt_bias``); the norm's scale "partial", sliced.
    Nothing splits elsewhere: the cell is "full", every rank running all
    of it."""
    modes, split = {}, set()
    if kind == "mlstm":
        dk = cfg.d_model // cfg.n_heads
        heads = {**dict.fromkeys(("cell.wq", "cell.wk", "cell.wv",
                                  "cell.wo_gate", "cell.wo"), dk),
                 "cell.wi": 1, "cell.wf": 1}
        columns = ("cell.wv", "cell.wo_gate", "cell.wo")
        if _keep_all(cuts, heads):
            split.add("cell")
            modes.update(dict.fromkeys(heads, "local"))
        elif (_keep_all(cuts, dict.fromkeys(columns, 1))
              and dk % cuts["cell.wv"][1] == 0):
            split.add("cell_values")
            modes.update(dict.fromkeys(columns, "local"))
            modes.update(dict.fromkeys(("cell.wq", "cell.wk", "cell.wi",
                                        "cell.wf"), "partial"))
    elif kind == "slstm":
        ws = ("cell.wz", "cell.wi", "cell.wf", "cell.wo_gate", "cell.r",
              "cell.wo")
        if _keep_all(cuts, dict.fromkeys(ws, 1)):
            split.add("cell")
            modes.update(dict.fromkeys(ws, "local"))
    elif kind in HYBRID_KINDS and _keep_all(
            cuts, dict.fromkeys(("cell.w_bcdt", "cell.w_out"), 1)):
        split.add("cell")
        modes.update(dict.fromkeys(("cell.w_bcdt", "cell.w_out"), "local"))
        modes.update(dict.fromkeys(("cell.w_in", "cell.conv", "cell.a_log",
                                    "cell.d_skip", "cell.dt_bias"),
                                   "partial"))
    if split and kind in CELLS:
        modes["cell.out_norm"] = "partial"
    return modes, split


def vocab_plan(cuts: dict) -> Plan:
    """The :class:`Plan` of the top weights with ``"model"`` cuts
    ``cuts``: the embedding (and the unembedding) keep their vocab rows,
    and the vocab is split, where they are cut over ``"model"``."""
    vocab = dict.fromkeys((n for n in ("embed", "unembed") if n in cuts), 1)
    if vocab and _keep_all(cuts, vocab):
        return Plan(dict.fromkeys(vocab, "local"), frozenset({"vocab"}))
    return Plan({}, frozenset())


class Transformer(nn.Module):
    """Weights are allocated uninitialised on ``device`` in ``cfg.dtype``
    (the Mamba leaves ``a_log``, ``d_skip``, ``dt_bias`` in fp32); fill
    them with :func:`init_params` or ``convert.params_from_reference``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
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
        self.layers = nn.ModuleList(Block(kind, cfg, dtype, dev)
                                    for kind, count in cfg.segments
                                    for _ in range(count))
        #: ``{name: DTensor} -> {name: full tensor}`` on a sharded model
        self.gather = None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def unembed_weight(self):
        return self.embed.T if self.cfg.tie_embeddings else self.unembed

    def _top_named(self) -> dict:
        return {n: p for n, p in self.named_parameters()
                if not n.startswith("layers.")}

    def top_plan(self) -> Plan:
        """The :func:`vocab_plan` of a sharded model's top weights (an
        empty one on a model that is not sharded)."""
        if self.gather is None:
            return Plan({}, frozenset())
        return vocab_plan({n: sharding.model_cut(p)
                           for n, p in self._top_named().items()})

    def _top_weights(self, plan: Plan):
        """(embed, final norm, unembed weight): the model's own, or on a
        sharded model fetched in the modes of ``plan``."""
        if self.gather is None:
            return self.embed, self.final_norm, self.unembed_weight()
        w = self.gather(self._top_named(), plan.modes)
        norm = types.SimpleNamespace(scale=w["final_norm.scale"],
                                     bias=w.get("final_norm.bias"))
        embed = w["embed"]
        return embed, norm, (embed.T if self.cfg.tie_embeddings
                             else w["unembed"])

    def mesh_scope(self, rows=None):
        """A context in which the current mesh is this sharded model's
        (``launch/mesh.py::mesh_context``, unless one is current already),
        for the collectives of its split regions and of the vocab-parallel
        loss; a null context on a model that is not sharded.  ``rows``:
        the data-parallel axes that split the rows this rank is handed
        (default pod x data, the train step's); a serving step passes
        ``sharding.row_axes`` of its batch."""
        if self.gather is None or current_mesh() is not None:
            return contextlib.nullcontext()
        if rows is None:
            return mesh_context(self.embed.device_mesh)
        return mesh_context(self.embed.device_mesh, dp_axes=rows)

    def block_plan(self, blk) -> Plan:
        """:func:`model_plan` of block ``blk`` of this sharded model."""
        return model_plan(blk.kind, self.cfg, {
            n: sharding.model_cut(p) for n, p in blk.named_parameters()})

    def _block(self, fn, *args, **kw):
        """``fn(*args, **kw)``, ``fn`` a block or its bound ``decode``; on
        a sharded model on the block's weights fetched in the modes of
        :func:`model_plan`, with its split regions (in its mesh's scope,
        also when the backward recomputes it)."""
        if self.gather is None:
            return fn(*args, **kw)
        blk = getattr(fn, "__self__", fn)
        plan = self.block_plan(blk)
        with self.mesh_scope(), _reparametrize_module(
                blk, self.gather(dict(blk.named_parameters()), plan.modes)):
            return fn(*args, split=plan.split, **kw)

    def _embed(self, tokens, embed, split_vocab: bool):
        """Token ids -> embeddings; vocab-parallel where ``split_vocab``:
        this rank's rows, zeros for the others' ids, summed over
        ``"model"``."""
        if split_vocab:
            ids = tokens.long() - sharding.model_rank() * embed.shape[0]
            mine = (ids >= 0) & (ids < embed.shape[0])
            x = F.embedding(torch.where(mine, ids, 0), embed)
            return sharding.reduce_from_model(
                torch.where(mine[..., None], x, 0))
        # embed[tokens]'s values; its backward is the embedding-gradient
        # kernel, not the indexing one
        return F.embedding(tokens, embed)

    def forward(self, tokens=None, embeds=None, mrope_positions=None,
                build_cache_len=None, last_logit_only=False):
        """Token ids (B, S), or precomputed frame/patch ``embeds`` (B, S, d)
        (cast to the model dtype), -> (logits (B, S, V) in the model dtype,
        aux); with ``build_cache_len`` (prefill) (logits, aux, cache), the
        decode cache filled up to position S-1.  ``mrope_positions``
        (3, B, S) feed M-RoPE.  ``aux`` is the fp32 sum of the MoE layers'
        balance terms.  ``last_logit_only`` unembeds the last position
        only.  Under ``cfg.remat == "layer"``, with grad enabled and no
        cache being built, each block is checkpointed: its activations are
        recomputed in the backward pass instead of kept.  With the vocab
        split over ``"model"`` (module docstring) the logits are this
        rank's vocab columns."""
        with self.mesh_scope():
            return self._forward(tokens, embeds, mrope_positions,
                                 build_cache_len, last_logit_only)

    def _forward(self, tokens, embeds, mrope_positions, build_cache_len,
                 last_logit_only):
        cfg = self.cfg
        top = self.top_plan()
        embed, final_norm, unembed = self._top_weights(top)
        split_vocab = "vocab" in top.split
        if embeds is None:
            x = self._embed(tokens, embed, split_vocab)
        else:
            x = embeds.to(embed.dtype)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = []
        remat = (cfg.remat == "layer" and torch.is_grad_enabled()
                 and build_cache_len is None)
        for blk in self.layers:
            if remat:
                x, aux, c = checkpoint(self._block, blk, x, cfg, positions,
                                       None, mrope_positions,
                                       use_reentrant=False)
            else:
                x, aux, c = self._block(blk, x, cfg, positions,
                                        build_cache_len, mrope_positions)
            aux_total = aux_total + aux
            caches.append(c)
        x = _norm(x, final_norm, cfg)
        if last_logit_only:
            x = x[:, -1:]
        if split_vocab:
            x = sharding.copy_to_model(x)
        logits = x @ unembed
        if build_cache_len is not None:
            if self.gather is not None:
                caches = self._rank_cache(caches, B)
            return logits, aux_total, caches
        return logits, aux_total

    def _rank_cache(self, entries, B: int):
        """A prefill's per-layer caches over this rank's ``B`` rows as a
        ``sharding.RankCache``: the slots of each layer cut to the rank's
        run where they split over ``"data"``."""
        sizes = sharding.mesh_sizes(current_mesh())
        rows = sharding.global_rows(B)
        kv_split, slots, cells = set(), set(), {}
        for i, (blk, e) in enumerate(zip(self.layers, entries)):
            split = self.block_plan(blk).split
            if "kv" in split:
                kv_split.add(i)
            cells.update(_cell_region(i, split))
            if _slot_dicts(e) and sharding.slots_split(rows, _n_slots(e),
                                                       sizes):
                slots.add(i)
                entries[i] = _own_slots(e)
        return sharding.RankCache(
            entries, [a for a in current_dp_axes() if sizes.get(a, 1) > 1],
            kv_split, slots, cells)

    def _init_block_cache(self, kind, B, max_seq, kvh=None, slots=1,
                          cell=None, ranks=1):
        """``slots``: into how many runs the KV slots are split (this
        rank's is made); ``kvh``: the KV heads held (default all);
        ``cell``: the region that splits the recurrent state over the
        ``ranks`` of ``"model"`` (``sharding.RankCache``'s ``cells``),
        this rank's piece made."""
        cfg, dev, dtype = self.cfg, self.device, self.embed.dtype
        f32 = dict(dtype=torch.float32, device=dev)
        part = ranks if cell else 1           # a split state's share
        if kind == "mla":
            m, T = cfg.mla, max_seq // slots
            return {"c_kv": torch.zeros((B, T, m.kv_lora_rank),
                                        dtype=dtype, device=dev),
                    "k_rope": torch.zeros((B, T, m.qk_rope_head_dim),
                                          dtype=dtype, device=dev)}
        if kind == "mlstm":
            H, dk = cfg.n_heads, cfg.d_model // cfg.n_heads
            H, dv = (1, cfg.d_model // ranks) if cell == "cell_values" else (
                H // part, dk)
            return (torch.zeros((B, H, dk, dv), **f32),
                    torch.zeros((B, H, dk), **f32), torch.zeros((B, H), **f32))
        if kind == "slstm":
            return tuple(torch.zeros((B, cfg.d_model // part), **f32)
                         for _ in range(4))
        n_slots = kv_len(kind, cfg, max_seq) // slots
        int8 = cfg.kv_cache_dtype == "int8"
        shape = (B, n_slots, kvh or cfg.n_kv_heads, cfg.resolved_head_dim)
        kv_dtype = torch.int8 if int8 else dtype
        kv = {"k": torch.zeros(shape, dtype=kv_dtype, device=dev),
              "v": torch.zeros(shape, dtype=kv_dtype, device=dev),
              "pos": torch.full((B, n_slots), -1, dtype=torch.int32,
                                device=dev)}
        if int8:
            kv["k_scale"] = torch.zeros(shape[:3], **f32)
            kv["v_scale"] = torch.zeros(shape[:3], **f32)
        if kind in HYBRID_KINDS:
            di = cfg.ssm_expand * cfg.d_model // part
            return {"kv": kv, "ssm": (
                torch.zeros((B, di, cfg.ssm_state), **f32),
                torch.zeros((B, cfg.conv_width - 1, di), dtype=dtype,
                            device=dev))}
        return kv

    def init_cache(self, B, max_seq):
        """The decode cache of ``B`` rows, one entry per layer (module
        docstring); KV in int8 with fp32 scales when ``cfg.kv_cache_dtype
        == "int8"``.  On a sharded model, this rank's piece of it as a
        ``sharding.RankCache``: its rows (``sharding.row_axes``), its KV
        heads where the layer's plan splits ``"kv"`` over ``"model"``
        (every KV head otherwise), for ``B == 1`` its run of the slots
        where they split over ``"data"`` (``sharding.slots_split``), its
        share of each recurrent state the plan splits over ``"model"``
        (``sharding.RankCache``'s ``cells``); MLA's latent is every
        rank's of the axis."""
        if self.gather is None:
            return [self._init_block_cache(blk.kind, B, max_seq)
                    for blk in self.layers]
        return self.rank_cache(
            B, max_seq, sharding.mesh_sizes(self.embed.device_mesh),
            [self.block_plan(blk).split for blk in self.layers])

    def rank_cache(self, B, max_seq, sizes: dict, splits: list):
        """One rank's piece of the decode cache of ``B`` rows on a mesh of
        ``sizes`` whose blocks split the regions ``splits`` (one set a
        layer, ``Plan.split``), as :meth:`init_cache` lays it out (the
        dry-run builds it on ``meta``)."""
        m, data = sizes.get("model", 1), sizes.get("data", 1)
        entries, kv_split, slots, cells = [], set(), set(), {}
        for i, (blk, split) in enumerate(zip(self.layers, splits)):
            kvh = None
            if "kv" in split:
                kv_split.add(i)
                kvh = self.cfg.n_kv_heads // m
            cells.update(_cell_region(i, split))
            n = 1
            if blk.kind not in CELLS and sharding.slots_split(
                    B, kv_len(blk.kind, self.cfg, max_seq), sizes):
                slots.add(i)
                n = data
            entries.append(self._init_block_cache(
                blk.kind, sharding.rows_per_rank(B, sizes), max_seq, kvh, n,
                cells.get(i), m))
        return sharding.RankCache(entries, sharding.row_axes(B, sizes),
                                  kv_split, slots, cells)

    @torch.no_grad()
    def decode_step(self, tokens, cache, index: int):
        """One decode step: tokens (B,) at position ``index``.

        Returns (logits (B, V) fp32, cache); KV is written in place and
        each recurrent layer's entry of the list is replaced by its new
        state.  On a sharded model (module docstring) ``tokens`` are this
        rank's rows of its ``cache`` (a ``sharding.RankCache``), each
        block runs on its weights fetched by its plan with its split
        regions, the embedding is vocab-parallel where the vocab is split
        and the logits (B', V') are this rank's vocab columns
        (``sharding.vocab_argmax`` reads them); no weight is gathered
        along ``"model"`` but the plan's exceptions.
        """
        cfg = self.cfg
        B = tokens.shape[0]
        slots = getattr(cache, "slots", frozenset())
        with self.mesh_scope(getattr(cache, "rows", None)):
            top = self.top_plan()
            embed, final_norm, unembed = self._top_weights(top)
            x = self._embed(tokens, embed, "vocab" in top.split)[:, None, :]
            positions = torch.full((B, 1), index, dtype=torch.int32,
                                   device=x.device)
            for i, blk in enumerate(self.layers):
                x, cache[i] = self._block(blk.decode, x, cache[i], cfg,
                                          index, positions,
                                          slots=i in slots)
            x = _norm(x, final_norm, cfg)
            return (x[:, 0] @ unembed).float(), cache


def param_count(model) -> int:
    """The number of weights of ``model`` (every parameter's elements)."""
    return sum(p.numel() for p in model.parameters())


def cross_entropy(logits, labels, mask=None):
    """Mean token-level cross entropy of logits (..., V) against int
    ``labels`` (...): logsumexp minus the gold logit, in fp32 whatever the
    logits' dtype (float64 logits stay float64); with ``mask`` the mean
    over its nonzero weights (at least 1), as the reference."""
    logits = stat(logits)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def vocab_parallel_cross_entropy(logits, labels, mask=None):
    """:func:`cross_entropy` of logits split over ``"model"``: ``logits``
    (..., V / m) are this rank's vocab columns (rank r's from ``r * V /
    m``).  The max is all-reduced without a gradient, the sum of exps and
    the gold logit (zero on the ranks that do not hold it) are summed over
    the axis, so no rank builds the full logits; every rank returns the
    same loss."""
    logits = stat(logits)
    V = logits.shape[-1]
    mx = sharding.all_reduce_max(logits.max(dim=-1).values)
    sumexp = sharding.reduce_from_model(
        torch.exp(logits - mx[..., None]).sum(dim=-1))
    ids = labels.long() - sharding.model_rank() * V
    mine = (ids >= 0) & (ids < V)
    gold = torch.gather(logits, -1, torch.where(mine, ids, 0)[..., None])
    gold = sharding.reduce_from_model(torch.where(mine, gold[..., 0], 0.0))
    nll = torch.log(sumexp) + mx - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _fan_in(name, p, cfg) -> int:
    """The fan-in of the JAX init: d_model for the embedding, d_expert for
    an expert ``wo`` (E, d_ff, d), else the leading axis; for the expert
    ``wi``/``wg`` (E, d, d_ff) that is E, as ``repro/models/moe.py``
    draws them."""
    if name == "embed":
        return cfg.d_model
    if name.endswith("moe.wo"):
        return p.shape[1]
    return p.shape[0]


def init_params(cfg, seed: int = 0, device=None) -> Transformer:
    """A Transformer with random weights drawn on ``device`` from ``seed``:
    matrices and expert stacks normal / sqrt(fan_in) (``_fan_in``), the
    Mamba ``conv`` normal * 0.1, norm scales 1, biases 0 and the Mamba
    fp32 leaves as the module sets them, as the JAX init; not its bits."""
    model = Transformer(cfg, device=device)
    g = torch.Generator(device=model.device)
    g.manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("cell.conv"):
                w = torch.randn(p.shape, generator=g, device=p.device,
                                dtype=torch.float32)
                p.copy_((w * 0.1).to(p.dtype))
            elif p.dim() >= 2 and not name.endswith("cell.a_log"):
                p.copy_(_dense_init(p.shape, p.dtype, g, p.device,
                                    _fan_in(name, p, cfg)))
    return model
