"""Multi-pod dry-run: per-rank memory and the three-term roofline of every
(arch x shape x mesh) cell, on no device and no process group.

The port of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell's step over 512 XLA placeholder devices and reads
XLA's memory and cost analyses.  PyTorch has no such artifact, so this
dry-run counts the plans the port runs instead, and every record says
so under ``"plan"`` (``PLAN`` for the train cells, ``SERVING_PLAN`` for
the prefill, decode and long-context ones); it claims no HLO number.
For each cell whose
``configs/shapes.py::cell_status`` is ``run``, on the production mesh
sizes (16 x 16 and 2 x 16 x 16; ``launch/mesh.py::production_shape``):

* the parameters, the optimizer state, the decode cache and the batch are
  built on ``torch.device("meta")`` (shapes and dtypes, no memory);
* their per-rank bytes follow the placements of
  ``distributed/sharding.py::param_specs`` (parameters, AdamW ``m`` and
  ``v``, gradients) and the plan's rows (the batch's rows over pod x
  data where they divide, else over data, else every row, as the
  reference's ``batch_specs``: ``sharding.row_axes``); a serving cache is
  the rank's piece that ``Transformer.rank_cache`` lays out (its rows,
  its KV heads and its share of each recurrent state where the plan
  splits them over ``"model"``, for one row its slots over ``"data"``);
* ``activation_estimate`` adds what one step keeps live besides: under
  ``remat == "layer"`` each layer's input, one layer's working set (its
  attention scores, projections and MLP hidden, the recurrences' per-step
  states that autograd keeps; the split parts, split cells' states
  among them, 1/m of it), the logits
  with their fp32 copy and gradient (1/m where the vocab is split), and
  the fetched weights of one layer and of the embeddings (a split
  weight's 1/m).  It is an estimate, labelled so;
* the total is held against the planned card's device memory
  (``hardware.H100[hardware.PLANNED]["hbm_bytes"]``, ``fits``);
* FLOPs are the plan's per rank: ``model_flops`` per token over this
  rank's rows, the weights the plan splits over ``"model"`` counted 1/m
  (``analysis.active_params_per_rank``; the train and serving steps
  split alike), times the step's passes (forward, backward, the
  recompute), plus attention's score and value products (1/m where the
  heads are split, 1/data where one row's slots are); HBM bytes the plan's
  reads of the fetched weights, the optimizer's pass over its shards,
  the activations and the cache; collective bytes
  ``roofline/analysis.py::plan_collective_bytes``.

It does not run the step on meta tensors: the recurrences step a Python
loop over time (``models/ssm.py``), so a ``prefill_32k`` cell would take
hours.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out runs/dryrun.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from ..configs.shapes import SHAPES, cell_status
from ..distributed import sharding
from ..distributed.sharding import mesh_sizes, param_specs, shard_factor
from ..models import registry
from ..models.blockwise_attn import should_use_blockwise
from ..models.transformer import Transformer, kv_len
from ..roofline import analysis
from ..roofline import hardware as hw
from .mesh import production_shape

PLAN = ("port: parameters, AdamW m and v and gradients placed by "
        "distributed/sharding.py::param_specs; batch rows over pod x data; "
        "each layer's weights gathered over data, and over model only "
        "where the plan cannot split there (off-boundary KV heads, MLA's "
        "wq_down, a split Mamba's w_in, an mLSTM's wq and wk split by value "
        "columns); attention heads, MLP hidden units, MoE experts (or their "
        "hidden units), the recurrent cells (mLSTM heads or value columns, "
        "sLSTM and Mamba channels) and the vocab split over model, with "
        "activation all-reduces there; bytes and FLOPs counted from this "
        "plan, not from HLO")
#: the prefill, decode and long-context cells' plan: ``serve/steps.py`` on
#: a sharded model (``analysis.step_plan``)
SERVING_PLAN = (
    "port: serve/steps.py on a model placed by distributed/sharding.py::"
    "param_specs; rows over pod x data where they divide, else data, else "
    "every row; each layer's weights gathered over data, and over model "
    "only the plan's exceptions (off-boundary KV heads, MLA's wq_down, a "
    "split Mamba's w_in, an mLSTM's wq and wk split by value columns); "
    "attention heads, MLP hidden units, MoE experts (or their hidden "
    "units), the recurrent cells and the vocab split over model as in "
    "training, with activation all-reduces there; the cache's KV heads and "
    "recurrent states split over model where the plan splits them, one "
    "row's slots over data with a "
    "log-sum-exp merge; the logits' vocab and rows gathered at the end; "
    "bytes and FLOPs counted from this plan, not from HLO")

ATTN_KINDS = ("dense", "swa", "moe", "moe_swa", "mla", "encoder", "hybrid",
              "hybrid_global")
HBM_BYTES = hw.H100[hw.PLANNED]["hbm_bytes"]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return _nbytes(tree)


def input_bytes(cfg, shape) -> int:
    """The batch every rank is handed (the whole global batch: each rank
    takes its rows in the step), built on meta."""
    B, S = shape.global_batch, shape.seq_len
    meta = dict(device="meta")
    if shape.kind == "decode":
        return _nbytes(torch.empty((B,), dtype=torch.int32, **meta))
    if cfg.encoder_only:
        n = _nbytes(torch.empty((B, S, cfg.d_model), dtype=torch.bfloat16,
                                **meta))
        if shape.kind == "train":
            n += _nbytes(torch.empty((B, S), dtype=torch.int32, **meta))
        return n
    return _nbytes(torch.empty((B, S), dtype=torch.int32, **meta))


def _attn_dims(cfg, kind):
    """(heads, head dim of the scores) of a block kind's attention."""
    if kind == "mla":
        return cfg.n_heads, cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
    return cfg.n_heads, cfg.resolved_head_dim


def _kv_len(cfg, kind, shape) -> int:
    if shape.kind != "decode":
        return shape.seq_len
    return kv_len(kind, cfg, shape.seq_len)


def _slots(cfg, kind, shape, sizes) -> int:
    """Into how many runs a decode cell's ``kind`` layer splits its slots
    (``sharding.slots_split``: one row's, over ``"data"``)."""
    if shape.kind != "decode" or not sizes or not sharding.slots_split(
            shape.global_batch, _kv_len(cfg, kind, shape), sizes):
        return 1
    return sizes["data"]


def attention_flops(cfg, shape, rows: int, sizes=None) -> float:
    """Forward score and value products of every attention layer over
    ``rows`` rows: 4 * rows * S * T * H * D a layer (T over this rank's
    slots on a mesh of ``sizes``)."""
    S = 1 if shape.kind == "decode" else shape.seq_len
    total = 0.0
    for kind, count in cfg.segments:
        if kind not in ATTN_KINDS:
            continue
        H, D = _attn_dims(cfg, kind)
        total += (count * 4.0 * rows * S * _kv_len(cfg, kind, shape) * H * D
                  / _slots(cfg, kind, shape, sizes))
    return total


def _layer_working_bytes(cfg, kind, shape, rows: int, item: int,
                         grad: bool, split=frozenset(), m: int = 1) -> float:
    """One layer's live activations while it runs (an estimate); the
    parts of the regions in ``split`` (the train plan's, ``models/
    transformer.py::REGIONS``) 1/m, split over ``"model"`` of ``m``."""
    def part(*regions):
        return 1.0 / m if split & set(regions) else 1.0

    S = 1 if shape.kind == "decode" else shape.seq_len
    tok = rows * S
    d = cfg.d_model
    out = 4.0 * tok * d * item                      # norms, residuals
    if kind in ATTN_KINDS:
        H, D = _attn_dims(cfg, kind)
        T = _kv_len(cfg, kind, shape)
        a = tok * (2 * H * D + 2 * cfg.n_kv_heads * D) * item
        if should_use_blockwise(rows, S, T, H):
            a += 2.0 * rows * H * min(S, 512) * min(T, 1024) * 4
        else:
            a += 2.0 * rows * H * S * T * 4         # fp32 scores and probs
        out += a * part("attn")
    if kind in ("moe", "moe_swa"):
        dff = cfg.d_expert or cfg.d_ff
        slots = tok * cfg.top_k * cfg.capacity_factor
        out += slots * (d + 3 * dff) * item * part("experts", "expert_hidden")
        out += tok * 3 * dff * cfg.n_shared_experts * item * part("shared")
    elif kind in ("mlstm", "slstm"):
        dk = d // cfg.n_heads
        per_step = (cfg.n_heads * dk * dk if kind == "mlstm" else 8 * d) * 4
        # autograd keeps each step's state: the rank's heads, value
        # columns or channels of it where the cell is split
        out += rows * per_step * (S if grad else 1) * part(
            "cell", "cell_values")
    elif kind in ATTN_KINDS:
        out += tok * 3 * cfg.d_ff * item * part("mlp")
    if kind in ("hybrid", "hybrid_global"):
        di = cfg.ssm_expand * d
        out += (rows * di * cfg.ssm_state * 4 * (S if grad else 1)
                + tok * 3 * di * item) * part("cell")
    return out


def activation_estimate(cfg, shape, rows: int, microbatches: int,
                        shapes: dict, plan=None, m: int = 1) -> dict:
    """Live bytes besides the state (module docstring), by part; ``plan``
    (``analysis.step_plan``) splits a cell's parts over ``"model"`` of
    ``m`` ranks."""
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    train = shape.kind == "train"
    modes = plan.modes if plan else {}
    kinds = [k for k, c in cfg.segments for _ in range(c)]
    split = dict(zip(kinds, plan.layers)) if plan else {}

    mb_rows = rows // microbatches if train else rows
    S = 1 if shape.kind == "decode" else shape.seq_len
    tok = mb_rows * S
    out = {}
    if train and cfg.remat == "layer":
        out["layer_inputs"] = float(cfg.n_layers * tok * cfg.d_model * item)
    elif train:
        out["layer_inputs"] = float(sum(
            count * _layer_working_bytes(cfg, kind, shape, mb_rows, item,
                                         True, split.get(kind, frozenset()),
                                         m)
            for kind, count in cfg.segments))
    out["one_layer"] = max(_layer_working_bytes(
        cfg, kind, shape, mb_rows, item, train, split.get(kind, frozenset()),
        m) for kind, _ in cfg.segments)
    logit_rows = tok if (train or cfg.encoder_only) else mb_rows
    vocab = cfg.vocab / (m if plan and "vocab" in plan.top else 1)
    out["logits"] = float(logit_rows * vocab * (item + (8 if train else 4)))
    layer_bytes = {}
    top = 0.0
    for name, (s, it) in shapes.items():
        nb = math.prod(s) * it / (m if modes.get(name) == "local" else 1)
        if name.startswith("layers."):
            i = int(name.split(".")[1])
            layer_bytes[i] = layer_bytes.get(i, 0) + nb
        else:
            top += nb
    gathered = max(layer_bytes.values()) + top
    out["gathered_weights"] = float(gathered * (2 if train else 1))
    return out


def lower_cell(arch: str, shape_name: str, mesh, *, microbatches: int = 1,
               cfg=None, shape=None) -> dict:
    """The record of one cell on ``mesh`` (``{axis: size}`` or a
    ``DeviceMesh``).  ``cfg``/``shape`` override the registry's and
    ``SHAPES`` (reduced cells in the tests run the same path)."""
    cfg = cfg or registry.get_config(arch)
    shape = shape or SHAPES[shape_name]
    status = cell_status(cfg, shape)
    if status != "run":
        return {"arch": arch, "shape": shape_name, "status": status}
    sizes = mesh_sizes(mesh)
    n_dev = math.prod(sizes.values())
    train = shape.kind == "train"
    rows = sharding.rows_per_rank(shape.global_batch, sizes)
    if train and rows % microbatches:
        raise ValueError(f"{rows} rows a rank do not split into "
                         f"{microbatches} microbatches")
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    tokens_rank = rows * (1 if shape.kind == "decode" else shape.seq_len)

    model = Transformer(cfg, device="meta")
    shapes = {n: (tuple(p.shape), p.element_size())
              for n, p in model.named_parameters()}
    specs = param_specs({n: s for n, (s, _) in shapes.items()}, sizes)
    elems = {n: math.prod(s) / shard_factor(specs[n], sizes)
             for n, (s, _) in shapes.items()}
    per_rank = {"params": sum(elems[n] * shapes[n][1] for n in shapes)}
    if train:
        per_rank["opt_m_v"] = sum(8.0 * e for e in elems.values())
        per_rank["grads"] = sum(
            elems[n] * (4 if microbatches > 1 else shapes[n][1])
            for n in shapes)
    per_rank["batch"] = float(input_bytes(cfg, shape))
    plan = analysis.step_plan(cfg, sizes)
    modes = plan.modes
    cache = 0.0
    if not train and not cfg.encoder_only:
        # the rank's piece of the cache (the prefill builds the one decode
        # reads)
        cache = float(_tree_bytes(model.rank_cache(
            shape.global_batch, shape.seq_len, sizes, plan.layers)))
        per_rank["cache"] = cache
    m = sizes.get("model", 1)
    est = activation_estimate(cfg, shape, rows, microbatches, shapes,
                              plan, m)
    per_rank["activation_estimate"] = sum(est.values())
    total = sum(per_rank.values())

    # FLOPs and HBM bytes of the plan, per rank
    passes = (4 if cfg.remat == "layer" else 3) if train else 1
    attn_split = m if any("attn" in s for s in plan.layers) else 1
    active = analysis.active_params_per_rank(cfg, sizes)
    flops = (passes * 2.0 * active * tokens_rank
             + passes * attention_flops(cfg, shape, rows, sizes)
             / attn_split)
    fetched = sum(math.prod(s) * it / (m if modes.get(n) == "local" else 1)
                  for n, (s, it) in shapes.items())
    weight_reads = (3 if cfg.remat == "layer" else 2) if train else 1
    hbm = weight_reads * fetched * (microbatches if train else 1)
    if train:
        hbm += sum(e * (3 * shapes[n][1] + 16) for n, e in elems.items())
        hbm += 2 * est["layer_inputs"] + 2 * est["logits"]
    else:
        hbm += cache + est["logits"]
    wires = analysis.plan_collective_bytes(
        cfg, sizes, shape.kind, microbatches=microbatches,
        tokens=tokens_rank, batch=shape.global_batch,
        cache_len=shape.seq_len, seq=shape.seq_len)
    mf = analysis.model_flops(cfg, tokens, "train" if train else "serve")
    roof = analysis.analyze_from(
        flops=flops, hbm_bytes=hbm, nvlink_bytes=wires["nvlink"],
        net_bytes=wires["net"], peak_mem=int(total), n_devices=n_dev,
        model_flops_total=mf, by_kind=wires["by_kind"])
    return {
        "arch": arch, "shape": shape_name, "status": "ok",
        "plan": PLAN if train else SERVING_PLAN,
        "mesh": "x".join(str(v) for v in sizes.values()),
        "n_devices": n_dev, "rows_per_rank": rows,
        "microbatches": microbatches if train else 1,
        "tokens_per_step": tokens,
        "per_rank_bytes": {**per_rank, "total": total},
        "activation_estimate_parts": est,
        "hbm_bytes": HBM_BYTES, "fits": total <= HBM_BYTES,
        "roofline": roof.as_dict(),
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--kv-int8", action="store_true",
                    help="quantized int8 decode KV cache")
    ap.add_argument("--out", default="runs/dryrun.jsonl")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    archs = registry.list_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                done.add((r["arch"], r["shape"], r["mesh_kind"]))

    written = []
    with open(args.out, "a") as f:
        for mesh_kind in meshes:
            dims, axes = production_shape(multi_pod=mesh_kind == "multi")
            mesh = dict(zip(axes, dims))
            for arch in archs:
                for shape in shapes:
                    if (arch, shape, mesh_kind) in done:
                        continue
                    t0 = time.time()
                    try:
                        cfg_cell = registry.get_config(arch)
                        if args.kv_int8:
                            cfg_cell = dataclasses.replace(
                                cfg_cell, kv_cache_dtype="int8")
                        rec = lower_cell(arch, shape, mesh, cfg=cfg_cell,
                                         microbatches=args.microbatches)
                    except Exception as e:  # record failures; they are bugs
                        rec = {"arch": arch, "shape": shape, "status": "FAIL",
                               "error": f"{type(e).__name__}: {e}",
                               "trace": traceback.format_exc()[-2000:]}
                    rec["mesh_kind"] = mesh_kind
                    rec["wall_s"] = round(time.time() - t0, 3)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                    written.append(rec)
                    status = rec["status"]
                    extra = ""
                    if status == "ok":
                        r = rec["roofline"]
                        extra = (f" per-rank {rec['per_rank_bytes']['total'] / 1e9:.2f} GB"
                                 f" (fits {rec['fits']}) bottleneck={r['bottleneck']}"
                                 f" t=({r['t_compute']:.4f},{r['t_memory']:.4f},"
                                 f"{r['t_collective']:.4f})s")
                    elif status == "FAIL":
                        extra = " " + rec["error"][:200]
                    print(f"[{mesh_kind}] {arch} x {shape}: {status}"
                          f" ({rec['wall_s']}s){extra}", flush=True)
    return written


if __name__ == "__main__":
    main()
