"""Three-term roofline of the port's training and serving plan on H100s.

  compute    = FLOPs_per_rank / peak dense bf16 FLOP/s
  memory     = HBM_bytes_per_rank / HBM bytes/s
  collective = nvlink_bytes / NVLink bytes/s + net_bytes / network bytes/s

The reference reads FLOPs and bytes from XLA's compiled cost analysis and
its collectives from the compiled HLO (``collective_wire_bytes``).  A
PyTorch step has no such artifact, so nothing here parses HLO: the
dry-run (``launch/dryrun.py``) counts the plan the port runs
(``distributed/sharding.py``) and :func:`plan_collective_bytes` counts
that plan's collectives.  Wire bytes per rank use the reference's ring
factors:

  all-reduce      2 * s * (g-1)/g      (reduce-scatter + all-gather phases)
  all-gather          r * (g-1)/g      (r = result bytes)
  reduce-scatter      s * (g-1)/g      (s = operand bytes)

A group whose ranks span more than one node (``gpus_per_node``
consecutive ranks of the planned card, ``hardware.PLANNED``) is charged to the network, one inside a node to
NVLink.  ``measured_kernel_table`` is the empirical side: achieved bytes/s
of the NB-tree's impl calls from per-impl totals of their calls.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

from . import hardware as hw


def param_shapes(cfg) -> dict:
    """``{name: (shape, itemsize)}`` of the port's parameters of ``cfg``,
    built on the ``meta`` device (no memory)."""
    from ..models.transformer import Transformer

    model = Transformer(cfg, device="meta")
    return {n: (tuple(p.shape), p.element_size())
            for n, p in model.named_parameters()}


def active_params(cfg) -> float:
    """Parameter count actually touched per token (MoE: top-k + shared)."""
    total = 0.0
    for path, (shape, _) in param_shapes(cfg).items():
        n = float(math.prod(shape))
        if ".moe.w" in path and ".shared." not in path:
            n *= cfg.top_k / max(1, cfg.n_experts)   # routed experts
        total += n
    return total


class StepPlan(NamedTuple):
    """The plan of a config on a mesh (:func:`step_plan`) that the sharded
    train step and the sharded serving steps (``serve/steps.py``) both
    run: ``modes``, ``{name: mode}`` of every parameter
    (``sharding.MODES``); ``layers``, each layer's regions split over
    ``"model"`` (``models/transformer.py::REGIONS``); ``top``, the top
    weights' ("vocab" where the vocab is split)."""
    modes: dict
    layers: list
    top: frozenset


def step_plan(cfg, sizes: dict) -> StepPlan:
    """The :class:`StepPlan` on a mesh of ``sizes``: each block's by
    ``models/transformer.py::model_plan``, the top weights' by its
    ``vocab_plan`` (the functions the step runs), fed the ``"model"`` cuts
    of ``param_specs``; mode "full" where they name none."""
    from ..distributed.sharding import param_specs, spec_model_cut
    from ..models.transformer import model_plan, vocab_plan

    shapes = {n: s for n, (s, _) in param_shapes(cfg).items()}
    specs = param_specs(shapes, sizes)
    cuts = {n: spec_model_cut(s, specs[n], sizes) for n, s in shapes.items()}
    modes = dict.fromkeys(shapes, "full")
    layers = []
    for i, kind in enumerate(_kinds(cfg)):
        pre = f"layers.{i}."
        plan = model_plan(kind, cfg, {n[len(pre):]: c for n, c in
                                      cuts.items() if n.startswith(pre)})
        modes.update({pre + n: m for n, m in plan.modes.items()})
        layers.append(plan.split)
    top = vocab_plan({n: c for n, c in cuts.items()
                      if not n.startswith("layers.")})
    modes.update(top.modes)
    return StepPlan(modes, layers, top.split)


def active_params_per_rank(cfg, sizes: dict) -> float:
    """:func:`active_params` of one rank of the sharded train or serving
    step: a weight the plan keeps split over ``"model"``
    (:func:`step_plan`) counts 1/m, and so does a weight a split cell
    gathers and slices to the rank's channels (a Mamba's ``w_in``), or
    1/H where it slices it to one of H heads (an mLSTM's ``wq wk wi wf``
    in "cell_values"); the rest counts in full (every rank of the axis
    repeats that compute)."""
    from ..models.ssm import CELL_REGIONS

    plan = step_plan(cfg, sizes)
    m = sizes.get("model", 1)
    total = 0.0
    for path, (shape, _) in param_shapes(cfg).items():
        n = float(math.prod(shape))
        if ".moe.w" in path and ".shared." not in path:
            n *= cfg.top_k / max(1, cfg.n_experts)
        mode = plan.modes[path]
        split = (plan.layers[int(path.split(".")[1])]
                 if path.startswith("layers.") else plan.top)
        if mode == "local":
            n /= m
        elif mode == "partial" and ".cell." in path and split & CELL_REGIONS:
            heads = "cell_values" in split and path.endswith(
                (".wq", ".wk", ".wi", ".wf"))
            n /= cfg.n_heads if heads else m
        total += n
    return total


def model_flops(cfg, tokens: int, kind: str) -> float:
    """6*N*D (training) / 2*N*D (inference fwd) with N = *active* params."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * active_params(cfg) * tokens


@dataclasses.dataclass
class Roofline:
    flops_per_dev: float
    hbm_bytes_per_dev: float
    nvlink_bytes_per_dev: float
    net_bytes_per_dev: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops_total: float
    useful_flops_ratio: float
    peak_mem_bytes: int
    by_kind: dict

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze_from(*, flops: float, hbm_bytes: float, nvlink_bytes: float,
                 net_bytes: float, peak_mem: int, n_devices: int,
                 model_flops_total: float, by_kind: dict) -> Roofline:
    """Roofline from per-rank totals, at the planned card's rates."""
    card = hw.H100[hw.PLANNED]
    t_c = flops / card["bf16_flops"]
    t_m = hbm_bytes / card["hbm_bw"]
    t_x = nvlink_bytes / card["nvlink_bw"] + net_bytes / card["net_bw"]
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops_total / max(1.0, flops * n_devices)
    return Roofline(flops, hbm_bytes, nvlink_bytes, net_bytes,
                    t_c, t_m, t_x, bottleneck, model_flops_total, useful,
                    peak_mem, by_kind)


def measured_kernel_table(impl_stats: dict, *,
                          peak_bw: float = hw.H100[hw.PLANNED]["hbm_bw"]
                          ) -> list:
    """Measured per-impl achieved bandwidth from per-impl call totals.

    ``impl_stats``: impl name -> ``{count, wall_s, bytes}``, the totals
    of its calls (e.g. summed from ``NBTreeIndex``'s ``dispatch`` spans,
    whose durations are the host's clock around each call), ``bytes`` the
    HBM traffic the caller counts for them (0 where it counts none).  Each
    row adds the achieved GB/s and its share of ``peak_bw`` (default: the
    H100 SXM's HBM rate), sorted by total wall time.
    """
    rows = []
    for name, st in impl_stats.items():
        wall = float(st.get("wall_s", 0.0))
        nbytes = float(st.get("bytes", 0.0))
        bw = nbytes / wall if wall > 0 else 0.0
        rows.append({
            "kernel": name,
            "count": int(st.get("count", 0)),
            "wall_s": wall,
            "bytes": int(nbytes),
            "achieved_gb_s": bw / 1e9,
            "peak_frac": bw / peak_bw if peak_bw > 0 else 0.0,
        })
    rows.sort(key=lambda r: r["wall_s"], reverse=True)
    return rows


# ------------------------------------------------------- the plan's traffic
def fabric(sizes: dict, axis: str) -> str:
    """"nvlink" if a group of ``axis`` (ranks numbered row-major over the
    mesh's axes, in order) lies inside one node, else "net"."""
    names = list(sizes)
    stride = math.prod(sizes[a] for a in names[names.index(axis) + 1:])
    per_node = hw.H100[hw.PLANNED]["gpus_per_node"]
    return "nvlink" if stride * sizes[axis] <= per_node else "net"


class _Wire:
    """Wire bytes by fabric and by collective, and ``by_axis``: ``{"kind/
    axis": bytes}`` as ``sharding.wire_counts`` counts a step's (an
    all-gather's received bytes, an all-reduce's or a reduce-scatter's
    operand)."""

    def __init__(self, sizes: dict):
        self.sizes = sizes
        self.out = {"nvlink": 0.0, "net": 0.0, "by_kind": {}, "by_axis": {}}

    def add(self, kind: str, axis: str, nbytes: float, times: float = 1):
        g = self.sizes[axis]
        if g <= 1 or times == 0:
            return
        frac = (g - 1) / g
        wire = (2 * nbytes if kind == "all-reduce" else nbytes) * frac * times
        self.out[fabric(self.sizes, axis)] += wire
        k = self.out["by_kind"].setdefault(kind, {"count": 0, "bytes": 0.0})
        k["count"] += times
        k["bytes"] += wire
        key = f"{kind}/{axis}"
        self.out["by_axis"][key] = self.out["by_axis"].get(key, 0.0) + (
            nbytes * frac if kind == "all-gather" else nbytes) * times


def plan_collective_bytes(cfg, mesh_sizes: dict, kind: str, *,
                          microbatches: int = 1, tokens: int = 0,
                          batch: int = 0, cache_len: int = 0,
                          seq: int = 0) -> dict:
    """Per-rank wire bytes of one step of the port's plan on a mesh of
    ``mesh_sizes`` (``{axis: size}``, axes in mesh order), by fabric and by
    collective: ``{"nvlink", "net", "by_kind"}``; ``tokens`` are the
    rank's tokens a step (its rows x the sequence), ``seq`` a train
    step's sequence (needed where it splits an sLSTM), ``batch`` a serving
    step's global rows and ``cache_len`` its decode cache's length.

    Counts the plan of ``distributed/sharding.py``, not HLO.  ``train``
    (the sharded step, split over ``"model"``; its :func:`step_plan`):

    * a weight is all-gathered over ``"data"`` where it is sharded there,
      and over ``"model"`` only where the plan gathers it ("full" or
      "partial": an off-boundary KV projection, MLA's ``wq_down``, a
      split Mamba's ``w_in``, an mLSTM's ``wq``/``wk`` split by value
      columns, a cell that does not split), once a forward and, under
      ``remat == "layer"``,
      once more for a block's recompute: a split weight moves 1/m of its
      bytes over ``"data"``;
    * the backward returns each gradient to its shard in fp32: over
      ``"model"`` a "partial" weight's is reduce-scattered (all-reduced
      where it is replicated there), a weight replicated there all-reduced
      (its mean), a split one stays; over ``"data"`` a reduce-scatter
      where the weight is sharded there, else an all-reduce; these and the
      gathers happen once a microbatch; then one all-reduce of each fp32
      shard over ``"pod"`` (``grad_compression`` sums its int8 values as
      int32 there, as the reference's ``psum``: the same 4 bytes an
      element);
    * activations over ``"model"``, per microbatch: each split attention,
      MLP or shared-expert MLP all-reduces its output (the model dtype)
      in the forward and its input's gradient in the backward; a split
      MoE its fp32 combine and, in the backward, its input's and its
      gates' gradients; under ``remat == "layer"`` the recompute repeats
      the forward all-reduces up to the block's last saved tensor
      (PyTorch's checkpoint stops there): all but a split MLP's or a
      split mLSTM's or sLSTM's output, after which a block runs only its
      residual add (an MoE block's balance term runs after its experts,
      so it repeats them all); a split vocab all-reduces the
      embedding's output, the unembedding's input gradient, and the
      loss's max, sum of exps and gold logit (fp32, a token each);
    * a split cell (``models/ssm.py``) all-reduces its output (the model
      dtype) and its input's gradient as a split attention does; an
      mLSTM or sLSTM the fp32 sum of squares of its norm (a token each),
      a Mamba its fp32 B, C and dt (2N + 1 a token), each once forward
      and once backward; an sLSTM all-gathers its ``h`` (the model
      dtype) each step and reduce-scatters its fp32 gradient each step
      of the backward but the first (its zero state carries none),
      counted as one collective of all the steps' bytes, and its
      recompute repeats the gathers;
    * a MoE layer whose tokens fall back to one dispatch group
      (``models/moe.py::dispatch_groups``) all-gathers its input rows over
      the data-parallel axes, once a forward and once more in a block's
      recompute, and reduce-scatters their gradient back; its routed
      combine, gates and input gradient then span every rank's rows;
    * scalars (the loss, the norm, the MoE fractions) are not counted.

    ``prefill`` and ``decode`` (the sharded serving steps of
    ``serve/steps.py``, on the same :func:`step_plan`; an encoder-only
    ``prefill`` is the encode step), once a step over the rows of
    ``sharding.row_axes(batch)``: each weight gathered as the train
    plan's forward does (over ``"data"``, and over ``"model"`` only the
    exceptions), no gradient; with ``tokens``, the split regions'
    all-reduces of their outputs over ``"model"`` (the vocab-parallel
    embedding's too, and a split cell's sums and its sLSTM's step
    gathers); a MoE layer's row gathers where it falls back to
    one group, and in a prefill the balance term's fractions (fp32, E
    each) all-reduced over each row axis; in a decode step of one row
    whose slots split over ``"data"`` (``sharding.slots_split``), each
    attention layer's merge there (the max, then the sums of exps and of
    weighted values in one all-reduce, fp32); then the outputs made
    whole: a prefill's last logits or the encode step's logits gathered
    over ``"model"`` (the vocab) and then over the row axes, a decode
    step's greedy ids (the max and the lowest id over ``"model"``, fp32
    and int64) gathered over the row axes as int32.
    """
    from ..distributed.sharding import param_specs

    shapes = param_shapes(cfg)
    specs = param_specs({n: s for n, (s, _) in shapes.items()}, mesh_sizes)
    axes = list(mesh_sizes)
    wire = _Wire(mesh_sizes)
    train = kind == "train"
    passes = microbatches if train else 1
    plan = step_plan(cfg, mesh_sizes)
    modes = plan.modes
    for name, (shape, item) in shapes.items():
        spec = specs[name]
        mode = modes.get(name, "full")
        elems = float(math.prod(shape))
        sharded = [a for a in axes if a in spec]
        gathers = passes * (2 if train and cfg.remat == "layer"
                            and name.startswith("layers.") else 1)
        local = elems * item / math.prod(mesh_sizes[a] for a in sharded)
        for a in sharded:                       # forward gathers
            if a == "model" and mode == "local":
                continue
            local *= mesh_sizes[a]
            wire.add("all-gather", a, local, gathers)
        if not train:
            continue
        g = elems * 4.0                          # fp32 gradient, full
        if "model" in axes:
            if "model" in sharded:
                if mode == "partial":
                    wire.add("reduce-scatter", "model", g, passes)
                g /= mesh_sizes["model"]
            else:
                wire.add("all-reduce", "model", g, passes)
        if "data" in axes:
            if "data" in sharded:
                wire.add("reduce-scatter", "data", g, passes)
                g /= mesh_sizes["data"]
            else:
                wire.add("all-reduce", "data", g, passes)
        if "pod" in axes:
            wire.add("all-reduce", "pod", g)
    if train and tokens:
        _activation_all_reduces(wire, cfg, plan, tokens / microbatches,
                                passes, seq)
    if not train and tokens:
        _serving_activations(wire, cfg, plan,
                             kind, tokens, batch, cache_len)
    return wire.out


def _item(cfg) -> int:
    return 4 if cfg.dtype == "float32" else 2


def _kinds(cfg) -> list:
    return [k for k, c in cfg.segments for _ in range(c)]


def _moe_gathers(cfg, sizes: dict, tok: float, rows: tuple) -> int:
    """How many ranks' rows a MoE layer dispatches as one group: R where
    the reference's groups over ``tok`` tokens a rank (split over the
    ``rows`` axes, R ranks) fall back to one global group
    (``models/moe.py::dispatch_groups``), else 1 (no gather)."""
    R = math.prod(sizes[a] for a in rows)
    G = sizes.get("pod", 1) * sizes.get("data", 1)
    N = int(tok) * R
    fallback = N % G or (N // G) * cfg.capacity_factor < cfg.n_experts
    return R if fallback and R > 1 else 1


def _row_gather(wire, sizes: dict, rows: tuple, nbytes: float,
                times: float = 1) -> None:
    """All-gathers of ``nbytes`` a rank over the ``rows`` axes, the
    innermost first (``sharding.gather_rows``)."""
    for a in reversed(rows):
        nbytes *= sizes[a]
        wire.add("all-gather", a, nbytes, times)


def _cell_sums(cfg, kind: str, tok: float) -> list:
    """The all-reduces over ``"model"`` of a split cell's forward over
    ``tok`` tokens a rank, in its order (bytes each): the mLSTM's and
    sLSTM's fp32 sum of squares of their norm, or a Mamba's fp32 B, C and
    dt, then the output (the model dtype).  The backward's are the same
    bytes: the sums' gradients and the input's."""
    per_tok = 2 * cfg.ssm_state + 1 if kind in ("hybrid",
                                                 "hybrid_global") else 1
    return [tok * per_tok * 4, tok * cfg.d_model * _item(cfg)]


def _activation_all_reduces(wire, cfg, plan: StepPlan, tok: float,
                            passes: int, seq: int) -> None:
    """The split regions' all-reduces over ``"model"`` of ``passes``
    microbatches of ``tok`` tokens a rank, and the row gathers of the MoE
    layers that fall back to one group (:func:`plan_collective_bytes`)."""
    from ..models.ssm import CELL_REGIONS

    sizes = wire.sizes
    item = _item(cfg)
    act = tok * cfg.d_model * item
    remat = cfg.remat == "layer"
    rows = tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1)
    for kind, split in zip(_kinds(cfg), plan.layers):
        R = (_moe_gathers(cfg, sizes, tok, rows)
             if kind in ("moe", "moe_swa") else 1)
        if R > 1:                       # forward (and recompute) gathers,
            _row_gather(wire, sizes, rows, act, passes * (1 + remat))
            n = act * R                 # the gradient's reduce-scatters
            for a in rows:
                wire.add("reduce-scatter", a, n, passes)
                n /= sizes[a]
        if "model" not in sizes:
            continue
        routed = split & {"experts", "expert_hidden"}
        cell = _cell_sums(cfg, kind, tok) if split & CELL_REGIONS else []
        fwd = ([act] if "attn" in split else []) + cell + (
            [tok * R * cfg.d_model * 4] if routed else []) + (
            [act] if split & {"mlp", "shared"} else [])
        last = "mlp" in split or (bool(cell) and kind in ("mlstm", "slstm"))
        rec = fwd[:-1] if last else fwd
        bwd = ([act] if "attn" in split else []) + cell + (
            [act] if split & {"mlp", "shared"} else [])
        if cell and kind == "slstm":
            if not seq:
                raise ValueError("a split sLSTM's step collectives need "
                                 "the train step's seq")
            wire.add("all-gather", "model", act, passes * (1 + remat))
            wire.add("reduce-scatter", "model",
                     tok * (seq - 1) / seq * cfg.d_model * 4, passes)
        if routed:
            bwd.append(tok * R * cfg.top_k * 4)          # the gates
            if "shared" not in split or R > 1:           # the input's own
                bwd.append(act * R)
        for nbytes in fwd + bwd + (rec if remat else []):
            wire.add("all-reduce", "model", nbytes, passes)
    if "vocab" in plan.top:
        if not cfg.encoder_only:                          # the embedding
            wire.add("all-reduce", "model", act, passes)
        wire.add("all-reduce", "model", act, passes)      # logits' input
        wire.add("all-reduce", "model", tok * 4, 3 * passes)   # the loss


def _serving_activations(wire, cfg, plan: StepPlan, kind: str,
                         tokens: float, batch: int, cache_len: int) -> None:
    """A serving step's activation collectives (:func:`
    plan_collective_bytes`): ``tokens`` a rank over the rows of a
    ``batch``-row batch."""
    from ..distributed.sharding import row_axes, rows_per_rank, slots_split
    from ..models.ssm import CELL_REGIONS
    from ..models.transformer import kv_len

    sizes = wire.sizes
    item, d = _item(cfg), cfg.d_model
    rows = row_axes(batch, sizes)
    B = rows_per_rank(batch, sizes)
    seq = tokens / B
    act = tokens * d * item
    m = sizes.get("model", 1)
    if "vocab" in plan.top and not cfg.encoder_only:
        wire.add("all-reduce", "model", act)              # the embedding
    for lk, split in zip(_kinds(cfg), plan.layers):
        if "attn" in split:
            wire.add("all-reduce", "model", act)
        if split & CELL_REGIONS:
            for nbytes in _cell_sums(cfg, lk, tokens):
                wire.add("all-reduce", "model", nbytes)
            if lk == "slstm":
                wire.add("all-gather", "model", act)
        if lk in ("moe", "moe_swa"):
            R = _moe_gathers(cfg, sizes, tokens, rows)
            if R > 1:
                _row_gather(wire, sizes, rows, act)
            if split & {"experts", "expert_hidden"}:
                wire.add("all-reduce", "model", tokens * R * d * 4)
            if kind == "prefill":                         # balance term
                for a in rows:
                    wire.add("all-reduce", a, cfg.n_experts * 4)
        if split & {"mlp", "shared"}:
            wire.add("all-reduce", "model", act)
        if (kind == "decode" and lk not in ("mlstm", "slstm")
                and slots_split(batch, kv_len(lk, cfg, cache_len), sizes)):
            H = cfg.n_heads // (m if "attn" in split else 1)
            D = (cfg.mla.kv_lora_rank if lk == "mla"
                 else cfg.resolved_head_dim)
            wire.add("all-reduce", "data", B * H * 4)          # the max
            wire.add("all-reduce", "data", B * H * (D + 1) * 4)
    V = cfg.vocab // (m if "vocab" in plan.top else 1)
    if kind == "decode":
        if "vocab" in plan.top:
            wire.add("all-reduce", "model", B * 4)        # the max
            wire.add("all-reduce", "model", B * 8)        # the lowest id
        _row_gather(wire, sizes, rows, B * 4)
        return
    out = B * (seq if cfg.encoder_only else 1) * V * item
    if "vocab" in plan.top:
        out *= m
        wire.add("all-gather", "model", out)
    _row_gather(wire, sizes, rows, out)
