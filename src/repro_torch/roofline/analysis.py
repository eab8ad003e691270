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
of the NB-tree's impl calls from their ``dispatch_stats``.
"""
from __future__ import annotations

import dataclasses
import math

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


def measured_kernel_table(dispatch_stats: dict, *,
                          peak_bw: float = hw.H100[hw.PLANNED]["hbm_bw"]
                          ) -> list:
    """Measured per-impl achieved bandwidth from dispatch stats.

    ``dispatch_stats`` is ``NBTreeIndex.dispatch_stats`` (populated while
    a tracer is attached): impl name -> ``{count, wall_s, bytes}``, with
    ``bytes`` the argument + result footprint of each call (a lower bound
    on its HBM traffic) and ``wall_s`` the host's clock around it.  Each
    row adds the achieved GB/s and its share of ``peak_bw`` (default: the
    H100 SXM's HBM rate), sorted by total wall time.
    """
    rows = []
    for name, st in dispatch_stats.items():
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
    def __init__(self, sizes: dict):
        self.sizes = sizes
        self.out = {"nvlink": 0.0, "net": 0.0, "by_kind": {}}

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


def plan_collective_bytes(cfg, mesh_sizes: dict, kind: str, *,
                          microbatches: int = 1) -> dict:
    """Per-rank wire bytes of one step of the port's plan on a mesh of
    ``mesh_sizes`` (``{axis: size}``, axes in mesh order), by fabric and by
    collective: ``{"nvlink", "net", "by_kind"}``.

    Counts the plan of ``distributed/sharding.py``, not HLO:

    * every parameter is all-gathered to full over the mesh axes that
      shard it, in mesh order, once a forward; under ``remat == "layer"``
      a block's weights once more for the backward's recompute;
    * ``train``: the backward returns each gradient to its shard in fp32:
      a reduce-scatter over ``"data"`` where the weight is sharded there,
      an all-reduce where it is replicated, an all-reduce over ``"model"``
      for a weight replicated there; these and the gathers happen once a
      microbatch; then one all-reduce of each fp32 shard over ``"pod"``
      (``grad_compression`` sums its int8 values as int32 there, as the
      reference's ``psum``: the same 4 bytes an element);
    * scalars (the loss, the norm, the MoE fractions) are not counted.
    """
    from ..distributed.sharding import param_specs

    shapes = param_shapes(cfg)
    specs = param_specs({n: s for n, (s, _) in shapes.items()}, mesh_sizes)
    axes = list(mesh_sizes)
    wire = _Wire(mesh_sizes)
    train = kind == "train"
    passes = microbatches if train else 1
    for name, (shape, item) in shapes.items():
        spec = specs[name]
        elems = float(math.prod(shape))
        sharded = [a for a in axes if a in spec]
        gathers = passes * (2 if train and cfg.remat == "layer"
                            and name.startswith("layers.") else 1)
        local = elems * item / math.prod(mesh_sizes[a] for a in sharded)
        for a in sharded:                       # forward gathers
            local *= mesh_sizes[a]
            wire.add("all-gather", a, local, gathers)
        if not train:
            continue
        g = elems * 4.0                          # fp32 gradient, full
        if "model" in axes:
            if "model" in sharded:
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
    return wire.out
