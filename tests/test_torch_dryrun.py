"""The port's shapes table, roofline and dry-run against the JAX package's,
on the CPU, with no device and no process group.

Held against JAX: ``all_cells`` over the two registries (40 cells and
their statuses), ``active_params`` and ``model_flops`` for every arch,
``measured_kernel_table`` on the reference test's stats
(``tests/test_obs.py:321``), and, on the four reduced cells of the
reference's ``test_dryrun_lowering_path`` (``tests/test_distributed.py:
139-153``) over (2, 2, 2) mesh sizes, each record's per-rank parameter
bytes against the bytes JAX's ``param_specs`` and ``eval_shape`` give;
``registry.all_configs`` against JAX's.  The port alone: the train plan's
count, split over "model" (qwen3-8b reduced on a (2, 2) mesh; a dense
and a MoE ``train_4k`` cell on 2 x 16 x 16: per-rank FLOPs and the
gathers along "model" and "data"), the serving plan's count (the
serving steps' own layout, whose bytes ``tests/
test_torch_sharded_serving.py`` holds equal to a ``gloo`` step's), the
whole dry-run over all 40 cells x {single, multi} on meta (no record
counts a hypothetical plan; each serving record's wire bytes are
``plan_collective_bytes``'), and its CLI writing and resuming a JSONL;
xlstm-1.3b's ``train_4k`` fitting both production meshes with its
recurrent cells split over "model".
"""
import dataclasses
import json
import math

import jax
import pytest
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import shapes as jshapes
from repro.distributed.sharding import param_specs as jparam_specs
from repro.models import registry as jregistry
from repro.models import transformer as JT
from repro.roofline import analysis as janalysis
from repro_torch.configs import shapes
from repro_torch.distributed.sharding import param_specs
from repro_torch.launch import dryrun
from repro_torch.models import registry
from repro_torch.roofline import analysis, hardware

REDUCED_CELLS = [("train", "qwen3-8b"), ("prefill", "deepseek-moe-16b"),
                 ("decode", "hymba-1.5b"), ("decode", "xlstm-1.3b")]
MESH = {"pod": 2, "data": 2, "model": 2}


def _registry(reg):
    return {a: reg.get_config(a) for a in reg.list_archs()}


def test_all_cells_match_jax():
    got = shapes.all_cells(_registry(registry))
    want = jshapes.all_cells(_registry(jregistry))
    assert len(got) == 40 and got == want
    assert ({n: dataclasses.astuple(s) for n, s in shapes.SHAPES.items()}
            == {n: dataclasses.astuple(s) for n, s in jshapes.SHAPES.items()})


@pytest.mark.parametrize("arch", registry.list_archs())
def test_active_params_and_model_flops_match_jax(arch):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    assert analysis.active_params(cfg) == janalysis.active_params(jcfg)
    for kind in ("train", "serve"):
        assert (analysis.model_flops(cfg, 4096 * 256, kind)
                == janalysis.model_flops(jcfg, 4096 * 256, kind))


def test_measured_kernel_table_matches_reference():
    stats = {
        "_flush_impl": {"count": 4, "wall_s": 2.0, "bytes": 8_190_000_000},
        "_insert_impl": {"count": 100, "wall_s": 0.1, "bytes": 1_000_000},
    }
    assert (analysis.measured_kernel_table(stats, peak_bw=819e9)
            == janalysis.measured_kernel_table(stats, peak_bw=819e9))
    sxm = hardware.H100[hardware.PLANNED]["hbm_bw"]
    assert (analysis.measured_kernel_table(stats)
            == janalysis.measured_kernel_table(stats, peak_bw=sxm))
    zero = analysis.measured_kernel_table({"k": {"count": 1, "wall_s": 0.0,
                                                 "bytes": 10}})
    assert zero[0]["achieved_gb_s"] == 0.0


def _jax_param_bytes_per_rank(jcfg) -> float:
    shapes_ = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    specs = jparam_specs(shapes_, AbstractMesh(tuple(MESH.values()),
                                               tuple(MESH)))
    total = 0.0
    for leaf, spec in zip(jax.tree_util.tree_leaves(shapes_),
                          jax.tree_util.tree_leaves(
                              specs, is_leaf=lambda s: isinstance(
                                  s, jax.sharding.PartitionSpec))):
        k = math.prod(MESH[a] for a in spec if a is not None)
        total += leaf.size * leaf.dtype.itemsize / k
    return total


@pytest.mark.parametrize("kind,arch", REDUCED_CELLS)
def test_lower_cell_on_reduced_cells(kind, arch):
    cfg = registry.get_config(arch).reduced()
    sp = shapes.ShapeSpec("t", 64 if kind != "prefill" else 128,
                          8 if kind != "prefill" else 4, kind)
    rec = dryrun.lower_cell(arch, kind, MESH, cfg=cfg, shape=sp)
    assert rec["status"] == "ok", rec
    assert not dist.is_initialized()
    assert rec["n_devices"] == 8 and rec["mesh"] == "2x2x2"
    assert rec["plan"] == (dryrun.PLAN if kind == "train"
                           else dryrun.SERVING_PLAN)
    per_rank = rec["per_rank_bytes"]
    assert per_rank["params"] == _jax_param_bytes_per_rank(
        jregistry.get_config(arch).reduced())
    assert per_rank["total"] == pytest.approx(
        sum(v for k, v in per_rank.items() if k != "total"))
    assert ("opt_m_v" in per_rank) == (kind == "train")
    assert ("cache" in per_rank) == (kind != "train")
    r = rec["roofline"]
    assert r["flops_per_dev"] > 0 and r["t_memory"] > 0
    assert r["t_collective"] > 0 and r["by_kind"]["all-gather"]["count"] > 0
    assert ("reduce-scatter" in r["by_kind"]) == (kind == "train")
    assert rec["fits"] is True


def test_plan_collective_bytes_counts_the_plan():
    """A (2, 2) data x model mesh on one node, qwen3-8b reduced.  Train
    (the plan split over "model"): every weight is gathered over "data"
    only, a split one 1/2 of it, once a forward and once more for a
    layer's recompute; per weight a reduce-scatter over "data" where it
    is sharded there; the activations' all-reduces over "model" come with
    the tokens.  The serving plan gathers each weight as the train
    plan's forward does, once, with no gradient: over "data" only (1/2
    of a split weight), nothing along "model"."""
    cfg = registry.get_config("qwen3-8b").reduced()
    sizes = {"data": 2, "model": 2}
    train = analysis.plan_collective_bytes(cfg, sizes, "train")
    serve = analysis.plan_collective_bytes(cfg, sizes, "decode")
    assert train["net"] == serve["net"] == 0.0      # 4 ranks, one node
    shapes = analysis.param_shapes(cfg)
    specs = param_specs({n: shape for n, (shape, _) in shapes.items()},
                        sizes)
    plan = analysis.step_plan(cfg, sizes)
    modes = plan.modes
    assert modes["layers.0.attn.wq"] == modes["layers.0.mlp.wo"] == "local"
    assert plan.layers == [{"attn", "kv", "mlp"}] * cfg.n_layers
    assert plan.top == {"vocab"}
    assert modes["embed"] == "local" and modes["final_norm.scale"] == "full"
    want = sum(math.prod(s) * it / (2 if modes[n] == "local" else 1) / 2
               * (2 if n.startswith("layers.") else 1)
               for n, (s, it) in shapes.items() if "data" in specs[n])
    assert train["by_axis"]["all-gather/data"] == want
    assert "all-gather/model" not in train["by_axis"]
    assert serve["by_axis"] == {"all-gather/data": sum(
        math.prod(s) * it / (2 if modes[n] == "local" else 1) / 2
        for n, (s, it) in shapes.items() if "data" in specs[n])}
    assert "reduce-scatter" not in serve["by_kind"]
    n_data = sum("data" in s for s in specs.values())
    assert train["by_kind"]["reduce-scatter"]["count"] == n_data
    acts = analysis.plan_collective_bytes(cfg, sizes, "train", tokens=64)
    assert (acts["by_axis"]["all-reduce/model"]
            > train["by_axis"]["all-reduce/model"])
    assert analysis.fabric({"pod": 2, "data": 16, "model": 16},
                           "model") == "net"
    assert analysis.fabric({"data": 2, "model": 4}, "model") == "nvlink"


@pytest.mark.parametrize("arch", ["qwen3-8b", "mixtral-8x22b"])
def test_train_4k_counts_the_split_plan(arch):
    """A dense and a MoE ``train_4k`` cell on 2 x 16 x 16: the per-rank
    FLOPs count each weight the plan splits over "model" 1/16 and
    attention's scores 1/16; over "model" only the exception weights are
    gathered (mixtral's 8 KV heads do not divide 16 ranks: ``wk`` and
    ``wv``, once a forward and once for the recompute; qwen3-8b's 8 as
    well), each moving 15/16 of its bytes; a split weight crosses "data"
    as 1/16 of itself."""
    cfg = registry.get_config(arch)
    sizes = {"pod": 2, "data": 16, "model": 16}
    rec = dryrun.lower_cell(arch, "train_4k", sizes)
    assert rec["status"] == "ok" and rec["plan"] == dryrun.PLAN
    modes = analysis.step_plan(cfg, sizes).modes
    pshapes = analysis.param_shapes(cfg)
    tokens = rec["rows_per_rank"] * 4096
    passes = 4                                     # remat "layer"
    active = 0.0
    for n, (s, _) in pshapes.items():
        e = float(math.prod(s))
        if ".moe.w" in n and ".shared." not in n:
            e *= cfg.top_k / cfg.n_experts
        active += e / (16 if modes[n] == "local" else 1)
    attn = dryrun.attention_flops(cfg, shapes.SHAPES["train_4k"],
                                  rec["rows_per_rank"])
    assert rec["roofline"]["flops_per_dev"] == pytest.approx(
        passes * 2 * active * tokens + passes * attn / 16)
    assert active < analysis.active_params(cfg) / 8
    gathered = {n.split(".", 2)[2] for n, m in modes.items()
                if m != "local" and n.startswith("layers.")
                and "model" in param_specs(
                    {n: pshapes[n][0]}, sizes)[n]}
    assert gathered == {"attn.wk", "attn.wv"}
    wires = analysis.plan_collective_bytes(cfg, sizes, "train",
                                           tokens=tokens)
    kv = sum(math.prod(s) * it for n, (s, it) in pshapes.items()
             if n.endswith(("attn.wk", "attn.wv")))
    assert wires["by_axis"]["all-gather/model"] == pytest.approx(
        kv * 15 / 16 * 2)
    split_bytes = sum(math.prod(s) * it for n, (s, it) in pshapes.items()
                      if modes[n] == "local" and n.startswith("layers."))
    assert wires["by_axis"]["all-gather/data"] >= split_bytes / 16 * 15 / 16
    assert rec["roofline"]["t_collective"] == pytest.approx(
        wires["nvlink"] / hardware.H100[hardware.PLANNED]["nvlink_bw"]
        + wires["net"] / hardware.H100[hardware.PLANNED]["net_bw"])


@pytest.mark.parametrize("mesh", [{"data": 16, "model": 16},
                                  {"pod": 2, "data": 16, "model": 16}])
def test_xlstm_train_4k_fits_with_its_cells_split(mesh):
    """xlstm-1.3b ``train_4k`` fits 80 GB a rank on both production
    meshes: its 4 mLSTM heads do not divide 16 ranks, so each mLSTM is
    split by value columns (4 ranks a head, ``wq``/``wk`` gathered) and
    each sLSTM by channels; autograd keeps 1/16 of every step's state
    (the one-layer estimate, against the whole state's), and the split
    cells' all-reduces and the sLSTMs' step gathers cross "model"."""
    cfg = registry.get_config("xlstm-1.3b")
    rec = dryrun.lower_cell("xlstm-1.3b", "train_4k", mesh)
    assert rec["status"] == "ok" and rec["fits"] is True
    assert rec["per_rank_bytes"]["total"] < 40e9
    plan = analysis.step_plan(cfg, mesh)
    kinds = [k for k, c in cfg.segments for _ in range(c)]
    assert [s for s in plan.layers] == [
        {"cell_values"} if k == "mlstm" else {"cell"} for k in kinds]
    specs = param_specs({n: s for n, (s, _) in
                         analysis.param_shapes(cfg).items()}, mesh)
    gathered = {n.split(".", 2)[2] for n, m in plan.modes.items()
                if n.startswith("layers.") and m != "local"
                and "model" in specs[n]}
    assert gathered == {"cell.wq", "cell.wk"}
    rows = rec["rows_per_rank"]
    dk = cfg.d_model // cfg.n_heads
    whole = rows * cfg.n_heads * dk * dk * 4 * 4096
    assert rec["activation_estimate_parts"]["one_layer"] < whole / 15
    wires = analysis.plan_collective_bytes(
        cfg, mesh, "train", tokens=rows * 4096, seq=4096)["by_axis"]
    assert wires["all-gather/model"] > 0 and wires["all-reduce/model"] > 0
    assert rec["roofline"]["by_kind"]["reduce-scatter"]["count"] > 0


@pytest.mark.parametrize("arch,shape", [
    ("deepseek-moe-16b", "decode_32k"), ("mixtral-8x22b", "prefill_32k"),
    ("hymba-1.5b", "long_500k"), ("hubert-xlarge", "prefill_32k")])
def test_serving_records_count_the_serving_plan(arch, shape):
    """A serving record on 16 x 16 counts the port's serving plan: its
    wire bytes are ``plan_collective_bytes`` of the step (the rank's
    tokens, the global batch, the cache's length), its cache the piece
    ``Transformer.rank_cache`` lays out (KV heads over "model" where the
    plan splits them, one row's slots over "data"), and its FLOPs the
    split plan's."""
    cfg = registry.get_config(arch)
    sizes = {"data": 16, "model": 16}
    sp = shapes.SHAPES[shape]
    rec = dryrun.lower_cell(arch, shape, sizes)
    assert rec["status"] == "ok" and rec["plan"] == dryrun.SERVING_PLAN
    rows = rec["rows_per_rank"]
    tokens = rows * (1 if sp.kind == "decode" else sp.seq_len)
    wires = analysis.plan_collective_bytes(
        cfg, sizes, sp.kind, tokens=tokens, batch=sp.global_batch,
        cache_len=sp.seq_len)
    assert rec["roofline"]["by_kind"] == json.loads(json.dumps(
        wires["by_kind"]))
    assert rec["roofline"]["nvlink_bytes_per_dev"] == wires["nvlink"]
    assert rec["roofline"]["net_bytes_per_dev"] == wires["net"]
    assert wires["by_axis"]["all-reduce/model"] > 0
    plan = analysis.step_plan(cfg, sizes)
    cache = dryrun._tree_bytes(dryrun.Transformer(cfg, device="meta")
                               .rank_cache(sp.global_batch, sp.seq_len,
                                           sizes, plan.layers))
    assert rec["per_rank_bytes"].get("cache", 0.0) == (
        0.0 if cfg.encoder_only else cache)
    if arch == "deepseek-moe-16b":        # one of 16 KV heads a rank
        full = dryrun._tree_bytes(dryrun.Transformer(cfg, device="meta")
                                  .init_cache(rows, sp.seq_len))
        assert cache < full / 15
    if shape == "long_500k":              # one row: slots over "data"
        assert rows == 1
        assert wires["by_axis"]["all-reduce/data"] > 0
    active = analysis.active_params_per_rank(cfg, sizes)
    assert active < analysis.active_params(cfg)
    assert rec["roofline"]["flops_per_dev"] >= 2 * active * tokens


def test_dryrun_all_cells_on_meta(tmp_path, capsys):
    """All 40 cells x {single, multi}: the statuses of ``all_cells``, and
    every ``run`` cell ``ok`` with per-rank bytes and the three terms;
    a second run resumes and writes nothing."""
    out = tmp_path / "d.jsonl"
    recs = dryrun.main(["--all", "--mesh", "both", "--out", str(out)])
    assert not dist.is_initialized()
    assert len(recs) == 80
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert lines == json.loads(json.dumps(recs))
    want = shapes.all_cells(_registry(registry))
    for kind in ("single", "multi"):
        got = [(r["arch"], r["shape"], r["status"]) for r in recs
               if r["mesh_kind"] == kind]
        assert [(a, s) for a, s, _ in got] == [(a, s) for a, s, _ in want]
        for (_, _, status), (_, _, w) in zip(got, want):
            assert status == ("ok" if w == "run" else w)
    for r in recs:
        if r["status"] == "ok":
            assert "hypothetical" not in r["plan"]
            assert r["plan"] == (dryrun.PLAN if r["shape"] == "train_4k"
                                 else dryrun.SERVING_PLAN)
            assert r["n_devices"] == (256 if r["mesh_kind"] == "single"
                                      else 512)
            assert r["per_rank_bytes"]["total"] > 0
            assert r["hbm_bytes"] == 80e9
            assert {"t_compute", "t_memory", "t_collective"} <= set(
                r["roofline"])
    assert dryrun.main(["--all", "--mesh", "both", "--out", str(out)]) == []
    assert len(out.read_text().splitlines()) == 80
    assert "qwen3-8b x train_4k: ok" in capsys.readouterr().out


def test_dryrun_cli_writes_and_resumes(tmp_path):
    out = tmp_path / "one.jsonl"
    first = dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k",
                         "--mesh", "single", "--kv-int8", "--out", str(out)])
    assert [r["status"] for r in first] == ["ok"]
    assert first[0]["mesh_kind"] == "single" and first[0]["mesh"] == "16x16"
    plain = dryrun.lower_cell("qwen3-8b", "decode_32k",
                              {"data": 16, "model": 16})
    # int8 K/V with fp32 scales: under half the bf16 cache
    assert (first[0]["per_rank_bytes"]["cache"]
            < plain["per_rank_bytes"]["cache"] * 0.6)
    more = dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k",
                        "--mesh", "both", "--out", str(out)])
    assert [r["mesh_kind"] for r in more] == ["multi"]
    assert len(out.read_text().splitlines()) == 2


def test_all_configs_match_jax():
    """``registry.all_configs`` equals the JAX package's, arch by arch and
    field by field, in ``list_archs`` order."""
    got, want = registry.all_configs(), jregistry.all_configs()
    assert list(got) == list(want) == registry.list_archs()
    for arch in got:
        assert dataclasses.asdict(got[arch]) == dataclasses.asdict(want[arch])
