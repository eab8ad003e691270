"""The recurrent cells split over ``"model"`` (``models/ssm.py``'s
``split``, chosen by ``models/transformer.py::model_plan``) against the
JAX package and against the port's one-rank cells, on the CPU.

One module fixture spawns 4 ``gloo`` ranks on a ("data", "model") (2, 2)
mesh (every join bounded by 240 s) and, while they run, computes the
JAX side: its cells and its train steps jitted under ``mesh_context`` of
the same (2, 2) mesh on the 8 host devices of ``tests/conftest.py``.
fp32, reduced configs, the same weights on both sides (drawn with numpy
in the shapes of JAX's init, ``_draw``):

* each cell split over the 2 ranks of "model" (``CELLS``): an mLSTM by
  heads (4 heads, 2 a rank), an mLSTM by value columns (1 head, half
  its value columns a rank), an sLSTM and a Mamba by channels; 5 tokens
  from a zero state, then 7 from the split state they left: both
  chunks' outputs and the final state (gathered back by
  ``sharding.gather_cache``) against JAX's cell within
  ``tests/test_torch_recurrent.py``'s 1e-4, and against the port's
  one-rank cell on the whole weights, outputs, states and every
  gradient (both chunks' inputs and each weight), within 1e-5; the
  empty cache a sharded model lays out (``init_cache``) holds pieces of
  the split state's shapes;
* one train step of xlstm-1.3b (mLSTM by heads, sLSTM by channels) and
  hymba-1.5b (Mamba by channels beside split attention and MLP), each
  cut to its first 3 layers (``SEGMENTS``), on 8 rows of 16 tokens
  against JAX's GSPMD step at
  ``tests/test_torch_tensor_parallel.py``'s bounds, the weights each
  rank gathered along "model" (none for xlstm, hymba's ``cell.w_in``),
  and the bytes a rank moved by collective and axis against
  ``analysis.plan_collective_bytes``, under remat "none" and "layer".
"""
import dataclasses
import datetime
import json
import multiprocessing
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.distributed.sharding import param_specs as jparam_specs
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.launch.mesh import mesh_context as jmesh_context
from repro.models import registry as jregistry
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch.models import registry
from repro_torch.models.convert import named_from_reference
from repro_torch.roofline import analysis

LR = 1e-3
MESH = {"data": 2, "model": 2}
ROWS, SEQ = 8, 16
#: case -> (arch, block kind, config overrides, the region it splits)
CELLS = {"mlstm-heads": ("xlstm-1.3b", "mlstm", {}, "cell"),
         "mlstm-values": ("xlstm-1.3b", "mlstm", {"n_heads": 1},
                          "cell_values"),
         "slstm": ("xlstm-1.3b", "slstm", {}, "cell"),
         "mamba": ("hymba-1.5b", "hybrid", {}, "cell")}
JAX_CELLS = {"mlstm": (jssm.mlstm_params, jssm.mlstm_block),
             "slstm": (jssm.slstm_params, jssm.slstm_block),
             "hybrid": (jssm.mamba_params, jssm.mamba_block)}
#: the tokens of the two chunks a cell runs
CHUNKS = (5, 7)
#: arch -> the weights (within a block) it gathers along "model"
EXCEPTIONS = {"xlstm-1.3b": [], "hymba-1.5b": ["cell.w_in"]}
#: the steps' archs, reduced and cut to their first 3 layers (each of
#: their block kinds, the JAX side's compile within this file's time)
SEGMENTS = {"xlstm-1.3b": (("mlstm", 2), ("slstm", 1)),
            "hymba-1.5b": (("hybrid_global", 1), ("hybrid", 2))}


def _reduced(reg, arch, **kw):
    return dataclasses.replace(reg.get_config(arch).reduced(),
                               **{"dtype": "float32", "remat": "none", **kw})


def _step_cfg(reg, arch, **kw):
    return _reduced(reg, arch, n_layers=3, segments=SEGMENTS[arch], **kw)


def _one_layer(reg, case):
    arch, kind, kw, _ = CELLS[case]
    cfg = _reduced(reg, arch, **kw)
    return dataclasses.replace(cfg, n_layers=1, segments=((kind, 1),))


def _draw(init, *args, seed: int):
    """Weights shaped as ``init(key, *args)`` returns them (``jax.
    eval_shape``: nothing drawn by JAX), drawn with numpy from ``seed``:
    a matrix's normal / sqrt(its fan-in), a vector's 1 + normal / 10."""
    g = np.random.default_rng(seed)

    def leaf(s):
        w = g.normal(size=s.shape)
        w = w / np.sqrt(s.shape[-2]) if len(s.shape) >= 2 else 1 + w / 10
        return w.astype(s.dtype)
    return jax.tree.map(leaf, jax.eval_shape(lambda k: init(k, *args),
                                             jax.random.PRNGKey(0)))


def _cell_inputs(case):
    """(weights, the two chunks' inputs, the output's cotangent) of a
    cell case, as numpy."""
    cfg = _one_layer(jregistry, case)
    params = _draw(JAX_CELLS[CELLS[case][1]][0], cfg, jnp.float32, seed=3)
    g = np.random.default_rng(4)
    xs = [g.normal(size=(2, n, cfg.d_model)).astype(np.float32)
          for n in CHUNKS]
    dy = g.normal(size=(2, sum(CHUNKS), cfg.d_model)).astype(np.float32)
    return params, xs, dy


def _jax_cell(case, params, xs):
    """JAX's cell over the two chunks, jitted: both outputs and the final
    state."""
    cfg = _one_layer(jregistry, case)
    block = JAX_CELLS[CELLS[case][1]][1]

    def chunks(p, x0, x1):
        y0, st = block(x0, p, cfg)
        y1, st = block(x1, p, cfg, state=st)
        return jnp.concatenate([y0, y1], 1), st

    y, st = jax.jit(chunks)(params, *xs)
    return np.asarray(y), [np.asarray(t) for t in st]


def _jax_step(arch, params, toks, mesh):
    """JAX's train step of ``arch`` from ``params`` on ``toks``, jitted
    under ``mesh_context`` of the (2, 2) mesh: params and opt state
    placed by JAX's ``param_specs``, the batch's rows over "data"."""
    cfg = _step_cfg(jregistry, arch)
    step = jts.make_train_step(cfg, jadamw.AdamWConfig(lr=LR))
    psh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                       jparam_specs(params, mesh))
    params_s = jax.device_put(params, psh)
    opt_s = jax.device_put(jadamw.init(params),
                           {"m": psh, "v": psh,
                            "count": NamedSharding(mesh, P())})
    with jmesh_context(mesh):
        batch = jax.device_put({"tokens": jnp.asarray(toks)},
                               NamedSharding(mesh, P("data")))
        p, o, m = jax.jit(step)(params_s, opt_s, batch)
    return dict(p=named_from_reference(jax.tree.map(np.asarray, p), cfg),
                m=named_from_reference(jax.tree.map(np.asarray, o["m"]), cfg),
                v=named_from_reference(jax.tree.map(np.asarray, o["v"]), cfg),
                loss=float(m["loss"]))


# ------------------------------------------------------------ spawned ranks
def _close(got, want, atol, rtol=1e-4) -> float:
    """Max of |got - want| - (atol + rtol |want|), <= 0 when within."""
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().sub(atol + rtol * want.abs()).max())


def _cell_checks(mesh, case, params, xs, dy) -> dict:
    """One cell case on this rank: the split cell's outputs and whole
    final state, its region and the worst excess over 1e-5 of its
    outputs, state and gradients against the one-rank cell's."""
    import types

    import torch

    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import ssm
    from repro_torch.models.transformer import Transformer, model_plan

    cfg = _one_layer(registry, case)
    kind = CELLS[case][1]
    fn = ssm.mamba_block if kind == "hybrid" else getattr(
        ssm, f"{kind}_block")
    model = Transformer(cfg, device="cpu")
    with torch.no_grad():
        for n, t in model.layers[0].cell.named_parameters():
            t.copy_(torch.from_numpy(params[n]))
    whole = {n: t.detach().clone()
             for n, t in model.layers[0].cell.named_parameters()}
    sharding.shard_model(model, mesh)
    blk = model.layers[0]
    plan = model_plan(kind, cfg, {n: sharding.model_cut(p)
                                  for n, p in blk.named_parameters()})
    x = [torch.from_numpy(a) for a in xs]
    cot = torch.from_numpy(dy) / dy.size

    def run(weights, split, xs_in):
        w = types.SimpleNamespace(**weights)
        y0, st = fn(xs_in[0], w, cfg, split=split)
        y1, st = fn(xs_in[1], w, cfg, state=st, split=split)
        return torch.cat([y0, y1], 1), st

    def grads(weights, split, fetch=None):
        xs_in = [t.clone().requires_grad_(True) for t in x]
        for t in weights.values():
            t.requires_grad_(True)
        used = fetch(weights) if fetch else weights
        y, st = run(used, split, xs_in)
        gs = torch.autograd.grad(y, [*xs_in, *weights.values()], cot,
                                 allow_unused=True)
        return y.detach(), st, dict(zip(["x0", "x1", *weights], gs))

    y0, st0, g0 = grads(whole, frozenset())
    named = {n[len("cell."):]: p for n, p in blk.named_parameters()
             if n.startswith("cell.")}
    modes = {n[len("cell."):]: m for n, m in plan.modes.items()
             if n.startswith("cell.")}
    with mesh_context(mesh):
        y1, st1, g1 = grads(named, plan.split,
                            lambda w: sharding.gather_named(w, modes))
        region = next(iter(plan.split & ssm.CELL_REGIONS))
        # the empty cache a sharded model lays out holds the same pieces
        empty = model.init_cache(2 * mesh.size(0), CHUNKS[0])
        state = empty[0]["ssm"] if kind == "hybrid" else empty[0]
        assert empty.cells == {0: region}
        assert [t.shape for t in state] == [t.shape for t in st1], case
        st1 = sharding.gather_cache(sharding.RankCache(
            [tuple(t.detach() for t in st1)], cells={0: region}))[0]
    worst = max(_close(y1, y0, 1e-5),
                *(_close(a, b, 1e-5) for a, b in zip(st1, st0)))
    for n, g in g1.items():
        assert (g is None) == (g0[n] is None), n
        if g is not None:
            full = g.full_tensor() if hasattr(g, "full_tensor") else g
            worst = max(worst, _close(full, g0[n], 1e-5))
    return {f"{case}.y": y1.numpy(), f"{case}.region": np.asarray(region),
            f"{case}.excess": np.asarray(worst),
            **{f"{case}.state.{i}": t.numpy() for i, t in enumerate(st1)}}


def _step(arch, params_np, toks, mesh, remat="none") -> dict:
    """One sharded train step of ``arch``: loss, the names gathered along
    "model", the bytes moved (JSON) and, under remat "none", the full
    params, m and v."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.models.convert import params_from_reference
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as tts

    cfg = _step_cfg(registry, arch, remat=remat)
    model = sharding.shard_model(params_from_reference(params_np, cfg), mesh)
    opt = adamw.init(dict(model.named_parameters()))
    step = tts.make_train_step(cfg, adamw.AdamWConfig(lr=LR), mesh=mesh)
    sharding.reset_wire_counts()
    m = step(model, opt, {"tokens": torch.from_numpy(toks)})
    wire = sharding.wire_counts()
    key = f"{arch}.{remat}"
    out = {f"{key}.gathered": np.asarray(wire.pop("model_gathered"),
                                         dtype=str),
           f"{key}.wire": np.asarray(json.dumps(wire)),
           f"{key}.loss": m["loss"].numpy()}
    if remat == "none":
        host = sharding.full_state({"p": dict(model.named_parameters()),
                                    "m": opt["m"], "v": opt["v"]})
        for part, tree in host.items():
            out.update({f"{arch}.{part}.{n}": t.numpy()
                        for n, t in tree.items()})
    return out


def _rank(rank, store_path, out_dir):
    """One of 4 ranks (module docstring); each writes its results."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 4),
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=120))
    try:
        with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)      # written by this test's fixture
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        out = {}
        for case in CELLS:
            out.update(_cell_checks(mesh, case, *inputs["cells"][case]))
        for arch in EXCEPTIONS:
            params_np, toks = inputs[arch]
            for remat in ("none", "layer"):
                out.update(_step(arch, params_np, toks, mesh, remat))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def split_runs(tmp_path_factory):
    """{"jax": JAX's cells and steps, "ranks": each rank's results}: the
    ranks run while JAX computes.  The inputs reach the ranks in a file:
    a large argument would hold each rank's start until the one before
    had imported this module."""
    tmp = tmp_path_factory.mktemp("cells4")
    cells = {case: _cell_inputs(case) for case in CELLS}
    inputs = {"cells": cells}
    for arch in EXCEPTIONS:
        cfg = _step_cfg(jregistry, arch)
        inputs[arch] = (_draw(JT.init_params, cfg, seed=0),
                        np.random.default_rng(1).integers(
                            1, cfg.vocab, (ROWS, SEQ)).astype(np.int32))
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, str(tmp / "store"), str(tmp)))
             for r in range(4)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 240
    try:
        want = {case: _jax_cell(case, params, xs)
                for case, (params, xs, _) in cells.items()}
        mesh = jmake_mesh((2, 2), ("data", "model"))
        for arch in EXCEPTIONS:
            want[arch] = _jax_step(arch, *inputs[arch], mesh)
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(timeout=10)
    assert not hung, "a gloo rank of 4 did not finish within 240 s"
    assert [p.exitcode for p in procs] == [0] * 4
    return {"jax": want, "ranks": [dict(np.load(tmp / f"rank{r}.npz"))
                                   for r in range(4)]}


@pytest.mark.parametrize("case", list(CELLS))
def test_split_cell_matches_jax_and_one_rank(split_runs, case):
    """A cell split over "model" (its region as ``CELLS`` names it): both
    chunks' outputs and the final state, gathered back, against JAX's
    cell within 1e-4 on every rank; against the port's one-rank cell,
    outputs, state and every gradient, within 1e-5 (asserted in the
    ranks' excess, <= 0)."""
    y, state = split_runs["jax"][case]
    for got in split_runs["ranks"]:
        assert str(got[f"{case}.region"]) == CELLS[case][3]
        assert float(got[f"{case}.excess"]) <= 0, float(got[f"{case}.excess"])
        np.testing.assert_allclose(got[f"{case}.y"], y, atol=1e-4, rtol=1e-4)
        assert len(state) == sum(k.startswith(f"{case}.state.") for k in got)
        for i, w in enumerate(state):
            assert got[f"{case}.state.{i}"].shape == w.shape
            np.testing.assert_allclose(got[f"{case}.state.{i}"], w,
                                       atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", list(EXCEPTIONS))
def test_split_step_matches_jax_gspmd(split_runs, arch):
    """One train step with the cells split over "model" against JAX's
    GSPMD step on the same (2, 2) mesh (``tests/
    test_torch_tensor_parallel.py``'s bounds: loss 1e-4, every gradient
    from AdamW's first m and v atol 1e-5 / rtol 1e-4, every weight 2 x
    LR), and the weights it gathered along "model"."""
    want, got = split_runs["jax"][arch], split_runs["ranks"][0]
    assert abs(float(got[f"{arch}.none.loss"]) - want["loss"]) < 1e-4
    for r in split_runs["ranks"]:
        for remat in ("none", "layer"):
            assert sorted(r[f"{arch}.{remat}.gathered"].tolist()) == \
                EXCEPTIONS[arch]
    b1, b2 = jadamw.AdamWConfig().b1, jadamw.AdamWConfig().b2
    assert set(want["p"]) == {k[len(f"{arch}.p."):] for k in got
                              if k.startswith(f"{arch}.p.")}
    for n in want["p"]:
        np.testing.assert_allclose(got[f"{arch}.m.{n}"] / (1 - b1),
                                   want["m"][n] / (1 - b1), atol=1e-5,
                                   rtol=1e-4, err_msg=f"m {n}")
        np.testing.assert_allclose(np.sqrt(got[f"{arch}.v.{n}"] / (1 - b2)),
                                   np.sqrt(want["v"][n] / (1 - b2)),
                                   atol=1e-5, rtol=1e-4, err_msg=f"v {n}")
        np.testing.assert_allclose(got[f"{arch}.p.{n}"], want["p"][n],
                                   atol=2 * LR, rtol=0, err_msg=f"p {n}")


@pytest.mark.parametrize("remat", ["none", "layer"])
@pytest.mark.parametrize("arch", list(EXCEPTIONS))
def test_plan_collective_bytes_matches_split_cells(split_runs, arch, remat):
    """The dry-run's count of the train plan (``analysis.
    plan_collective_bytes``) on the (2, 2) mesh, 4 rows x 16 tokens a
    rank, by collective and axis, equals what every rank of the step
    moved: the gathers and reduce-scatters (the sLSTM's step gathers and
    their gradients' among them) exactly, the all-reduces (the cells'
    sums of squares, B, C and dt, outputs and input gradients among them)
    up to the scalars the plan does not count, under 256 bytes."""
    cfg = _step_cfg(registry, arch, remat=remat)
    plan = analysis.plan_collective_bytes(cfg, MESH, "train", seq=SEQ,
                                          tokens=ROWS // 2 * SEQ)["by_axis"]
    assert plan["all-reduce/model"] > 0
    if arch == "xlstm-1.3b":
        assert plan["all-gather/model"] > 0          # the sLSTM's h
    for r in split_runs["ranks"]:
        got = json.loads(str(r[f"{arch}.{remat}.wire"]))
        assert set(got) == set(plan)
        for key, want in plan.items():
            if key.startswith("all-reduce"):
                assert abs(got[key] - want) < 256, (key, got[key], want)
            else:
                assert got[key] == want, (key, got[key], want)
