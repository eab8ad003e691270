"""The port's tensor- and expert-parallel split over ``"model"`` (the
sharded train step of ``distributed/sharding.py``) against the JAX
package's GSPMD step and against the port's plain single-rank functions,
on the CPU.

One module fixture spawns 4 ``gloo`` ranks on a ("data", "model")
(2, 2) mesh; every join is bounded by 240 s.  There:

* one TP/EP step of qwen3-8b (GQA, KV heads split), gemma-2b (MQA: its
  one KV head gathered along "model"; tied vocab-parallel embedding and
  loss), minicpm3-4b (MLA: ``wq_down`` gathered), deepseek-moe-16b (EP
  over 4 experts, shared experts split) and mixtral-8x22b with 3 experts
  (3 does not divide 2: each expert's hidden units split), all reduced
  and fp32, from the weights of JAX's ``PRNGKey(0)`` init, against JAX's
  step jitted under ``mesh_context`` of the same (2, 2) mesh on the 8
  host devices of ``tests/conftest.py``, at this suite's bounds (loss
  1e-4, ``final_norm.scale`` 2e-5, every gradient, read back from
  AdamW's first ``m`` and ``v``, atol 1e-5 / rtol 1e-4, every weight 2 x
  LR);
* the same deepseek-moe-16b step on 2 rows of 3 tokens
  ("deepseek-moe-16b/one-group"): 6 tokens over the reference's 2
  dispatch groups would give each fewer than E / capacity_factor, so it
  falls back to one global group, and the port gathers each MoE layer's
  rows over "data" to dispatch them as one (``models/moe.py``), at the
  same bounds; its bytes by collective and axis against the dry-run's
  count of that fallback;
* which weights each rank gathered along "model" (only the exceptions:
  an off-boundary KV projection, MLA's ``wq_down``, a split Mamba's
  ``w_in``, here hymba-1.5b's beside its split attention) and how many
  bytes, against the count of those weights (hymba's step against JAX's
  is in ``tests/test_torch_recurrent_parallel.py``);
* the bytes a rank of the qwen3-8b and deepseek-moe-16b steps moved, by
  collective and axis, against the dry-run's count of the plan, with
  remat "none" and "layer";
* per module, over the 2 ranks of "model", against the plain function
  on full weights: column/row attention (GQA with local KV heads, and
  MQA with the KV gathered), the MLP of each kind, the MoE split by
  expert and by hidden unit, and the vocab-parallel embedding, logits
  and cross entropy; outputs and every gradient (input and weights),
  the regions the plan splits, and the local products' widths (1/2 of
  the heads, hidden units, experts or vocab).
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
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch.models import registry
from repro_torch.models.convert import named_from_reference
from repro_torch.roofline import analysis

LR = 1e-3
#: arch -> config overrides of the JAX-held steps
ARCHS = {"qwen3-8b": {}, "gemma-2b": {}, "minicpm3-4b": {},
         "deepseek-moe-16b": {}, "mixtral-8x22b": {"n_experts": 3}}
#: the weights sharded over "model" that each arch gathers along it
#: (names within a block)
EXCEPTIONS = {"qwen3-8b": [], "gemma-2b": ["attn.wk", "attn.wv"],
              "minicpm3-4b": ["attn.wq_down"], "deepseek-moe-16b": [],
              "mixtral-8x22b": [],
              "hymba-1.5b": ["cell.w_in"]}
#: the steps held against JAX: each arch of ``ARCHS`` on 8 rows of 16
#: tokens, and deepseek-moe-16b where the reference's MoE falls back to
#: one dispatch group -> (arch, rows, seq)
STEPS = {**{a: (a, 8, 16) for a in ARCHS},
         "deepseek-moe-16b/one-group": ("deepseek-moe-16b", 2, 3)}
#: the archs whose wire bytes are also taken from a step under remat "layer"
REMAT_WIRE = ["qwen3-8b", "deepseek-moe-16b"]
MODULES = ["attention-gqa", "attention-mqa", "mlp-swiglu", "mlp-geglu",
           "mlp-gelu", "moe-experts", "moe-hidden", "vocab"]


def _reduced(reg, arch, **kw):
    return dataclasses.replace(reg.get_config(arch).reduced(),
                               **{"dtype": "float32", "remat": "none", **kw})


def _tokens(cfg, rows=8, seq=16, seed=1):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab, (rows, seq)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's step of each arch of ``ARCHS`` jitted under ``mesh_context``
    of a ("data", "model") (2, 2) mesh: params and opt state placed by
    JAX's ``param_specs``, the batch's rows over "data"."""
    mesh = jmake_mesh((2, 2), ("data", "model"))
    out = {}
    for case, (arch, rows, seq) in STEPS.items():
        cfg = _reduced(jregistry, arch, **ARCHS[arch])
        params = JT.init_params(jax.random.PRNGKey(0), cfg)
        toks = _tokens(cfg, rows, seq)
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
        out[case] = dict(
            params=jax.tree.map(np.asarray, params), toks=toks,
            p=named_from_reference(jax.tree.map(np.asarray, p), cfg),
            m=named_from_reference(jax.tree.map(np.asarray, o["m"]), cfg),
            v=named_from_reference(jax.tree.map(np.asarray, o["v"]), cfg),
            loss=float(m["loss"]), aux=float(m["aux_loss"]))
    return out


# ------------------------------------------------------------ spawned ranks
def _init(rank, world, store_path):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))


def _expected_model_bytes(model, names, m) -> int:
    """Bytes a rank receives gathering ``names`` (block-relative) of every
    layer along "model" once: (m - 1) / m of each full weight."""
    total = 0
    for n, p in model.named_parameters():
        if n.startswith("layers.") and n.split(".", 2)[2] in names:
            total += p.numel() * p.element_size() * (m - 1) // m
    return total


def _step(out, arch, cfg, model, toks, mesh):
    """One sharded step of ``model`` (``arch``: a key of ``STEPS`` or an
    arch): its full params, m, v, loss, aux, the names gathered along
    "model" and the bytes received there, into ``out``."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as tts

    opt = adamw.init(dict(model.named_parameters()))
    step = tts.make_train_step(cfg, adamw.AdamWConfig(lr=LR), mesh=mesh)
    sharding.reset_wire_counts()
    m = step(model, opt, {"tokens": torch.from_numpy(toks)})
    wire = sharding.wire_counts()
    out[f"{arch}.loss"] = m["loss"].numpy()
    out[f"{arch}.aux"] = m["aux_loss"].numpy()
    out[f"{arch}.gathered"] = np.asarray(wire["model_gathered"], dtype=str)
    out[f"{arch}.model_bytes"] = np.asarray(wire.get("all-gather/model", 0))
    out[f"{arch}.wire"] = np.asarray(json.dumps(
        {k: v for k, v in wire.items() if k != "model_gathered"}))
    out[f"{arch}.want_bytes"] = np.asarray(_expected_model_bytes(
        model, EXCEPTIONS[arch.split("/")[0]], mesh.size(1)))
    host = sharding.full_state({"p": dict(model.named_parameters()),
                                "m": opt["m"], "v": opt["v"]})
    for part, tree in host.items():
        out.update({f"{arch}.{part}.{n}": t.numpy() for n, t in tree.items()})


def _step_wire(cfg, params_np, toks, mesh) -> str:
    """``sharding.wire_counts`` (as JSON, but the gathered names) of one
    sharded step of ``cfg`` from the reference's weights."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.models.convert import params_from_reference
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as tts

    model = sharding.shard_model(params_from_reference(params_np, cfg), mesh)
    opt = adamw.init(dict(model.named_parameters()))
    step = tts.make_train_step(cfg, adamw.AdamWConfig(lr=LR), mesh=mesh)
    sharding.reset_wire_counts()
    step(model, opt, {"tokens": torch.from_numpy(toks)})
    return json.dumps({k: v for k, v in sharding.wire_counts().items()
                       if k != "model_gathered"})


def _close(got, want, atol, rtol=1e-4) -> float:
    """Max of |got - want| - (atol + rtol |want|), <= 0 when within."""
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().sub(atol + rtol * want.abs()).max())


def _weights_ns(weights: dict):
    """``{"attn.wq": t, ...}`` as nested namespaces (``ns.attn.wq``), as
    the layer functions read a block's weights."""
    import types

    tree = {}
    for n, t in weights.items():
        node = tree
        *path, leaf = n.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t

    def ns(d):
        return types.SimpleNamespace(**{k: ns(v) if isinstance(v, dict)
                                        else v for k, v in d.items()})
    return ns(tree)


def _value_and_grads(fn, x, weights: dict):
    """``fn(x, weights)`` and the gradients, with respect to x and each
    weight (None where unused), of its mean against fixed random weights
    (a loss's scale, where the suite's gradient bounds apply)."""
    import torch

    x = x.clone().requires_grad_(True)
    for w in weights.values():
        w.requires_grad_(True)
    y = fn(x, weights)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(7))
    gs = torch.autograd.grad(y, [x, *weights.values()], dy / y.numel(),
                             allow_unused=True)
    return y, dict(zip(["x", *weights], gs))


def _module_checks(mesh) -> dict:
    """Per module (``MODULES``), the worst excess over the bounds (<= 0
    passes) of the split function's output and gradients against the
    plain function's, and whether its local products are 1/m wide."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import layers, moe
    from repro_torch.models.transformer import (cross_entropy, init_params,
                                                model_plan,
                                                vocab_parallel_cross_entropy)

    m = mesh.size(1)
    res = {}

    def compare(name, cfg, kind, call, widths, regions):
        """``call(weights, x, split)`` over a one-layer model of ``kind``:
        plain on its full weights (``split`` empty), split on its
        DTensors fetched in the modes of ``model_plan`` with its
        ``split``, which must be ``regions``; ``widths`` are the full
        widths of the weights' "model" cuts, each fetched 1/m wide."""
        one = dataclasses.replace(cfg, n_layers=1, segments=((kind, 1),))
        blk = init_params(one, seed=2, device="cpu").layers[0]
        x = torch.randn((2, 8, cfg.d_model),
                        generator=torch.Generator().manual_seed(3))
        y0, g0 = _value_and_grads(
            lambda x, w: call(_weights_ns(w), x, frozenset()), x,
            {n: p.detach().clone() for n, p in blk.named_parameters()})
        sblk = sharding.shard_model(init_params(one, seed=2, device="cpu"),
                                    mesh).layers[0]
        named = dict(sblk.named_parameters())
        plan = model_plan(kind, one, {n: sharding.model_cut(p)
                                      for n, p in named.items()})
        assert plan.split == regions, (name, plan.split)

        def split(x, w):
            fetched = sharding.gather_named(w, plan.modes)
            for n, width in widths.items():
                cut = fetched[n].shape[sharding.model_cut(w[n])[0]]
                assert cut * m == width, (name, n, cut, width)
            return call(_weights_ns(fetched), x, plan.split)

        with mesh_context(mesh):
            y1, g1 = _value_and_grads(split, x, named)
        worst = max(_close(y1, y0, 1e-5), _close(g1["x"], g0["x"], 1e-5))
        for n in named:
            assert (g1[n] is None) == (g0[n] is None), n
            if g0[n] is not None:
                worst = max(worst, _close(g1[n].full_tensor(), g0[n], 1e-5))
        res[name] = worst

    base = _reduced(registry, "qwen3-8b")
    hd = base.resolved_head_dim
    pos = torch.arange(8).expand(2, 8)
    mqa = dataclasses.replace(base, n_kv_heads=1)
    for name, c, kv in (("attention-gqa", base, True),
                        ("attention-mqa", mqa, False)):
        width = {"attn.wq": c.n_heads * hd, "attn.wo": c.n_heads * hd}
        if kv:
            width["attn.wk"] = width["attn.wv"] = c.n_kv_heads * hd
        compare(name, c, "dense", lambda w, x, s, c=c: layers.attention(
            x, w.attn, c, positions=pos, split=s)[0], width,
            {"attn", "mlp", *(("kv",) if kv else ())})
    for kind in ("swiglu", "geglu", "gelu"):
        c = dataclasses.replace(base, mlp_kind=kind)
        compare(f"mlp-{kind}", c, "dense",
                lambda w, x, s, c=c: layers.mlp(x, w.mlp, c.mlp_kind,
                                                "mlp" in s),
                {"mlp.wi": c.d_ff, "mlp.wo": c.d_ff}, {"attn", "kv", "mlp"})
    for name, arch, kw in (("moe-experts", "deepseek-moe-16b", {}),
                           ("moe-hidden", "mixtral-8x22b",
                            {"n_experts": 3})):
        c = _reduced(registry, arch, **kw)
        dff = c.d_expert or c.d_ff
        width = ({"moe.wi": c.n_experts, "moe.wo": c.n_experts}
                 if c.n_experts % m == 0 else {"moe.wi": dff, "moe.wo": dff})
        regions = {"attn", "kv", "experts" if c.n_experts % m == 0
                   else "expert_hidden"}
        if c.n_shared_experts:
            width["moe.shared.wi"] = dff * c.n_shared_experts
            regions.add("shared")
        compare(name, c, c.segments[-1][0],
                lambda w, x, s, c=c: moe.moe_mlp(x, w.moe, c, s), width,
                regions)

    # the vocab: the embedding, the tied logits and the loss against the
    # plain model's on the same weights
    c = _reduced(registry, "gemma-2b")
    toks = torch.from_numpy(_tokens(c, rows=2, seq=8, seed=9)).long()
    plain = init_params(c, seed=4, device="cpu").requires_grad_(True)
    logits0, _ = plain(tokens=toks)
    loss0 = cross_entropy(logits0[:, :-1], toks[:, 1:])
    g0 = torch.autograd.grad(loss0, [plain.embed])[0]
    sh = sharding.shard_model(init_params(c, seed=4, device="cpu"), mesh)
    sh.requires_grad_(True)
    with mesh_context(mesh):
        logits1, _ = sh(tokens=toks)
        loss1 = vocab_parallel_cross_entropy(logits1[:, :-1], toks[:, 1:])
        g1 = torch.autograd.grad(loss1, [sh.embed])[0].full_tensor()
        V = logits1.shape[-1]
        lo = sharding.model_rank() * V
    assert V * m == c.vocab
    res["vocab"] = max(_close(loss1, loss0, 1e-5),
                       _close(logits1, logits0[..., lo:lo + V], 1e-5),
                       _close(g1, g0, 1e-6))
    return res


def _rank4(rank, store_path, out_dir):
    """One of 4 ranks (module docstring) on the inputs the fixture wrote;
    rank 0 writes the steps' results, every rank its module checks."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.transformer import init_params

    _init(rank, 4, store_path)
    try:
        with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)      # written by this test's fixture
        out = {}
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        for case, (arch, _, _) in STEPS.items():
            cfg = _reduced(registry, arch, **ARCHS[arch])
            params_np, toks = inputs[case]
            model = sharding.shard_model(
                params_from_reference(params_np, cfg), mesh)
            _step(out, case, cfg, model, toks, mesh)
            if case in REMAT_WIRE:
                out[f"{arch}.wire.layer"] = np.asarray(_step_wire(
                    dataclasses.replace(cfg, remat="layer"), params_np,
                    toks, mesh))
        # a recurrent half: hymba's Mamba cell split by channels
        cfg = _reduced(registry, "hymba-1.5b")
        model = sharding.shard_model(init_params(cfg, seed=0, device="cpu"),
                                     mesh)
        _step(out, "hymba-1.5b", cfg, model, _tokens(cfg), mesh)
        mine = _module_checks(mesh)
        np.savez(os.path.join(out_dir, f"modules{rank}.npz"),
                 **{k: np.asarray(v) for k, v in mine.items()})
        if rank == 0:
            np.savez(os.path.join(out_dir, "ranks4.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(target, world, *args):
    """Run ``target(rank, *args)`` on ``world`` spawned ranks; every wait
    is bounded, so a hung rank fails the tests instead of the suite."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 240
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(timeout=10)
    assert not hung, f"a gloo rank of {world} did not finish within 240 s"
    assert [p.exitcode for p in procs] == [0] * world


@pytest.fixture(scope="module")
def four_ranks(jax_steps, tmp_path_factory):
    """The 4 ranks' results; their inputs reach them in a file (a large
    argument would hold each rank's start until the one before had
    imported this module)."""
    tmp = tmp_path_factory.mktemp("tp4")
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({a: (r["params"], r["toks"])
                     for a, r in jax_steps.items()}, f)
    _spawn(_rank4, 4, str(tmp / "store"), str(tmp))
    return dict(dict(np.load(tmp / "ranks4.npz")),
                modules=[dict(np.load(tmp / f"modules{r}.npz"))
                         for r in range(4)])


@pytest.mark.parametrize("arch", list(STEPS))
def test_tp_step_matches_jax_gspmd(four_ranks, jax_steps, arch):
    """One TP/EP step on (2, 2) against JAX's on the same mesh (module
    docstring's bounds); the one-group case's bytes against the dry-run's
    count (gathers and reduce-scatters exactly, all-reduces but the
    scalars)."""
    want, got = jax_steps[arch], four_ranks
    assert abs(float(got[f"{arch}.loss"]) - want["loss"]) < 1e-4
    name, rows, seq = STEPS[arch]
    if arch.endswith("/one-group"):
        cfg = _reduced(registry, name)
        plan = analysis.plan_collective_bytes(
            cfg, {"data": 2, "model": 2}, "train",
            tokens=rows // 2 * seq)["by_axis"]
        wire = json.loads(str(got[f"{arch}.wire"]))
        assert set(wire) == set(plan) and "reduce-scatter/data" in plan
        for key, n in plan.items():
            tol = 256 if key.startswith("all-reduce") else 0
            assert abs(wire[key] - n) <= tol, (key, wire[key], n)
    if ARCHS[name] or name == "deepseek-moe-16b":
        assert want["aux"] > 0
        assert abs(float(got[f"{arch}.aux"]) - want["aux"]) < 1e-5
    np.testing.assert_allclose(got[f"{arch}.p.final_norm.scale"],
                               want["p"]["final_norm.scale"],
                               atol=2e-5, rtol=2e-5)
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


@pytest.mark.parametrize("arch", [*ARCHS, "hymba-1.5b"])
def test_model_gathers_only_the_exceptions(four_ranks, arch):
    """Along "model" a rank gathers only the exception weights of its
    arch, each once (remat "none"), and receives exactly their bytes
    (hymba: the Mamba's ``w_in`` alone, its cell split by channels)."""
    got = four_ranks
    assert sorted(got[f"{arch}.gathered"].tolist()) == EXCEPTIONS[arch]
    assert int(got[f"{arch}.model_bytes"]) == int(got[f"{arch}.want_bytes"])


@pytest.mark.parametrize("module", MODULES)
def test_split_module_matches_plain(four_ranks, module):
    """The split function's output, input gradient and weight gradients
    against the plain function's on full weights, atol 1e-5 / rtol 1e-4
    (the embedding's gradient 1e-6), on every rank; the local products
    are 1/2 as wide (asserted in the ranks)."""
    for r, mods in enumerate(four_ranks["modules"]):
        assert float(mods[module]) <= 0, (r, module, float(mods[module]))


@pytest.mark.parametrize("remat", ["none", "layer"])
@pytest.mark.parametrize("arch", REMAT_WIRE)
def test_plan_collective_bytes_matches_the_step(four_ranks, arch, remat):
    """The dry-run's count of the train plan (``analysis.
    plan_collective_bytes``) on this (2, 2) mesh and 4 rows x 16 tokens a
    rank, by collective and axis, equals what a rank of the step moved
    (``sharding.wire_counts``), without a recompute and with one per
    layer (remat "layer": the weights gathered again, the forward
    all-reduces repeated up to each block's last saved tensor): the
    gathers and reduce-scatters exactly, the all-reduces up to the
    scalars the plan does not count (the loss and aux means, the norm,
    the MoE fractions) and the loss's last position of each row, under
    256 bytes."""
    cfg = _reduced(registry, arch, **ARCHS[arch], remat=remat)
    plan = analysis.plan_collective_bytes(cfg, {"data": 2, "model": 2},
                                          "train", tokens=4 * 16)["by_axis"]
    got = json.loads(str(four_ranks[f"{arch}.wire"
                                    + (".layer" if remat == "layer" else "")]))
    assert set(got) == set(plan)
    for key, want in plan.items():
        if key.startswith("all-reduce"):
            assert abs(got[key] - want) < 256, (key, got[key], want)
        else:
            assert got[key] == want, (key, got[key], want)
    assert plan["all-reduce/model"] > 0 and plan["all-gather/data"] > 0
    assert "all-gather/model" not in plan       # no exception weight here
