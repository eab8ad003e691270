"""The port's training path vs the JAX package's, on the CPU.

Small shapes, fp32 unless a case says otherwise, the JAX weights (and
AdamW state) carried across by ``models/convert.py``.  Held against JAX:
``cross_entropy`` (with and without a mask) and ``param_count``; the
schedules; ``adamw.update`` on fp32 and bf16 trees with clipping active;
the loss and every gradient of ``make_loss_fn`` for qwen3-8b, the MoE
archs (deepseek-moe-16b; mixtral-8x22b, ``moe_swa``), the mLSTM/sLSTM
arch (xlstm-1.3b, all 18 reduced layers in float64), MLA (minicpm3-4b)
and the hybrid Mamba blocks (hymba-1.5b) reduced (loss within 1e-5,
gradients within rtol 1e-4 and atol 1e-5), and its encoder
branch (hubert-xlarge reduced, ``embeds``/``labels``); two
``make_train_step`` steps and one with ``num_microbatches=4`` (params,
``m`` and ``v`` within atol 2e-5, the reference's own sharded-vs-single
bound, ``tests/test_distributed.py:82-85``); the data pipeline bit for
bit; ``quantized_psum_mean`` for two pods against JAX's under
``jax.vmap(..., axis_name="pod")``, a compressed step over a 2-rank
``gloo`` group against JAX's exact step (the reference test's bounds,
``tests/test_distributed.py:118-122``) and an exact step over a 2-rank
"data" axis against it (replicated parameters; the sharded step is in
``tests/test_torch_distributed.py``).  The port alone: ``remat="layer"``
against ``"none"``, a checkpoint restart against an uninterrupted run
(bit for bit), the CLI (``--mesh`` outside its world exits naming the
ranks it needs), and that serving builds no graph over a model whose
parameters require grad.
"""
import contextlib
import dataclasses
import datetime
import multiprocessing
import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import schedules as jsched
from repro.train import train_step as jts
from repro_torch.data import pipeline as tpipe
from repro_torch.models import registry
from repro_torch.models import transformer as TT
from repro_torch.models.convert import (_tensor, named_from_reference,
                                        opt_state_from_reference,
                                        params_from_reference)
from repro_torch.optim import adamw, compression
from repro_torch.optim import schedules
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer

B, S = 4, 16
LR = 1e-3


def _reduced(reg, arch, **kw):
    return dataclasses.replace(reg.get_config(arch).reduced(),
                               **{"dtype": "float32", "remat": "none", **kw})


def _pair(arch, seed=0, **kw):
    """(JAX cfg, port cfg, JAX params, port model) with the same weights."""
    jcfg, tcfg = _reduced(jregistry, arch, **kw), _reduced(registry, arch, **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    params = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    model = params_from_reference(jax.tree.map(np.asarray, params), tcfg)
    return jcfg, tcfg, params, model


def _tokens(cfg, rows=B, seed=1):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab, (rows, S)).astype(np.int32)


def _named(tree, cfg):
    """A JAX param-shaped tree as {port name: numpy array}."""
    return named_from_reference(jax.tree.map(np.asarray, tree), cfg)


def _check_tree(jax_named, torch_named, atol, rtol=0.0):
    assert set(jax_named) == set(torch_named)
    for name, want in jax_named.items():
        got = torch_named[name].detach().double().numpy()
        np.testing.assert_allclose(got, np.asarray(want, np.float64),
                                   atol=atol, rtol=rtol, err_msg=name)


def _check_state(jcfg, jparams, jopt, model, opt, atol=2e-5):
    _check_tree(_named(jparams, jcfg), dict(model.named_parameters()), atol)
    _check_tree(_named(jopt["m"], jcfg), opt["m"], atol)
    _check_tree(_named(jopt["v"], jcfg), opt["v"], atol)
    assert int(opt["count"]) == int(jopt["count"])


# ------------------------------------------------------- loss and counts
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = JT.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    got = TT.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # bf16 logits are upcast inside, as the reference
    lb = torch.from_numpy(logits).bfloat16()
    wb = JT.cross_entropy(jnp.asarray(lb.float().numpy()).astype(jnp.bfloat16),
                          jnp.asarray(labels))
    np.testing.assert_allclose(TT.cross_entropy(lb, torch.from_numpy(labels))
                               .item(), float(wb), rtol=1e-6)


@pytest.mark.parametrize("arch", registry.list_archs())
def test_param_count_matches_jax(arch):
    jcfg = jregistry.get_config(arch).reduced()
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    model = TT.Transformer(registry.get_config(arch).reduced(), device="cpu")
    assert TT.param_count(model) == JT.param_count(shapes)


def test_schedules_match_jax():
    cos_j = jsched.cosine_with_warmup(3e-3, 10, 100)
    cos_t = schedules.cosine_with_warmup(3e-3, 10, 100)
    for step in (0, 1, 5, 9, 10, 11, 37, 99, 100, 150):
        got = cos_t(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.item(),
                                   float(cos_j(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6, err_msg=str(step))
    got = schedules.constant(3e-4)(torch.tensor(7, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert got.item() == float(jsched.constant(3e-4)(jnp.asarray(7)))


# ------------------------------------------------------------------ AdamW
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    """Three updates of a two-leaf tree with the global norm far above
    ``clip_norm`` (clipping active) and a cosine schedule."""
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 16), "b": (32,)}
    p0 = {k: jnp.asarray(rng.standard_normal(s), jnp.float32).astype(dtype)
          for k, s in shapes.items()}
    cfg_j = jadamw.AdamWConfig(lr=jsched.cosine_with_warmup(1e-2, 2, 10))
    cfg_t = adamw.AdamWConfig(lr=schedules.cosine_with_warmup(1e-2, 2, 10))
    pj, oj = p0, jadamw.init(p0)
    pt = {k: _tensor(np.asarray(v)) for k, v in p0.items()}
    ot = adamw.init(pt)
    for i in range(3):
        g = {k: (rng.standard_normal(s) * 10).astype(np.float32)
             for k, s in shapes.items()}
        gj = {k: jnp.asarray(v).astype(dtype) for k, v in g.items()}
        pj, oj, mj = jadamw.update(gj, oj, pj, cfg_j)
        mt = adamw.update({k: _tensor(np.asarray(v)) for k, v in gj.items()},
                          ot, pt, cfg_t)
        assert float(mj["grad_norm"]) > 10 * cfg_j.clip_norm
        np.testing.assert_allclose(mt["grad_norm"].item(),
                                   float(mj["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(mt["lr"].item(), float(mj["lr"]),
                                   rtol=1e-6)
    assert int(ot["count"]) == int(oj["count"]) == 3
    for k in shapes:
        assert pt[k].dtype == getattr(torch, dtype)
        assert ot["m"][k].dtype == ot["v"][k].dtype == torch.float32
        np.testing.assert_allclose(ot["m"][k].numpy(), np.asarray(oj["m"][k]),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(ot["v"][k].numpy(), np.asarray(oj["v"][k]),
                                   rtol=1e-5, atol=1e-7)
        # one rounding to the parameter's dtype: at most one bf16 ulp apart
        np.testing.assert_allclose(pt[k].float().numpy(),
                                   np.asarray(pj[k], np.float32),
                                   rtol=2.0 ** -8 if dtype == "bfloat16"
                                   else 1e-6, atol=1e-7)


# -------------------------------------------------------- loss and grads
def _jax_grads(jcfg, params, batch):
    fn = jax.jit(jax.value_and_grad(jts.make_loss_fn(jcfg), has_aux=True))
    (_, (loss, aux)), g = fn(params, batch)
    return float(loss), float(aux), g


def _torch_grads(tcfg, model, batch):
    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    tot, (loss, aux) = tts.make_loss_fn(tcfg)(model, batch)
    gs = torch.autograd.grad(tot, params, allow_unused=True)
    return loss.item(), aux.item(), {
        n: torch.zeros_like(p) if g is None else g
        for n, p, g in zip(names, params, gs)}


#: hymba-1.5b is cut to one layer of each hybrid kind for time (its 7
#: reduced layers agree too)
CUTS = {"hymba-1.5b": dict(n_layers=2, segments=(("hybrid_global", 1),
                                                 ("hybrid", 1)))}
#: archs compared in float64.  xlstm-1.3b reduced keeps its 12 segments
#: (18 layers); through that many exponential-gated recurrences each fp32
#: package's embedding gradient (max 2.9) lies ~1.4e-4 from a float64
#: run's, so in fp32 the bounds below would measure rounding, not the
#: port.  Both packages run the whole stack in float64 instead: the port
#: as a float64 model (``models/layers.py::stat`` keeps its statistics and
#: states in float64), JAX under ``jax.enable_x64`` (``_jax_float64``).
FLOAT64 = ("xlstm-1.3b",)


class _Float64Pins:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _jax_float64(monkeypatch):
    """``jax.enable_x64`` for a float64 reference run.  The reference pins
    its gates, states, norm statistics and loss to ``jnp.float32``
    (``models/ssm.py``, ``layers.py``, ``transformer.py``) and cannot trace
    xLSTM under x64 at all: ``np.sqrt(dk)`` is a float64 scalar that
    promotes the mLSTM scan's carry past its float32 initial state.  For
    the test's duration those modules see ``jnp.float32`` as float64 and
    that square root as a Python float; no file of the reference
    changes."""
    for mod in (jssm, jlayers, JT):
        monkeypatch.setattr(mod, "jnp", _Float64Pins())
    monkeypatch.setattr(jssm, "np", types.SimpleNamespace(
        sqrt=lambda x: float(np.sqrt(x))))
    return jax.enable_x64(True)


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-moe-16b",
                                  "xlstm-1.3b", "mixtral-8x22b",
                                  "minicpm3-4b", "hymba-1.5b"])
def test_loss_and_grads_match_jax(arch, monkeypatch):
    kw = dict(CUTS.get(arch, {}))
    ctx = contextlib.nullcontext()
    if arch in FLOAT64:
        kw["dtype"] = "float64"
        ctx = _jax_float64(monkeypatch)
    with ctx:
        jcfg, tcfg, params, model = _pair(arch, **kw)
        toks = _tokens(jcfg)
        lj, aj, gj = _jax_grads(jcfg, params, {"tokens": jnp.asarray(toks)})
        gj = _named(gj, jcfg)
    lt, at, gt = _torch_grads(tcfg, model, {"tokens": torch.from_numpy(toks)})
    if arch in FLOAT64:
        assert all(t.dtype == torch.float64 for t in gt.values())
        assert all(a.dtype == np.float64 for a in gj.values())
    assert abs(lt - lj) < 1e-5
    assert abs(at - aj) < 1e-5
    if jcfg.n_experts:
        assert aj > 0                 # the balance term enters the loss
    _check_tree(gj, gt, atol=1e-5, rtol=1e-4)


def test_encoder_loss_branch_matches_jax():
    """hubert-xlarge reduced: CE of the logits of ``embeds`` against
    ``labels``; its untied ``embed`` gets zero gradient in both."""
    jcfg, tcfg, params, model = _pair("hubert-xlarge")
    rng = np.random.default_rng(2)
    e = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    lj, _, gj = _jax_grads(jcfg, params, {"embeds": jnp.asarray(e),
                                          "labels": jnp.asarray(labels)})
    lt, _, gt = _torch_grads(tcfg, model, {"embeds": torch.from_numpy(e),
                                           "labels": torch.from_numpy(labels)})
    assert abs(lt - lj) < 1e-5
    assert not gt["embed"].any()
    _check_tree(_named(gj, jcfg), gt, atol=1e-5, rtol=1e-4)


def test_remat_layer_matches_none():
    """Checkpointed blocks recompute the same activations: the same loss
    and gradients, bit for bit, on the CPU."""
    _, tcfg, _, model = _pair("deepseek-moe-16b")
    toks = {"tokens": torch.from_numpy(_tokens(tcfg))}
    lo, ao, go = _torch_grads(tcfg, model, toks)
    remat = dataclasses.replace(tcfg, remat="layer")
    model.cfg = remat
    lr_, ar, gr = _torch_grads(remat, model, toks)
    assert (lr_, ar) == (lo, ao)
    for n in go:
        assert torch.equal(gr[n], go[n]), n


# ------------------------------------------------------------ train steps
@pytest.fixture(scope="module")
def qwen():
    """qwen3-8b reduced: the JAX params and two exact JAX steps on an
    8-row batch (params, opt state, metrics after each)."""
    jcfg = _reduced(jregistry, "qwen3-8b")
    params = JT.init_params(jax.random.PRNGKey(0), jcfg)
    toks = _tokens(jcfg, rows=8)
    step = jax.jit(jts.make_train_step(jcfg, jadamw.AdamWConfig(lr=LR)))
    p, o = params, jadamw.init(params)
    after = []
    for _ in range(2):
        p, o, m = step(p, o, {"tokens": jnp.asarray(toks)})
        after.append((p, o, m))
    return jcfg, params, toks, after


def test_two_train_steps_match_jax(qwen):
    jcfg, params, toks, after = qwen
    tcfg = _reduced(registry, "qwen3-8b")
    model = params_from_reference(jax.tree.map(np.asarray, params), tcfg)
    opt = adamw.init(dict(model.named_parameters()))
    step = tts.make_train_step(tcfg, adamw.AdamWConfig(lr=LR))
    for jp, jo, jm in after:
        m = step(model, opt, {"tokens": torch.from_numpy(toks)})
        assert abs(m["loss"].item() - float(jm["loss"])) < 1e-5
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5)
        _check_state(jcfg, jp, jo, model, opt)


def test_microbatched_step_matches_jax():
    """``num_microbatches=4`` against JAX's microbatched step, from a JAX
    state one step in (carried across by ``opt_state_from_reference``)."""
    jcfg, tcfg, params, _ = _pair("qwen3-8b")
    toks = jnp.asarray(_tokens(jcfg, rows=8))
    one = jax.jit(jts.make_train_step(jcfg, jadamw.AdamWConfig(lr=LR)))
    p1, o1, _ = one(params, jadamw.init(params), {"tokens": toks})
    mb = jax.jit(jts.make_train_step(jcfg, jadamw.AdamWConfig(lr=LR),
                                     num_microbatches=4))
    p2, o2, m2 = mb(p1, o1, {"tokens": toks})
    model = params_from_reference(jax.tree.map(np.asarray, p1), tcfg)
    opt = opt_state_from_reference(jax.tree.map(np.asarray, o1), tcfg)
    step = tts.make_train_step(tcfg, adamw.AdamWConfig(lr=LR),
                               num_microbatches=4)
    m = step(model, opt, {"tokens": torch.from_numpy(np.array(toks))})
    assert abs(m["loss"].item() - float(m2["loss"])) < 1e-5
    _check_state(jcfg, p2, o2, model, opt)


def test_named_mapping_and_opt_state_round_trip():
    """A param-shaped JAX tree maps onto exactly the port's parameter
    names and shapes, and restacking the layers gives the tree back; an
    AdamW state two steps in carries across leaf for leaf."""
    jcfg, tcfg, params, model = _pair("deepseek-moe-16b")
    named = _named(params, jcfg)
    ported = dict(model.named_parameters())
    assert set(named) == set(ported)
    for n, a in named.items():
        assert tuple(a.shape) == tuple(ported[n].shape), n
    layer = 0
    for i, (_, count) in enumerate(jcfg.segments):
        seg = jax.tree_util.tree_flatten_with_path(params[f"seg{i}"])[0]
        for path, leaf in seg:
            key = ".".join(p.key for p in path)
            back = np.stack([named[f"layers.{layer + j}.{key}"]
                             for j in range(count)])
            assert np.array_equal(back, np.asarray(leaf)), key
        layer += count
    toks = {"tokens": jnp.asarray(_tokens(jcfg))}
    step = jax.jit(jts.make_train_step(jcfg, jadamw.AdamWConfig(lr=LR)))
    p, o = params, jadamw.init(params)
    for _ in range(2):
        p, o, _ = step(p, o, toks)
    opt = opt_state_from_reference(jax.tree.map(np.asarray, o), tcfg)
    assert int(opt["count"]) == 2 and opt["count"].dtype == torch.int32
    for part in ("m", "v"):
        want = _named(o[part], jcfg)
        assert set(opt[part]) == set(ported)
        for n, t in opt[part].items():
            assert t.dtype == torch.float32
            assert np.array_equal(t.numpy(), want[n]), (part, n)


def test_step_refuses_what_it_cannot_run():
    """A mesh with a "model" axis builds a step (the sharded step runs
    it); an axis the step does not know, and compression without a pod
    axis, are refused."""
    cfg = _reduced(registry, "qwen3-8b")
    opt_cfg = adamw.AdamWConfig()

    def mesh(names, shape):
        return type("Mesh", (), {"mesh_dim_names": names, "shape": shape})()

    assert callable(tts.make_train_step(cfg, opt_cfg,
                                        mesh=mesh(("data", "model"), (1, 2))))
    with pytest.raises(ValueError, match="not among"):
        tts.make_train_step(cfg, opt_cfg, mesh=mesh(("data", "seq"), (1, 2)))
    with pytest.raises(ValueError, match="pod"):
        tts.make_train_step(cfg, opt_cfg, grad_compression=True)


# ------------------------------------------------------------ the pipeline
def test_pipeline_matches_jax():
    docs_j = jpipe.synthetic_documents(96, 40, 1000, seed=3)
    docs_t = tpipe.synthetic_documents(96, 40, 1000, seed=3)
    assert docs_t.dtype == docs_j.dtype and np.array_equal(docs_t, docs_j)
    stream = np.concatenate([docs_j, docs_j[::7], docs_j[5:9]])
    ij, it = jpipe.StreamingIngest(), tpipe.StreamingIngest()
    kept_j = [ij.ingest(d) for d in stream]
    kept_t = [it.ingest(d) for d in stream]
    assert kept_t == kept_j and it.dups == ij.dups == 18
    assert len(it) == len(ij) == 96
    bj = jpipe.PackedBatches(ij, 4, 48, seed=5)
    bt = tpipe.PackedBatches(it, 4, 48, seed=5)
    for _ in range(3):
        a, b = next(bj), next(bt)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert b[k].dtype == a[k].dtype and np.array_equal(b[k], a[k])


# ------------------------------------------------------ gloo, two ranks
def _rank_main(rank, store_path, out_dir, params_np, toks, qgrads, qerrs):
    """One of two ranks: ``quantized_psum_mean`` on this rank's tree, a
    compressed step over a ("pod",) mesh and an exact one over a
    ("data",) mesh, each from the same weights placed on its mesh
    (``shard_model``: replicated over "pod", sharded over "data");
    writes its results."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import full_state, shard_model
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, 2)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    try:
        cfg = _reduced(registry, "qwen3-8b")
        out = {}
        pod = make_mesh((2,), ("pod",), device_type="cpu")
        red, err = compression.quantized_psum_mean(
            {k: torch.from_numpy(v[rank]) for k, v in qgrads.items()},
            {k: torch.from_numpy(v[rank]) for k, v in qerrs.items()},
            pod.get_group("pod"))
        out.update({f"q.red.{k}": t.numpy() for k, t in red.items()})
        out.update({f"q.err.{k}": t.numpy() for k, t in err.items()})
        batch = {"tokens": torch.from_numpy(toks)}
        for kind, mesh in (("comp", pod),
                           ("data", make_mesh((2,), ("data",),
                                              device_type="cpu"))):
            model = shard_model(params_from_reference(params_np, cfg), mesh)
            params = dict(model.named_parameters())
            opt = adamw.init(params)
            if kind == "comp":
                opt["error"] = compression.init_error(params)
            step = tts.make_train_step(cfg, adamw.AdamWConfig(lr=LR),
                                       grad_compression=kind == "comp",
                                       mesh=mesh)
            m = step(model, opt, batch)
            out[f"{kind}.loss"] = m["loss"].numpy()
            out.update({f"{kind}.p.{n}": t.numpy()
                        for n, t in full_state(params).items()})
            if kind == "comp":
                # each rank's own residual (replicated placement: no gather)
                out.update({f"comp.err.{n}": e.to_local().numpy()
                            for n, e in opt["error"].items()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(qwen, tmp_path_factory):
    """Run ``_rank_main`` on two spawned ranks (every wait bounded: a hung
    rank fails the tests instead of stalling the suite)."""
    jcfg, params, toks, _ = qwen
    tmp = tmp_path_factory.mktemp("gloo")
    rng = np.random.default_rng(4)
    shapes = {"a": (2, 8, 16), "b": (2, 33)}
    qgrads = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    qerrs = {k: (rng.standard_normal(s) * 1e-2).astype(np.float32)
             for k, s in shapes.items()}
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        r, str(tmp / "store"), str(tmp), jax.tree.map(np.asarray, params),
        toks, qgrads, qerrs)) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 240
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(timeout=10)
    assert not hung, "a gloo rank did not finish within 240 s"
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return qgrads, qerrs, ranks


def test_quantized_psum_mean_matches_jax_vmap(two_ranks):
    qgrads, qerrs, ranks = two_ranks
    red, err = jax.vmap(lambda g, e: jcomp.quantized_psum_mean(g, e, "pod"),
                        axis_name="pod")(
        {k: jnp.asarray(v) for k, v in qgrads.items()},
        {k: jnp.asarray(v) for k, v in qerrs.items()})
    for r, got in enumerate(ranks):
        for k in qgrads:
            np.testing.assert_allclose(got[f"q.red.{k}"], np.asarray(red[k][r]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(got[f"q.err.{k}"], np.asarray(err[k][r]),
                                       rtol=1e-6, atol=1e-7)
    # both ranks hold the same mean; the residual is each rank's own
    for k in qgrads:
        assert np.array_equal(ranks[0][f"q.red.{k}"], ranks[1][f"q.red.{k}"])
        assert np.abs(ranks[0][f"q.err.{k}"]).max() > 0


def test_compressed_step_close_to_jax_exact(two_ranks, qwen):
    """The reference test's bounds on the leaf it checks (the params'
    second leaf, ``final_norm``'s scale); every other weight within
    2 * LR, what one AdamW step moves a weight at most: a gradient element
    that int8 rounds to zero or across zero moves by up to LR the other
    way."""
    jcfg, _, _, after = qwen
    jp, _, jm = after[0]
    want = _named(jp, jcfg)
    for got in two_ranks[2]:
        assert abs(float(got["comp.loss"]) - float(jm["loss"])) < 1e-4
        np.testing.assert_allclose(got["comp.p.final_norm.scale"],
                                   want["final_norm.scale"], atol=5e-4,
                                   rtol=5e-2)
        for n, w in want.items():
            np.testing.assert_allclose(got[f"comp.p.{n}"], w, atol=2 * LR,
                                       rtol=0, err_msg=n)
        assert any(np.abs(got[f"comp.err.{n}"]).max() > 0 for n in want)


def test_data_parallel_step_matches_jax(two_ranks, qwen):
    """An exact step over a 2-rank "data" axis, each rank on 4 of the 8
    rows, equals JAX's single-device step within the single-step bound."""
    jcfg, _, _, after = qwen
    jp, _, jm = after[0]
    want = _named(jp, jcfg)
    for got in two_ranks[2]:
        assert abs(float(got["data.loss"]) - float(jm["loss"])) < 1e-5
        for n, w in want.items():
            np.testing.assert_allclose(got[f"data.p.{n}"], w, atol=2e-5,
                                       err_msg=n)


# ------------------------------------------------------- trainer and CLI
def _batches(cfg, seed=0):
    ing = tpipe.StreamingIngest()
    for d in tpipe.synthetic_documents(64, 40, cfg.vocab):
        ing.ingest(d)
    return tpipe.PackedBatches(ing, batch=B, seq_len=S, seed=seed)


def test_trainer_restart_equals_uninterrupted_run(tmp_path):
    """4 steps saving at step 2 only; a new Trainer restores step 2 and
    runs the pipeline's batches 3 and 4: params, m, v and count equal the
    uninterrupted run's bit for bit (bf16 params through fp32 files)."""
    cfg = registry.get_config("qwen3-8b").reduced(remat="none")
    opt_cfg = adamw.AdamWConfig(lr=schedules.cosine_with_warmup(3e-3, 2, 8))
    a = Trainer(cfg, device="cpu", opt_cfg=opt_cfg, ckpt_dir=str(tmp_path))
    batches = _batches(cfg)
    h = a.run(batches, 2, ckpt_every=2, log_every=0)
    h += a.run(batches, 2, log_every=0)
    assert [e["step"] for e in h] == [1, 2, 3, 4]
    assert all(np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"])
               and e["sec"] > 0 for e in h)

    b = Trainer(cfg, device="cpu", opt_cfg=opt_cfg, ckpt_dir=str(tmp_path))
    assert b.step == 2
    resumed = _batches(cfg)
    next(resumed), next(resumed)
    hb = b.run(resumed, 2, log_every=0)
    assert [e["step"] for e in hb] == [3, 4]
    assert [e["loss"] for e in hb] == [e["loss"] for e in h[2:]]
    for name, p in a.params.items():
        assert p.dtype == torch.bfloat16
        assert torch.equal(b.params[name], p), name
        assert torch.equal(b.opt_state["m"][name], a.opt_state["m"][name])
        assert torch.equal(b.opt_state["v"][name], a.opt_state["v"][name])
    assert int(b.opt_state["count"]) == int(a.opt_state["count"]) == 4


def test_trainer_defaults_to_cuda():
    cfg = _reduced(registry, "qwen3-8b")
    if torch.cuda.is_available():
        assert Trainer(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg)


def test_train_cli_on_cpu(capsys):
    from repro_torch.launch.train import main

    hist = main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu",
                 "--steps", "3", "--batch", "2", "--seq", "16",
                 "--ckpt-every", "0"])
    assert [e["step"] for e in hist] == [1, 2, 3]
    assert all(np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"])
               for e in hist)
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--mesh", "single"], ["--mesh", "multi"],
                                   ["--grad-compression"]])
def test_train_cli_refuses_what_needs_a_mesh(flags, monkeypatch):
    """Outside a 256- or 512-rank world, ``--mesh single|multi`` exits
    naming the rank count it needs; compression without a pod axis
    exits."""
    from repro_torch.launch.train import main

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as e:
        main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu", *flags])
    assert e.value.code != 0
    if flags[0] == "--mesh":
        need = {"single": 256, "multi": 512}[flags[1]]
        assert f"needs {need} ranks" in str(e.value.code)
        assert "this world has 1" in str(e.value.code)


# ---------------------------------------------- serving stays inference
def test_serving_builds_no_graph_after_requires_grad():
    """With every parameter requiring grad, the prefill, decode and
    encode steps and the paged engine return tensors that do not require
    grad, and the same tokens as before.  The logits agree to 1e-5, not
    bit for bit: ``torch.matmul`` does not fold (B, S, d) @ (d, n) into
    one 2-D product when the weight requires grad, even under
    ``no_grad``."""
    from repro_torch.serve import steps
    from repro_torch.serve.engine import Engine, Request

    cfg = _reduced(registry, "qwen3-8b")
    model = TT.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, rows=2)).long()
    enc_cfg = _reduced(registry, "hubert-xlarge")
    enc = TT.init_params(enc_cfg, seed=0, device="cpu")
    e = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, S, enc_cfg.d_model)).astype(np.float32))
    prompts = [_tokens(cfg, rows=1, seed=s)[0, :9].tolist() for s in (5, 6)]

    def serve():
        logits, cache = steps.make_prefill_step(cfg, S + 4)(
            model, {"tokens": toks})
        nxt, cache = steps.make_serve_step(cfg)(
            model, cache, logits[:, -1].argmax(-1), S)
        dec, _ = model.decode_step(nxt, cache, S + 1)
        encoded = steps.make_encode_step(enc_cfg)(enc, {"embeds": e})
        reqs = [Request(i, p, max_new_tokens=5) for i, p in enumerate(prompts)]
        Engine(cfg, model, max_batch=2, n_pages=64, page_size=8).run(reqs)
        out = (logits, dec, encoded, *(t for c in cache for t in c.values()))
        return out, (logits.argmax(-1).tolist(), nxt.tolist(),
                     dec.argmax(-1).tolist(), [r.out for r in reqs])

    before, tokens_before = serve()
    model.requires_grad_(True)
    enc.requires_grad_(True)
    assert all(p.requires_grad for p in model.parameters())
    after, tokens_after = serve()
    assert tokens_after == tokens_before
    for a, b in zip(after, before):
        assert not a.requires_grad and a.grad_fn is None
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
