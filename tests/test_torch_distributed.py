"""The port's sharded training (``distributed/sharding.py``, the sharded
train step, ``elastic_resize``) against the JAX package's, on the CPU.

``param_specs`` is held against JAX's for every arch of the registry at
its full size, name by name (JAX's leading layer dim dropped), on a
(2, 2, 2) mesh and on the production sizes (16, 16) and (2, 16, 16),
which have no devices here (``jax.sharding.AbstractMesh``).

One module fixture spawns 4 ``gloo`` ranks, another 2; every join is
bounded by 240 s.  On 4 ranks: a sharded step of qwen3-8b reduced (fp32)
on a ("data", "model") (2, 2) mesh against JAX's single-device step (the
reference's bounds, ``tests/test_distributed.py:62-85``: loss 1e-4, its
checked leaf within atol and rtol 2e-5; every gradient at this suite's
gradient bounds); the same for deepseek-moe-16b against JAX's
step jitted under ``mesh_context`` of the same mesh, whose MoE dispatch
groups are the data-parallel shards, as the port's ranks' rows are; a
compressed step on a ("pod", "data", "model") (2, 1, 2) mesh against the
port's own exact step on it (JAX cannot run a 3-axis compressed step,
the KNOWN LIMITATION of ``repro/optim/compression.py``); and a sharded
``Trainer`` that saves step 1 and restores it, and the train CLI's
``--mesh`` path from a ``torchrun``-style environment.  On 2 ranks:
``elastic_resize`` of that checkpoint onto a (1, 2) mesh, bit for bit,
and one finite step there.
"""
import dataclasses
import datetime
import multiprocessing
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.distributed.sharding import param_specs as jparam_specs
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.launch.mesh import mesh_context as jmesh_context
from repro.models import registry as jregistry
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch.distributed import sharding
from repro_torch.models import registry
from repro_torch.models.convert import named_from_reference
from repro_torch.models.transformer import Transformer

LR = 1e-3
MESHES = (((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))


def _reduced(reg, arch, **kw):
    return dataclasses.replace(reg.get_config(arch).reduced(),
                               **{"dtype": "float32", "remat": "none", **kw})


def _tokens(cfg, rows=8, seq=16, seed=1):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab, (rows, seq)).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jax_specs_by_port_name(specs, cfg, ndims):
    """JAX's spec tree as ``{port name: tuple}``: each ``seg{i}`` spec's
    leading (layer) entry dropped, trailing ``None`` made explicit."""
    out = {k: tuple(v) for k, v in
           _flat({k: v for k, v in specs.items()
                  if not k.startswith("seg")}).items()}
    layer = 0
    for i, (_, count) in enumerate(cfg.segments):
        seg = _flat(specs[f"seg{i}"])
        for j in range(count):
            out.update({f"layers.{layer + j}.{k}": tuple(v)[1:]
                        for k, v in seg.items()})
        layer += count
    return {n: s + (None,) * (ndims[n] - len(s)) for n, s in out.items()}


@pytest.mark.parametrize("arch", registry.list_archs())
def test_param_specs_match_jax(arch):
    jcfg = jregistry.get_config(arch)
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    model = Transformer(registry.get_config(arch), device="meta")
    named = {n: tuple(p.shape) for n, p in model.named_parameters()}
    ndims = {n: len(s) for n, s in named.items()}
    sharded = 0
    for dims, axes in MESHES:
        want = _jax_specs_by_port_name(
            jparam_specs(shapes, AbstractMesh(dims, axes)), jcfg, ndims)
        got = sharding.param_specs(named, dict(zip(axes, dims)))
        assert set(got) == set(want)
        for n in got:
            assert got[n] == want[n], (dims, n)
        sharded += sum(any(got[n]) for n in got)
    assert sharded > 0


def test_param_specs_without_mesh_and_placements():
    """No mesh: every spec is its first candidate, as the reference's; a
    spec's placements shard the mesh dim its axis names."""
    from torch.distributed.tensor import Replicate, Shard

    cfg = registry.get_config("mixtral-8x22b").reduced()
    model = Transformer(cfg, device="meta")
    specs = sharding.param_specs(model)
    assert specs["layers.0.moe.wi"] == ("model", "data", None)
    assert specs["layers.0.moe.router"] == (None, None)
    assert specs["final_norm.scale"] == (None,)
    mesh = type("Mesh", (), {"mesh_dim_names": ("pod", "data", "model")})()
    assert sharding.placements(("model", "data", None), mesh) == [
        Replicate(), Shard(1), Shard(0)]
    assert sharding.mesh_axis_size("model") == 1
    x = torch.ones(3)
    assert sharding.constrain(x, "batch") is x


# ----------------------------------------------------- JAX's reference steps
@pytest.fixture(scope="module")
def jax_steps():
    """JAX's single-device step of qwen3-8b and its step of
    deepseek-moe-16b under ``mesh_context`` of a (2, 2) mesh, each from
    ``PRNGKey(0)`` weights on 8 x 16 tokens."""
    out = {}
    for arch in ("qwen3-8b", "deepseek-moe-16b"):
        cfg = _reduced(jregistry, arch)
        params = JT.init_params(jax.random.PRNGKey(0), cfg)
        toks = _tokens(cfg)
        batch = {"tokens": jnp.asarray(toks)}
        step = jts.make_train_step(cfg, jadamw.AdamWConfig(lr=LR))
        opt = jadamw.init(params)
        if arch == "qwen3-8b":
            p, o, m = jax.jit(step)(params, opt, batch)
        else:
            mesh = jmake_mesh((2, 2), ("data", "model"))
            psh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                               jparam_specs(params, mesh))
            params_s = jax.device_put(params, psh)
            opt_s = jax.device_put(opt, {"m": psh, "v": psh,
                                         "count": NamedSharding(mesh, P())})
            with jmesh_context(mesh):
                batch_s = jax.device_put(batch, NamedSharding(mesh,
                                                              P("data")))
                p, o, m = jax.jit(step)(params_s, opt_s, batch_s)
        out[arch] = dict(
            params=jax.tree.map(np.asarray, params), toks=toks,
            p=named_from_reference(jax.tree.map(np.asarray, p), cfg),
            m=named_from_reference(jax.tree.map(np.asarray, o["m"]), cfg),
            v=named_from_reference(jax.tree.map(np.asarray, o["v"]), cfg),
            loss=float(m["loss"]), aux=float(m["aux_loss"]))
    return out


# ------------------------------------------------------------ spawned ranks
def _init(rank, world, store_path):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))


def _save_full(out, prefix, model, opt):
    """Copies of the full params, m and v: every rank gathers
    (collectives), the caller keeps rank 0's; bf16 as float32 (exact)."""
    host = sharding.full_state({"p": dict(model.named_parameters()),
                                "m": opt["m"], "v": opt["v"]})
    for part, tree in host.items():
        out.update({f"{prefix}.{part}.{n}": t.float().numpy()
                    for n, t in tree.items()})


def _placed_as_specs(model, opt, mesh) -> bool:
    from torch.distributed.tensor import DTensor

    specs = sharding.param_specs(model, mesh)
    ok = True
    for n, p in model.named_parameters():
        want = sharding.placements(specs[n], mesh)
        for t in (p, opt["m"][n], opt["v"][n]):
            ok &= isinstance(t, DTensor) and list(t.placements) == want
    return ok


def _rank4(rank, store_path, out_dir, ckpt_dir, inputs, port):
    """One of 4 ranks (module docstring); rank 0 writes the results."""
    import torch.distributed as dist

    from repro_torch.launch import train as train_cli

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import params_from_reference
    from repro_torch.optim import adamw, compression
    from repro_torch.train import train_step as tts
    from repro_torch.train.trainer import Trainer

    _init(rank, 4, store_path)
    try:
        out = {}
        mesh22 = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        for arch in ("qwen3-8b", "deepseek-moe-16b"):
            cfg = _reduced(registry, arch)
            params_np, toks = inputs[arch]
            model = sharding.shard_model(
                params_from_reference(params_np, cfg), mesh22)
            opt = adamw.init(dict(model.named_parameters()))
            step = tts.make_train_step(cfg, adamw.AdamWConfig(lr=LR),
                                       mesh=mesh22)
            model.requires_grad_(True)
            grads, _, _ = tts._grads_microbatched(
                tts.make_loss_fn(cfg), model, {"tokens": torch.from_numpy(
                    toks[:2])}, 1)
            m = step(model, opt, {"tokens": torch.from_numpy(toks)})
            out[f"{arch}.loss"] = m["loss"].numpy()
            out[f"{arch}.aux"] = m["aux_loss"].numpy()
            out[f"{arch}.placed"] = np.asarray(
                _placed_as_specs(model, opt, mesh22) and all(
                    list(grads[n].placements) == list(p.placements)
                    for n, p in model.named_parameters()))
            _save_full(out, arch, model, opt)

        # compressed vs exact, both sharded on a (2, 1, 2) mesh; every rank
        # also keeps its own shards: what entered the compressed pod mean
        # (x), its mean and residual, and m and the clipping norm of both
        mesh3 = make_mesh((2, 1, 2), ("pod", "data", "model"),
                          device_type="cpu")
        cfg = _reduced(registry, "qwen3-8b")
        params_np, toks = inputs["qwen3-8b"]
        mine = {"pod": np.asarray(mesh3.get_local_rank("pod")),
                "model": np.asarray(mesh3.get_local_rank("model"))}
        psum_mean = compression.quantized_psum_mean

        def recorded(grads, error, *args, **kw):
            red, err = psum_mean(grads, error, *args, **kw)
            for n in grads:
                mine[f"x.{n}"] = (grads[n].float() + error[n]).numpy()
                mine[f"red.{n}"] = red[n].float().numpy()
                mine[f"err.{n}"] = err[n].numpy()
            return red, err

        compression.quantized_psum_mean = recorded
        for kind in ("exact", "comp"):
            model = sharding.shard_model(
                params_from_reference(params_np, cfg), mesh3)
            params = dict(model.named_parameters())
            opt = adamw.init(params)
            if kind == "comp":
                opt["error"] = compression.init_error(params)
            step = tts.make_train_step(cfg, adamw.AdamWConfig(lr=LR),
                                       grad_compression=kind == "comp",
                                       mesh=mesh3)
            m = step(model, opt, {"tokens": torch.from_numpy(toks)})
            out[f"{kind}.loss"] = m["loss"].numpy()
            out.update({f"{kind}.p.{n}": p.full_tensor().detach().numpy()
                        for n, p in params.items()})
            mine[f"{kind}.grad_norm"] = m["grad_norm"].numpy()
            mine.update({f"{kind}.m.{n}": t.to_local().numpy()
                         for n, t in opt["m"].items()})
            if kind == "comp":
                out.update({f"comp.err.{n}": e.full_tensor().numpy()
                            for n, e in opt["error"].items()})
        compression.quantized_psum_mean = psum_mean
        np.savez(os.path.join(out_dir, f"comp_rank{rank}.npz"), **mine)

        # a sharded Trainer (registry config: bf16, remat "layer") saves
        # step 1; a second one on the same directory restores it
        tcfg = registry.get_config("qwen3-8b").reduced()
        batch = {"tokens": _tokens(tcfg)}
        a = Trainer(tcfg, device="cpu", mesh=mesh22, ckpt_dir=ckpt_dir,
                    opt_cfg=adamw.AdamWConfig(lr=LR))
        a.run([batch], 1, ckpt_every=1, log_every=0)
        _save_full(out, "trainer", a.model, a.opt_state)
        b = Trainer(tcfg, device="cpu", mesh=mesh22, ckpt_dir=ckpt_dir,
                    opt_cfg=adamw.AdamWConfig(lr=LR), seed=1)
        same = b.step == 1 and int(b.opt_state["count"]) == 1
        for n, p in a.params.items():
            same &= torch.equal(b.params[n].to_local(), p.to_local())
            for k in ("m", "v"):
                same &= torch.equal(b.opt_state[k][n].to_local(),
                                    a.opt_state[k][n].to_local())
        out["trainer.restored"] = np.asarray(bool(same))
        out["trainer.placed"] = np.asarray(
            _placed_as_specs(a.model, a.opt_state, mesh22))
        dist.destroy_process_group()

        # the train CLI's --mesh path as torchrun starts it, its production
        # shape cut to (2, 2)
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                          RANK=str(rank), LOCAL_RANK=str(rank),
                          WORLD_SIZE="4")
        train_cli.production_shape = lambda multi_pod=False: (
            (2, 2), ("data", "model"))
        import repro_torch.launch.mesh as mesh_mod
        mesh_mod.production_shape = train_cli.production_shape
        hist = train_cli.main(["--arch", "qwen3-8b", "--reduced", "--device",
                               "cpu", "--mesh", "single", "--steps", "2",
                               "--batch", "4", "--seq", "16",
                               "--ckpt-every", "0"])
        out["cli.steps"] = np.asarray([h["step"] for h in hist])
        out["cli.loss"] = np.asarray([h["loss"] for h in hist])
        if rank == 0:
            np.savez(os.path.join(out_dir, "ranks4.npz"), **out)
        dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _rank2(rank, store_path, out_dir, ckpt_dir):
    """One of 2 ranks: ``elastic_resize`` of the 4-rank Trainer's step 1
    onto a ("data", "model") (1, 2) mesh, then one step there."""
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed.fault_tolerance import elastic_resize
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as tts

    _init(rank, 2, store_path)
    try:
        cfg = registry.get_config("qwen3-8b").reduced()
        mesh = make_mesh((1, 2), ("data", "model"), device_type="cpu")
        like = dict(Transformer(cfg, device="meta").named_parameters())
        state = elastic_resize(Checkpointer(ckpt_dir), 1,
                               {"params": like, "opt": adamw.init(like)},
                               mesh, sharding.param_specs)
        model = sharding.shard_model(Transformer(cfg, device="meta"), mesh,
                                     params=state["params"])
        opt = state["opt"]
        out = {"placed": np.asarray(_placed_as_specs(model, opt, mesh)),
               "count": opt["count"].numpy()}
        _save_full(out, "resized", model, opt)
        step = tts.make_train_step(cfg, adamw.AdamWConfig(lr=LR), mesh=mesh)
        m = step(model, opt, {"tokens": torch.from_numpy(_tokens(cfg, 4))})
        out["loss"] = m["loss"].numpy()
        out["grad_norm"] = m["grad_norm"].numpy()
        out["stepped"] = np.asarray(all(
            np.isfinite(p.full_tensor().detach().float().numpy()).all()
            for p in model.parameters()))
        if rank == 0:
            np.savez(os.path.join(out_dir, "ranks2.npz"), **out)
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
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharded_ckpt"))


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def four_ranks(jax_steps, ckpt_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo4")
    inputs = {a: (r["params"], r["toks"]) for a, r in jax_steps.items()}
    _spawn(_rank4, 4, str(tmp / "store"), str(tmp), ckpt_dir, inputs,
           _free_port())
    return dict(np.load(tmp / "ranks4.npz"),
                comp_ranks=[dict(np.load(tmp / f"comp_rank{r}.npz"))
                            for r in range(4)])


@pytest.fixture(scope="module")
def two_ranks(four_ranks, ckpt_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo2")
    _spawn(_rank2, 2, str(tmp / "store"), str(tmp), ckpt_dir)
    return dict(np.load(tmp / "ranks2.npz"))


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-moe-16b"])
def test_sharded_step_matches_jax(four_ranks, jax_steps, arch):
    """One sharded step against JAX's.  The reference's bounds on what it
    checks: the loss within 1e-4 and its params' second leaf
    (``final_norm.scale``) within atol and rtol 2e-5.  Every gradient,
    read back from the first step's ``m = (1 - b1) g`` and ``v = (1 - b2)
    g^2``, within this suite's gradient bounds (atol 1e-5, rtol 1e-4),
    and every weight within 2 * LR, what one step can move it: AdamW's
    first step is ``lr * g / (|g| + eps)``, so on a gradient near
    ``eps`` rounding alone moves the weight by a share of LR (deepseek's
    largest: |g| ~5e-8, the two packages' weights 6.2e-5 apart).  Params,
    m, v and each gradient are DTensors placed by ``param_specs``."""
    want, got = jax_steps[arch], four_ranks
    assert got[f"{arch}.placed"]
    assert abs(float(got[f"{arch}.loss"]) - want["loss"]) < 1e-4
    if arch == "deepseek-moe-16b":
        assert want["aux"] > 0
        assert abs(float(got[f"{arch}.aux"]) - want["aux"]) < 1e-5
    np.testing.assert_allclose(got[f"{arch}.p.final_norm.scale"],
                               want["p"]["final_norm.scale"],
                               atol=2e-5, rtol=2e-5)
    b1, b2 = jadamw.AdamWConfig().b1, jadamw.AdamWConfig().b2
    for n in want["p"]:
        np.testing.assert_allclose(got[f"{arch}.m.{n}"] / (1 - b1),
                                   want["m"][n] / (1 - b1), atol=1e-5,
                                   rtol=1e-4, err_msg=f"m {n}")
        np.testing.assert_allclose(np.sqrt(got[f"{arch}.v.{n}"] / (1 - b2)),
                                   np.sqrt(want["v"][n] / (1 - b2)),
                                   atol=1e-5, rtol=1e-4, err_msg=f"v {n}")
        np.testing.assert_allclose(got[f"{arch}.p.{n}"], want["p"][n],
                                   atol=2 * LR, rtol=0, err_msg=f"p {n}")


def _clip(grad_norm) -> np.float32:
    """AdamW's clipping factor at ``clip_norm`` 1 (``optim/adamw.py``)."""
    return np.minimum(np.float32(1.0),
                      np.float32(1.0) / (np.float32(grad_norm)
                                         + np.float32(1e-9)))


def test_compressed_3_axis_step_close_to_exact(four_ranks):
    """The reference test's bounds on the leaf it checks
    (``final_norm.scale``, the params' second leaf); every other weight
    within 2 * LR (a gradient element int8 rounds to or across zero
    moves its weight by up to LR the other way).

    Then, rank by rank, on each one's shards: each tensor has one int8
    scale ``s = amax / 127``, ``amax`` taken over both pods and both
    model shards, and each rank's residual is its ``x`` minus ``x``
    quantized at that scale; the compressed mean is the mean of both
    pods' dequantized values; the exact step's gradient (read back from
    ``m = (1 - b1) * clip * g``) is the mean of both pods' ``x``; and the
    compressed step's gradient is within one int8 step ``s`` of it,
    element by element."""
    got = four_ranks
    assert abs(float(got["comp.loss"]) - float(got["exact.loss"])) < 1e-4
    np.testing.assert_allclose(got["comp.p.final_norm.scale"],
                               got["exact.p.final_norm.scale"],
                               atol=5e-4, rtol=5e-2)
    names = [k[len("exact.p."):] for k in got if k.startswith("exact.p.")]
    for n in names:
        np.testing.assert_allclose(got[f"comp.p.{n}"], got[f"exact.p.{n}"],
                                   atol=2 * LR, rtol=0, err_msg=n)
    assert any(np.abs(got[f"comp.err.{n}"]).max() > 0 for n in names)

    ranks = {(int(r["pod"]), int(r["model"])): r for r in got["comp_ranks"]}
    assert sorted(ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    b1 = np.float32(1 - jadamw.AdamWConfig().b1)
    shard_scales_differ = False
    for n in names:
        local_amax = [np.abs(r[f"x.{n}"]).max() for r in ranks.values()]
        s = np.maximum(max(local_amax), np.float32(1e-12)) / np.float32(127)
        over_pods = [max(np.abs(ranks[(0, k)][f"x.{n}"]).max(),
                         np.abs(ranks[(1, k)][f"x.{n}"]).max())
                     for k in (0, 1)]
        shard_scales_differ |= over_pods[0] != over_pods[1]
        q = {k: np.clip(np.round(r[f"x.{n}"] / s), -127, 127)
             for k, r in ranks.items()}
        for (pod, k), r in ranks.items():
            x, x_other = r[f"x.{n}"], ranks[(1 - pod, k)][f"x.{n}"]
            tiny = 1e-6 * s
            np.testing.assert_allclose(r[f"err.{n}"], x - q[(pod, k)] * s,
                                       rtol=0, atol=tiny,
                                       err_msg=f"residual {n} {pod, k}")
            np.testing.assert_allclose(
                r[f"red.{n}"], (q[(0, k)] + q[(1, k)]) * s / 2, rtol=1e-6,
                atol=tiny, err_msg=f"compressed mean {n} {pod, k}")
            g_exact = r[f"exact.m.{n}"] / b1 / _clip(r["exact.grad_norm"])
            g_comp = r[f"comp.m.{n}"] / b1 / _clip(r["comp.grad_norm"])
            np.testing.assert_allclose(g_exact, (x + x_other) / 2,
                                       rtol=1e-5, atol=tiny,
                                       err_msg=f"exact mean {n} {pod, k}")
            np.testing.assert_allclose(g_comp, r[f"red.{n}"], rtol=1e-5,
                                       atol=tiny,
                                       err_msg=f"compressed m {n} {pod, k}")
            assert np.all(np.abs(g_comp - g_exact) <= s), (n, pod, k)
    # the test tells a scale shared over the model shards from one each
    assert shard_scales_differ


def test_sharded_trainer_checkpoint_restores(four_ranks):
    assert four_ranks["trainer.placed"]
    assert four_ranks["trainer.restored"]


def test_train_cli_on_a_mesh(four_ranks):
    """``launch/train.py --mesh single`` in a ``torchrun``-style world of
    4 (its production shape cut to (2, 2)): the sharded Trainer runs."""
    assert list(four_ranks["cli.steps"]) == [1, 2]
    assert np.isfinite(four_ranks["cli.loss"]).all()


def test_elastic_resize_onto_a_smaller_mesh(four_ranks, two_ranks):
    """Saved on 4 ranks, restored on 2: params, m and v bit for bit,
    placed for the new mesh; one step there is finite."""
    assert two_ranks["placed"] and int(two_ranks["count"]) == 1
    names = [k[len("trainer.p."):] for k in four_ranks
             if k.startswith("trainer.p.")]
    assert names
    for n in names:
        for part in ("p", "m", "v"):
            a = four_ranks[f"trainer.{part}.{n}"]
            b = two_ranks[f"resized.{part}.{n}"]
            assert a.dtype == b.dtype and np.array_equal(a, b), (part, n)
    assert np.isfinite(two_ranks["loss"]) and np.isfinite(
        two_ranks["grad_norm"])
    assert two_ranks["stepped"]
