"""The port's recurrent and hybrid archs vs the JAX package's, on the CPU.

The mLSTM, sLSTM and Mamba blocks alone, with and without an incoming
state; xlstm-1.3b and hymba-1.5b reduced (the xLSTM cells; the hybrid
blocks with a windowed attention ring beside a Mamba state): forward
logits, the prefill caches and 8 decode steps; hubert-xlarge reduced
through ``make_encode_step`` and the embeds prefill.  Each is fp32 with the
JAX weights carried across by ``params_from_reference``, so the port must
agree to 1e-4 (abs and rel, as ``test_torch_serving._close``).  A
prefill-built state must continue as a stepwise one within the reference
test's 2e-3 (``tests/test_models.py::test_prefill_cache_matches_stepwise``),
and a hybrid ring past its rollover as a full-length cache.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jregistry
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.serve import steps as jsteps
from repro_torch.models import registry
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_reference
from repro_torch.serve import steps as tsteps

B, S, N_DEC = 2, 20, 8            # S past the reduced swa_window of 16
CACHE_LEN = S + N_DEC
BLOCKS = {"mlstm": (jssm.mlstm_params, jssm.mlstm_block, tssm.MLSTM,
                    tssm.mlstm_block),
          "slstm": (jssm.slstm_params, jssm.slstm_block, tssm.SLSTM,
                    tssm.slstm_block),
          "mamba": (jssm.mamba_params, jssm.mamba_block, tssm.Mamba,
                    tssm.mamba_block)}

_jforward = jax.jit(JT.forward, static_argnames=("cfg", "build_cache_len",
                                                 "last_logit_only"))
_jdecode = jax.jit(JT.decode_step, static_argnums=(1,))


def _reduced(reg, arch, **kw):
    return dataclasses.replace(reg.get_config(arch).reduced(),
                               dtype="float32", remat="none", **kw)


def _pair(arch, **kw):
    """(JAX cfg, port cfg, JAX params, port model) with the same weights."""
    jcfg, tcfg = _reduced(jregistry, arch, **kw), _reduced(registry, arch, **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    params = JT.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_reference(jax.tree.map(np.asarray, params), tcfg)
    return jcfg, tcfg, params, model


def _close(jax_x, torch_x, tol=1e-4):
    np.testing.assert_allclose(torch_x.numpy(), np.asarray(jax_x),
                               atol=tol, rtol=tol)


def _close_tree(jax_tree, torch_tree, tol=1e-4):
    """Nested dicts / tuples of arrays, leaf by leaf (``pos`` exactly)."""
    if isinstance(torch_tree, dict):
        assert set(torch_tree) == set(jax_tree)
        for k in torch_tree:
            if k == "pos":
                assert torch_tree[k].dtype == torch.int32
                assert np.array_equal(torch_tree[k].numpy(),
                                      np.asarray(jax_tree[k]))
            else:
                _close_tree(jax_tree[k], torch_tree[k], tol)
    elif isinstance(torch_tree, tuple):
        assert len(torch_tree) == len(jax_tree)
        for a, b in zip(jax_tree, torch_tree):
            _close_tree(a, b, tol)
    else:
        assert tuple(torch_tree.shape) == np.asarray(jax_tree).shape
        _close(jax_tree, torch_tree, tol)


def _layer(tree, j):
    return jax.tree.map(lambda t: np.asarray(t[j]), tree)


def _layers(cfg):
    return [(f"seg{i}", j) for i, (_, count) in enumerate(cfg.segments)
            for j in range(count)]


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_jax(kind, with_state):
    """One block over 12 tokens, from zero state or from the state a first
    run of 7 tokens left (carried across from JAX)."""
    jparams, jblock, tmod, tblock = BLOCKS[kind]
    arch = "hymba-1.5b" if kind == "mamba" else "xlstm-1.3b"
    cfg = _reduced(registry, arch)
    p = jparams(jax.random.PRNGKey(3), cfg, jnp.float32)
    mod = tmod(cfg, torch.float32, "cpu")
    with torch.no_grad():
        for name, t in mod.named_parameters():
            src = np.array(p[name])
            assert src.shape == tuple(t.shape) and src.dtype == np.float32
            t.copy_(torch.from_numpy(src))
    rng = np.random.default_rng(4)
    x0 = rng.normal(size=(B, 7, cfg.d_model)).astype(np.float32)
    x = rng.normal(size=(B, 12, cfg.d_model)).astype(np.float32)
    jstate = tstate = None
    if with_state:
        _, jstate = jblock(jnp.asarray(x0), p, cfg)
        tstate = jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                              tuple(jstate))
    oj, sj = jblock(jnp.asarray(x), p, cfg, state=jstate)
    ot, st = tblock(torch.from_numpy(x), mod, cfg, state=tstate)
    _close(oj, ot)
    _close_tree(tuple(sj), st)


# ------------------------------------------------------------ whole models
@pytest.fixture(scope="module", params=("xlstm-1.3b", "hymba-1.5b"))
def run(request):
    """Forward, prefill cache and N_DEC teacher-forced decode steps of one
    arch on both packages (the JAX side greedy, both fed its tokens)."""
    jcfg, tcfg, params, model = _pair(request.param)
    toks = np.random.default_rng(1).integers(1, jcfg.vocab, (B, S)).astype(
        np.int32)
    tt = torch.from_numpy(toks).long()
    lj, _ = _jforward(params, jcfg, tokens=jnp.asarray(toks))
    _, _, cj = _jforward(params, jcfg, tokens=jnp.asarray(toks),
                         build_cache_len=CACHE_LEN)
    lt, _ = model(tt)
    _, _, ct = model(tt, build_cache_len=CACHE_LEN)
    out = SimpleNamespace(cfg=tcfg, logits=(lj, lt),
                          cache=(cj, jax.tree.map(torch.clone, ct)), steps=[])
    tok = toks[:, -1]
    for s in range(N_DEC):
        ljs, cj = _jdecode(params, jcfg, jnp.asarray(tok), cj,
                           jnp.int32(S + s))
        lts, ct = model.decode_step(torch.from_numpy(tok).long(), ct, S + s)
        out.steps.append((np.asarray(ljs), lts))
        tok = np.asarray(jnp.argmax(ljs, -1)).astype(np.int32)
    out.final_cache = (cj, ct)
    return out


def test_forward_matches_jax(run):
    _close(run.logits[0], run.logits[1])


def test_prefill_cache_matches_jax(run):
    """The mlstm/slstm state tuples and the hybrid {"kv": ring or padded
    KV, "ssm": (s, conv tail)} dicts, layer by layer."""
    cj, ct = run.cache
    layers = _layers(run.cfg)
    assert len(ct) == len(layers)
    for (seg, j), c in zip(layers, ct):
        _close_tree(_layer(cj[seg], j), c)
    for c in ct:
        if isinstance(c, dict):      # hybrid: rings of min(CACHE_LEN, 144)
            assert c["kv"]["k"].shape[1] == CACHE_LEN
            assert c["ssm"][0].dtype == torch.float32
        else:                        # mlstm (3) or slstm (4) fp32 states
            assert len(c) in (3, 4)
            assert all(t.dtype == torch.float32 for t in c)


def test_decode_steps_match_jax(run):
    assert len(run.steps) == N_DEC
    for lj, lt in run.steps:
        assert lt.dtype == torch.float32
        _close(lj, lt)
    cj, ct = run.final_cache
    for (seg, j), c in zip(_layers(run.cfg), ct):
        _close_tree(_layer(cj[seg], j), c)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "hymba-1.5b"])
def test_prefill_state_matches_stepwise(arch):
    """The port alone: a prefill-built cache and one built token by token
    give the same greedy tokens for N_DEC steps, logits within 2e-3."""
    _, cfg, _, model = _pair(arch)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab, (B, 8)))
    logits, _, pf = model(toks, build_cache_len=8 + N_DEC)
    st = model.init_cache(B, 8 + N_DEC)
    for i in range(8):
        lg, st = model.decode_step(toks[:, i], st, i)
    torch.testing.assert_close(logits[:, -1], lg, atol=2e-3, rtol=2e-3)
    a = b = lg.argmax(-1)
    for s in range(N_DEC):
        la, pf = model.decode_step(a, pf, 8 + s)
        lb, st = model.decode_step(b, st, 8 + s)
        torch.testing.assert_close(la, lb, atol=2e-3, rtol=2e-3)
        a, b = la.argmax(-1), lb.argmax(-1)
        assert torch.equal(a, b)


def test_hybrid_ring_past_rollover_matches_jax_and_full_cache():
    """hymba reduced, window 16: a 160-token prompt builds rings of
    window + 128 = 144 slots on the ``hybrid`` layers (full length on
    ``hybrid_global``); 40 decode steps roll them over and equal JAX's
    logits and the port's full-length cache built token by token."""
    jcfg, tcfg, params, model = _pair("hymba-1.5b")
    prefill, n = 160, 40
    toks = np.random.default_rng(5).integers(1, jcfg.vocab,
                                             (1, prefill + n)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    ring_len = prefill + n + 8
    _, _, cj = _jforward(params, jcfg, tokens=jnp.asarray(toks[:, :prefill]),
                         build_cache_len=ring_len)
    _, _, ring = model(tt[:, :prefill], build_cache_len=ring_len)
    kinds = [k for k, c in tcfg.segments for _ in range(c)]
    for kind, c in zip(kinds, ring):
        want = 144 if kind == "hybrid" else ring_len
        assert c["kv"]["k"].shape[1] == want, kind
    full = model.init_cache(1, ring_len)
    for i in range(prefill):
        _, full = model.decode_step(tt[:, i], full, i)
    for i in range(prefill, prefill + n):
        lj, cj = _jdecode(params, jcfg, jnp.asarray(toks[:, i]), cj,
                          jnp.int32(i))
        lr, ring = model.decode_step(tt[:, i], ring, i)
        lf, full = model.decode_step(tt[:, i], full, i)
        _close(lj, lr)
        torch.testing.assert_close(lr, lf, atol=1e-4, rtol=1e-4)
    hyb = kinds.index("hybrid")
    assert int(ring[hyb]["kv"]["pos"].min()) > prefill + n - 1 - 144


# -------------------------------------------------------------- hubert
def test_hubert_encode_and_embeds_prefill_match_jax():
    """hubert-xlarge reduced (encoder-only, LayerNorm, gelu): the encode
    step's logits over frame embeddings, and the embeds prefill's last
    logits and padded KV caches."""
    jcfg, tcfg, params, model = _pair("hubert-xlarge")
    assert tcfg.encoder_only
    e = np.random.default_rng(6).normal(size=(B, S, jcfg.d_model)).astype(
        np.float32)
    lj = jsteps.make_encode_step(jcfg)(params, {"embeds": jnp.asarray(e)})
    lt = tsteps.make_encode_step(tcfg)(model, {"embeds": torch.from_numpy(e)})
    assert lt.shape == (B, S, jcfg.vocab)
    _close(lj, lt)
    lj, cj = jsteps.make_prefill_step(jcfg, CACHE_LEN)(
        params, {"embeds": jnp.asarray(e)})
    lt, ct = tsteps.make_prefill_step(tcfg, CACHE_LEN)(
        model, {"embeds": torch.from_numpy(e)})
    _close(lj, lt)
    for (seg, j), c in zip(_layers(tcfg), ct):
        _close_tree(_layer(cj[seg], j), c)


def test_bf16_hybrid_keeps_fp32_leaves():
    """A bf16 hymba: ``a_log``, ``d_skip`` and ``dt_bias`` stay fp32 in
    both packages, and ``params_from_reference`` refuses a leaf whose
    dtype differs."""
    jcfg = dataclasses.replace(jregistry.get_config("hymba-1.5b").reduced(),
                               remat="none")
    tcfg = dataclasses.replace(registry.get_config("hymba-1.5b").reduced(),
                               remat="none")
    assert tcfg.dtype == "bfloat16"
    params = jax.tree.map(np.asarray,
                          JT.init_params(jax.random.PRNGKey(0), jcfg))
    model = params_from_reference(params, tcfg)
    cell = model.layers[0].cell
    for name in ("a_log", "d_skip", "dt_bias"):
        assert getattr(cell, name).dtype == torch.float32, name
    assert cell.w_in.dtype == torch.bfloat16
    params["seg0"]["cell"]["a_log"] = params["seg0"]["cell"]["a_log"].astype(
        jnp.bfloat16)
    with pytest.raises(ValueError, match="a_log"):
        params_from_reference(params, tcfg)
