"""The port's attention-backbone archs vs the JAX package's, on the CPU.

gemma-2b, starcoder2-3b (dense), deepseek-moe-16b (dense + moe),
mixtral-8x22b (moe_swa) and minicpm3-4b (mla), each reduced and in fp32:
the JAX params, carried across by ``params_from_reference``, give the
port's ``Transformer`` the same weights, so forward logits, the MoE aux
term, the prefill cache and 12 decode steps must agree to 1e-4 (abs and
rel, as ``test_torch_serving._close``).  MoE routing (the expert of each
(token, k) slot and whether the capacity kept it) must equal JAX's bit
for bit, with drops present; the sliding-window ring cache must match
JAX and the port's own full-length cache past its rollover.  Each JAX
side is computed once per arch.  The serving side of these archs is in
``test_torch_archs_engine.py``.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.models import transformer as JT
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models import registry
from repro_torch.models.convert import params_from_reference

ARCHS = ("gemma-2b", "starcoder2-3b", "deepseek-moe-16b", "mixtral-8x22b",
         "minicpm3-4b")
MOE_ARCHS = ("deepseek-moe-16b", "mixtral-8x22b")
B, S, N_DEC = 2, 20, 12          # S past the reduced swa_window of 16
CACHE_LEN = S + N_DEC


def _reduced(reg, arch, **kw):
    return dataclasses.replace(reg.get_config(arch).reduced(),
                               dtype="float32", remat="none", **kw)


def _pair(arch, seed=0, **kw):
    """(JAX cfg, port cfg, JAX params, port model) with the same weights."""
    jcfg, tcfg = _reduced(jregistry, arch, **kw), _reduced(registry, arch, **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    params = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    model = params_from_reference(jax.tree.map(np.asarray, params), tcfg)
    return jcfg, tcfg, params, model


def _close(jax_x, torch_x, tol=1e-4):
    np.testing.assert_allclose(torch_x.numpy(), np.asarray(jax_x),
                               atol=tol, rtol=tol)


def _layers(cfg):
    """(segment, index in segment) of each layer, in order."""
    return [(f"seg{i}", j) for i, (_, count) in enumerate(cfg.segments)
            for j in range(count)]


_jdecode = jax.jit(JT.decode_step, static_argnums=(1,))


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """Forward, prefill cache and N_DEC teacher-forced decode steps of one
    arch on both packages (the JAX side greedy, both fed its tokens)."""
    jcfg, tcfg, params, model = _pair(request.param)
    toks = np.random.default_rng(1).integers(1, jcfg.vocab, (B, S)).astype(
        np.int32)
    tt = torch.from_numpy(toks).long()
    lj, aux_j = JT.forward(params, jcfg, tokens=jnp.asarray(toks))
    _, _, cj = JT.forward(params, jcfg, tokens=jnp.asarray(toks),
                          build_cache_len=CACHE_LEN)
    lt, aux_t = model(tt)
    _, aux_tc, ct = model(tt, build_cache_len=CACHE_LEN)
    out = SimpleNamespace(cfg=tcfg, jcfg=jcfg, logits=(lj, lt),
                          aux=(aux_j, aux_t, aux_tc),
                          cache=(cj, [{k: v.clone() for k, v in c.items()}
                                      for c in ct]),
                          steps=[])
    tok = toks[:, -1]
    for s in range(N_DEC):
        ljs, cj = _jdecode(params, jcfg, jnp.asarray(tok), cj,
                           jnp.int32(S + s))
        lts, ct = model.decode_step(torch.from_numpy(tok).long(), ct, S + s)
        out.steps.append((np.asarray(ljs), lts))
        tok = np.asarray(jnp.argmax(ljs, -1)).astype(np.int32)
    return out


# ----------------------------------------------------------------- registry
@pytest.mark.parametrize("arch", ARCHS + ("xlstm-1.3b", "hymba-1.5b",
                                          "hubert-xlarge", "qwen2-vl-2b"))
def test_configs_are_copies(arch):
    """Each config equals the JAX one field for field, full size."""
    assert (dataclasses.asdict(registry.get_config(arch))
            == dataclasses.asdict(jregistry.get_config(arch)))


# ------------------------------------------------------------ whole models
def test_forward_and_aux_match_jax(run):
    _close(run.logits[0], run.logits[1])
    aux_j, aux_t, aux_tc = run.aux
    assert aux_t.dtype == torch.float32 and aux_t.shape == ()
    _close(aux_j, aux_t)
    assert torch.equal(aux_t, aux_tc)
    moe = any(k in ("moe", "moe_swa") for k, _ in run.cfg.segments)
    assert (float(aux_t) > 0) == moe


def test_prefill_cache_matches_jax(run):
    cj, ct = run.cache
    layers = _layers(run.cfg)
    assert len(ct) == len(layers)
    for (seg, j), c in zip(layers, ct):
        assert set(c) == set(cj[seg])
        for name, t in c.items():
            want = np.asarray(cj[seg][name][j])
            assert t.shape == want.shape, (seg, name)
            if name == "pos":
                assert t.dtype == torch.int32
                assert np.array_equal(t.numpy(), want)
            else:
                _close(want, t)


def test_decode_steps_match_jax(run):
    assert len(run.steps) == N_DEC
    for lj, lt in run.steps:
        assert lt.dtype == torch.float32
        _close(lj, lt)


# ---------------------------------------------------------------------- MoE
def _probe_weights(params, cfg, bias_expert=0):
    """Expert weights under which expert e's FFN returns the unit vector
    of coordinate 1 + e for any token whose coordinate 0 is 1, and shared
    experts return 0.  Then out[t, 1 + e] is the gate of (t, e) if the
    capacity kept that slot, else 0: JAX's own routing, read off its
    output.  The router favours ``bias_expert`` for every token, so the
    capacity drops slots at the default factor."""
    d, E = cfg.d_model, cfg.n_experts
    dff = cfg.d_expert or cfg.d_ff
    p = jax.tree.map(np.array, params)
    router = p["router"]
    router[0] = 0.0
    router[0, bias_expert] = 4.0
    wi = np.zeros((E, d, dff), np.float32)
    wi[:, 0, :] = 1.0                           # h = x[0] = 1
    wg = np.zeros_like(wi)
    wg[:, 0, :] = 20.0                          # silu(20) ~ 20
    scale = 1.0 / (dff * np.float32(jax.nn.silu(20.0)))
    wo = np.zeros((E, dff, d), np.float32)
    for e in range(E):
        wo[e, :, 1 + e] = scale
    p.update(router=router, wi=wi, wg=wg, wo=wo)
    if "shared" in p:
        p["shared"] = jax.tree.map(np.zeros_like, p["shared"])
    return p


def _moe_inputs(cfg, n_tok, seed):
    x = np.random.default_rng(seed).normal(size=(1, n_tok, cfg.d_model))
    x[..., 0] = 1.0
    return x.astype(np.float32)


def _torch_moe(p, cfg):
    mod = tmoe.MoE(cfg, torch.float32, "cpu")
    with torch.no_grad():
        for name, t in mod.named_parameters():
            src = p
            for part in name.split("."):
                src = src[part]
            t.copy_(torch.from_numpy(np.asarray(src)))
    return mod


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_routing_matches_jax_bit_for_bit(arch):
    """At the default capacity factor, with drops: the experts of every
    (token, k) slot and the kept/dropped mask equal JAX's."""
    jcfg, tcfg, params, _ = _pair(arch)
    seg = next(f"seg{i}" for i, (k, _) in enumerate(jcfg.segments)
               if k in ("moe", "moe_swa"))
    p = _probe_weights(jax.tree.map(lambda t: np.asarray(t[0]),
                                    params[seg]["moe"]), jcfg)
    n_tok = 24
    x = _moe_inputs(jcfg, n_tok, seed=3)
    jp = jax.tree.map(jnp.asarray, p)
    kept_j = np.asarray(jmoe.moe_mlp(jnp.asarray(x), jp, jcfg))[0, :, 1:1 + jcfg.n_experts]
    no_drop = dataclasses.replace(jcfg, capacity_factor=1e3)
    all_j = np.asarray(jmoe.moe_mlp(jnp.asarray(x), jp, no_drop))[0, :, 1:1 + jcfg.n_experts]

    mod = _torch_moe(p, tcfg)
    gate, eidx, order, keep, _, cap = tmoe.route(torch.from_numpy(x[0]), mod,
                                                 tcfg)
    assert cap == tmoe.capacity(n_tok, tcfg) == int(max(1, round(
        n_tok * jcfg.top_k / jcfg.n_experts * jcfg.capacity_factor)))
    K = tcfg.top_k
    kept = np.zeros((n_tok, K), bool)
    kept.reshape(-1)[order.numpy()] = keep.numpy()
    assert (~kept).sum() >= 1, "the case must drop at least one slot"
    assert kept.sum() >= n_tok, "and keep most"
    # expert assignment: the slots JAX routes with no capacity limit
    routed_t = np.zeros((n_tok, jcfg.n_experts), bool)
    np.put_along_axis(routed_t, eidx.numpy(), True, axis=1)
    assert np.array_equal(all_j > 0, routed_t)
    # kept/dropped mask: the slots JAX's capacity kept
    kept_t = np.zeros_like(routed_t)
    np.put_along_axis(kept_t, eidx.numpy(), kept, axis=1)
    assert np.array_equal(kept_j > 0, kept_t)
    gates = np.zeros_like(kept_j)
    np.put_along_axis(gates, eidx.numpy(), gate.numpy() * kept, axis=1)
    np.testing.assert_allclose(kept_j, gates, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mlp_with_drops_matches_jax(arch):
    """moe_mlp and the aux term on random weights whose router favours
    one expert: the default capacity drops slots in both packages."""
    jcfg, tcfg, params, _ = _pair(arch)
    seg = next(f"seg{i}" for i, (k, _) in enumerate(jcfg.segments)
               if k in ("moe", "moe_swa"))
    p = jax.tree.map(lambda t: np.array(t[0]), params[seg]["moe"])
    p["router"][0, 1] += 4.0
    x = _moe_inputs(jcfg, 24, seed=4).reshape(2, 12, -1)
    jp = jax.tree.map(jnp.asarray, p)
    mod = _torch_moe(p, tcfg)
    keep = tmoe.route(torch.from_numpy(x.reshape(24, -1)), mod, tcfg)[3]
    assert not bool(keep.all())
    tx = torch.from_numpy(x)
    _close(jmoe.moe_mlp(jnp.asarray(x), jp, jcfg), tmoe.moe_mlp(tx, mod, tcfg))
    _close(jmoe.aux_load_balance_loss(jnp.asarray(x), jp, jcfg),
           tmoe.aux_load_balance_loss(tx, mod, tcfg))


# --------------------------------------------------------------- ring cache
@pytest.mark.parametrize("prefill", [0, 150])
def test_swa_ring_cache_matches_jax_and_full_cache(prefill):
    """mixtral reduced with swa_window 8.  prefill 0: 40 decode steps from
    an empty init_cache ring (256 slots), as the reference test does.
    prefill 150: a prompt past window + 128 builds a ring of 136 slots,
    then 40 decode steps roll over it.  Both equal JAX's logits and the
    port's full-length cache's.  The full-length cache is built token by
    token, the ring by the prefill: capacity factor 8.0 (the reference
    test's) keeps both routings free of drops."""
    kw = {"capacity_factor": 8.0} if prefill else {}
    jcfg, tcfg, params, model = _pair("mixtral-8x22b", swa_window=8, **kw)
    n = 40
    toks = np.random.default_rng(5).integers(1, jcfg.vocab, (1, prefill + n))
    toks = toks.astype(np.int32)
    tt = torch.from_numpy(toks).long()
    if prefill:
        ring_len = prefill + n + 8
        _, _, cj = JT.forward(params, jcfg, tokens=jnp.asarray(toks[:, :prefill]),
                              build_cache_len=ring_len)
        _, _, ring = model(tt[:, :prefill], build_cache_len=ring_len)
        assert ring[0]["k"].shape[1] == jcfg.swa_window + 128 < prefill
        assert np.array_equal(np.asarray(cj["seg0"]["pos"][0]),
                              ring[0]["pos"].numpy())
    else:
        cj = JT.init_cache(jcfg, 1, 1 << 20)
        ring = model.init_cache(1, 1 << 20)
        assert ring[0]["k"].shape[1] == 256
    full = model.init_cache(1, prefill + n)
    assert full[0]["k"].shape[1] == prefill + n
    for i in range(prefill):
        _, full = model.decode_step(tt[:, i], full, i)
    for i in range(prefill, prefill + n):
        lj, cj = _jdecode(params, jcfg, jnp.asarray(toks[:, i]), cj,
                          jnp.int32(i))
        lr, ring = model.decode_step(tt[:, i], ring, i)
        lf, full = model.decode_step(tt[:, i], full, i)
        _close(lj, lr)
        torch.testing.assert_close(lr, lf, atol=1e-4, rtol=1e-4)
    if prefill:                      # the ring rolled over
        assert int(ring[0]["pos"].min()) > prefill + n - 1 - 136


# ---------------------------------------------------------------------- MLA
def test_mla_absorbed_decode_matches_jax():
    """One MLA layer's absorbed decode over a random latent cache, at
    several cache indices, against JAX's."""
    jcfg, tcfg, params, model = _pair("minicpm3-4b")
    p = jax.tree.map(lambda t: np.asarray(t[0]), params["seg0"]["attn"])
    rng = np.random.default_rng(6)
    m, T = jcfg.mla, 16
    x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(B, T, m.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(B, T, m.qk_rope_head_dim)).astype(np.float32)
    for idx in (0, 7, T - 1):
        pos = np.full((B, 1), idx, np.int32)
        oj, cj = jmla.mla_attention(
            jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg,
            positions=jnp.asarray(pos),
            cache={"c_kv": jnp.asarray(ckv), "k_rope": jnp.asarray(kr)},
            cache_index=idx)
        cache = {"c_kv": torch.from_numpy(ckv.copy()),
                 "k_rope": torch.from_numpy(kr.copy())}
        ot, ct = tmla.mla_attention(torch.from_numpy(x),
                                    model.layers[0].attn, tcfg,
                                    positions=torch.from_numpy(pos),
                                    cache=cache, cache_index=idx)
        _close(oj, ot)
        for name in ("c_kv", "k_rope"):
            _close(cj[name], ct[name])
