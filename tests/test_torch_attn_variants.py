"""The port's attention variants vs the JAX package's, on the CPU.

``blockwise_sdpa`` against JAX's at ``tests/test_blockwise.py``'s shapes,
with V narrower than Q/K (MLA), with int8 K/V and scales, and on a fully
masked row (pinned: the -1e30 recurrence weighs every slot of the chunks
it visits, padding included, where the naive ``_sdpa`` takes the mean of
the real V rows).  The model-level blockwise paths (causal, windowed,
bidir, MLA prefill, decode over a model-dtype and an int8 cache) run by
patching ``should_use_blockwise`` to True in both packages' ``layers``
and ``mla`` namespaces: a reduced config passes the real threshold only
at thousands of tokens.  M-RoPE (qwen2-vl-2b reduced) with distinct
(t, h, w) rows, and the int8 KV cache: ``_quantize_kv`` bit for bit, the
int8 decode against JAX's and within the reference test's accuracy bounds
of the model-dtype cache.  Tolerance 1e-4 (abs and rel) unless a test
says why; fp32 throughout.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blockwise_attn as jbw
from repro.models import layers as jl
from repro.models import mla as jmla
from repro.models import registry as jregistry
from repro.models import transformer as JT
from repro_torch.models import blockwise_attn as tbw
from repro_torch.models import layers as tl
from repro_torch.models import mla as tmla
from repro_torch.models import registry
from repro_torch.models.convert import params_from_reference

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


def _t(a):
    return torch.from_numpy(np.array(a))


def test_registry_lists_every_arch():
    assert registry.list_archs() == jregistry.list_archs()
    assert len(registry.list_archs()) == 10


# --------------------------------------------------------------- blockwise
def _qkv(rng, B, S, T, H, KVH, D, Dv=None):
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, KVH, D)).astype(np.float32)
    v = rng.normal(size=(B, T, KVH, Dv or D)).astype(np.float32)
    return q, k, v


def _positions(B, S, T):
    """The test_blockwise.py positions: a decode query at 150 over a cache
    whose slots past 150 are unwritten, else 0..S-1 and 0..T-1."""
    if S == 1:
        qpos = np.full((B, 1), 150)
        kpos = np.where(np.arange(T) <= 150, np.arange(T), -1)[None].repeat(B, 0)
    else:
        qpos = np.broadcast_to(np.arange(S), (B, S))
        kpos = np.broadcast_to(np.arange(T), (B, T))
    return qpos.astype(np.int32), kpos.astype(np.int32)


@pytest.mark.parametrize("B,S,T,H,KVH,D,kind,window", [
    (2, 64, 64, 8, 2, 32, "causal", None),
    (1, 100, 100, 4, 4, 16, "causal", 24),
    (2, 50, 50, 4, 2, 32, "bidir", None),
    (1, 1, 200, 8, 2, 32, "causal", None),     # decode: 1 query vs cache
    (1, 130, 130, 4, 1, 64, "causal", None),   # MQA, ragged chunks
])
def test_blockwise_matches_jax_and_naive(B, S, T, H, KVH, D, kind, window):
    """Against JAX's blockwise_sdpa (1e-4) and the port's naive ``_sdpa``
    (3e-5, the reference test's tolerance) at q_chunk 32, kv_chunk 64."""
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, B, S, T, H, KVH, D)
    qpos, kpos = _positions(B, S, T)
    kw = dict(kind=kind, window=window, q_chunk=32, kv_chunk=64)
    want = jbw.blockwise_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              qpos=jnp.asarray(qpos), kpos=jnp.asarray(kpos),
                              **kw)
    got = tbw.blockwise_sdpa(_t(q), _t(k), _t(v), qpos=_t(qpos),
                             kpos=_t(kpos), **kw)
    assert got.shape == (B, S, H, D) and got.dtype == torch.float32
    _close(want, got)
    if S == 1:
        m = ((_t(kpos) <= 150) & (_t(kpos) >= 0))[:, None, :]
    elif kind == "causal":
        m = tl.causal_mask(S, T, window=window).expand(B, S, T)
    else:
        m = torch.ones((B, S, T), dtype=torch.bool)
    naive = tl._sdpa(_t(q), _t(k), _t(v), m)
    torch.testing.assert_close(got, naive, atol=3e-5, rtol=0)


def test_blockwise_narrow_v_matches_jax():
    """Dv != D, as MLA (qk 96, v 64); the default chunks (512, 1024)
    with S past one query chunk."""
    rng = np.random.default_rng(1)
    B, S, H, D, Dv = 1, 600, 4, 96, 64
    q, k, v = _qkv(rng, B, S, S, H, H, D, Dv)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    want = jbw.blockwise_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              qpos=jnp.asarray(pos), kpos=jnp.asarray(pos))
    got = tbw.blockwise_sdpa(_t(q), _t(k), _t(v), qpos=_t(pos), kpos=_t(pos))
    assert got.shape == (B, S, H, Dv)
    _close(want, got)


def test_blockwise_int8_scales_match_jax_and_dequantized_naive():
    """int8 K/V with per (token, head) scales: JAX's blockwise (1e-4) and
    the naive ``_sdpa`` over the dequantized K/V (3e-5); out in q's dtype."""
    rng = np.random.default_rng(2)
    B, T, H, KVH, D = 2, 150, 4, 2, 32
    q, k, v = _qkv(rng, B, 1, T, H, KVH, D)
    (kw8, ks), (vw8, vs) = tl._quantize_kv(_t(k)), tl._quantize_kv(_t(v))
    qpos = np.full((B, 1), 120, np.int32)
    kpos = np.where(np.arange(T) <= 120, np.arange(T), -1)[None].repeat(B, 0)
    kpos = kpos.astype(np.int32)
    kw = dict(kind="causal", q_chunk=32, kv_chunk=64)
    want = jbw.blockwise_sdpa(
        jnp.asarray(q), jnp.asarray(kw8.numpy()), jnp.asarray(vw8.numpy()),
        qpos=jnp.asarray(qpos), kpos=jnp.asarray(kpos),
        kv_scales=(jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy())), **kw)
    got = tbw.blockwise_sdpa(_t(q), kw8, vw8, qpos=_t(qpos), kpos=_t(kpos),
                             kv_scales=(ks, vs), **kw)
    assert got.dtype == torch.float32
    _close(want, got)
    m = ((_t(kpos) <= 120) & (_t(kpos) >= 0))[:, None, :]
    naive = tl._sdpa(_t(q), kw8.float() * ks[..., None],
                     vw8.float() * vs[..., None], m)
    torch.testing.assert_close(got, naive, atol=3e-5, rtol=0)


def test_blockwise_fully_masked_row_is_pinned():
    """A query no key may attend (every stored position is ahead of it).
    The reference's -1e30 recurrence gives each slot of both 64-slot
    chunks weight exp(0) = 1, the 28 padded slots too: sum(V) / 128.  The
    naive ``_sdpa`` gives the mean of the 100 real V rows.  The port
    follows the reference (ROADMAP.md §3)."""
    rng = np.random.default_rng(3)
    B, T, H, D = 1, 100, 2, 16
    q, k, v = _qkv(rng, B, 1, T, H, H, D)
    qpos = np.full((B, 1), 5, np.int32)
    kpos = (np.arange(T)[None] + 10).astype(np.int32)      # all ahead of 5
    kw = dict(kind="causal", q_chunk=32, kv_chunk=64)
    want = jbw.blockwise_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              qpos=jnp.asarray(qpos), kpos=jnp.asarray(kpos),
                              **kw)
    got = tbw.blockwise_sdpa(_t(q), _t(k), _t(v), qpos=_t(qpos),
                             kpos=_t(kpos), **kw)
    _close(want, got)
    padded_sum = _t(v).sum(dim=1) / 128                    # (B, H, D)
    torch.testing.assert_close(got[:, 0], padded_sum, atol=1e-5, rtol=1e-5)
    naive = tl._sdpa(_t(q), _t(k), _t(v),
                     torch.zeros((B, 1, T), dtype=torch.bool))
    torch.testing.assert_close(naive[:, 0], _t(v).mean(dim=1), atol=1e-5,
                               rtol=1e-5)
    assert float((got - naive).abs().max()) > 1e-2


def test_tile_schedule_and_costs_are_copies():
    for S, T in ((1, 32768), (4096, 4096), (1536, 1536), (1500, 1500)):
        assert tbw.tile_schedule(S, T) == jbw.tile_schedule(S, T)
        assert tbw.analytic_costs(4, S, T, 25, 64, 5) == jbw.analytic_costs(
            4, S, T, 25, 64, 5)
    assert tbw.BLOCKWISE_THRESHOLD == jbw.BLOCKWISE_THRESHOLD


# ------------------------------------------------- model-level blockwise
@pytest.fixture
def blockwise_everywhere(monkeypatch):
    """Every attention of both packages takes its blockwise branch."""
    for mod in (jl, jmla, tl, tmla):
        monkeypatch.setattr(mod, "should_use_blockwise", lambda *a: True)


def _attn_case(arch, **kw):
    jcfg, tcfg, params, model = _pair(arch, **kw)
    p = jax.tree.map(lambda t: jnp.asarray(t[0]), params["seg0"]["attn"])
    return jcfg, tcfg, p, model.layers[0].attn


@pytest.mark.parametrize("kind,window", [("causal", None), ("causal", 8),
                                         ("bidir", None)])
def test_blockwise_attention_matches_jax(blockwise_everywhere, kind, window):
    """Full-sequence ``attention`` (qwen3-8b reduced, 40 tokens past the
    8-token window), both packages blockwise."""
    jcfg, tcfg, p, tp = _attn_case("qwen3-8b")
    S = 40
    x = np.random.default_rng(4).normal(size=(2, S, jcfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S)).astype(np.int32)
    oj, kvj = jl.attention(jnp.asarray(x), p, jcfg, positions=jnp.asarray(pos),
                           kind=kind, window=window)
    ot, kvt = tl.attention(_t(x), tp, tcfg, positions=_t(pos), kind=kind,
                           window=window)
    _close(oj, ot)
    _close(kvj["k"], kvt["k"])


def test_blockwise_mla_prefill_matches_jax(blockwise_everywhere):
    jcfg, tcfg, p, tp = _attn_case("minicpm3-4b")
    S = 24
    x = np.random.default_rng(5).normal(size=(2, S, jcfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S)).astype(np.int32)
    oj, cj = jmla.mla_attention(jnp.asarray(x), p, jcfg,
                                positions=jnp.asarray(pos))
    ot, ct = tmla.mla_attention(_t(x), tp, tcfg, positions=_t(pos))
    _close(oj, ot)
    _close(cj["c_kv"], ct["c_kv"])


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_blockwise_decode_matches_jax(blockwise_everywhere, kv_dtype):
    """qwen2-vl-2b reduced decodes 12 tokens over a full-length cache,
    both packages blockwise at every step (int8: over the quantized
    cache, dequantized per chunk)."""
    jcfg, tcfg, params, model = _pair("qwen2-vl-2b", kv_cache_dtype=kv_dtype)
    toks = np.random.default_rng(6).integers(1, jcfg.vocab, 12)
    cj = JT.init_cache(jcfg, 1, 16)
    ct = model.init_cache(1, 16)
    assert (ct[0]["k"].dtype == torch.int8) == (kv_dtype == "int8")
    for i, tok in enumerate(toks):
        lj, cj = JT.decode_step(params, jcfg, jnp.asarray([tok], jnp.int32),
                                cj, jnp.int32(i))
        lt, ct = model.decode_step(torch.tensor([int(tok)]), ct, i)
        _close(lj, lt)


# ------------------------------------------------------------------ M-RoPE
def test_mrope_angles_match_jax_and_reduce_to_rope():
    """Distinct (t, h, w) rows against JAX (1e-6: cos/sin of fp32 angles);
    three equal rows give RoPE's cos/sin bit for bit."""
    rng = np.random.default_rng(7)
    pos3 = rng.integers(0, 64, (3, 2, 16)).astype(np.int32)
    cj, sj = jl.mrope_angles(jnp.asarray(pos3), 64, 1e6, (8, 12, 12))
    ct, st = tl.mrope_angles(_t(pos3), 64, 1e6, (8, 12, 12))
    _close(cj, ct, 1e-6)
    _close(sj, st, 1e-6)
    pos = _t(pos3[0])
    c1, s1 = tl.rope_angles(pos, 64, 1e6)
    c3, s3 = tl.mrope_angles(pos.expand(3, 2, 16), 64, 1e6, (8, 12, 12))
    assert torch.equal(c1, c3) and torch.equal(s1, s3)
    with pytest.raises(ValueError, match="sum to 32"):
        tl.mrope_angles(pos.expand(3, 2, 16), 64, 1e6, (8, 12, 8))


def test_qwen2_vl_forward_with_mrope_positions_matches_jax():
    """A 4x4 patch grid after 4 text tokens: (t, h, w) rows that differ.
    The forward matches JAX; equal rows equal the tokens forward bit for
    bit (M-RoPE is RoPE for text)."""
    jcfg, tcfg, params, model = _pair("qwen2-vl-2b")
    B, S = 2, 20
    toks = np.random.default_rng(8).integers(1, jcfg.vocab, (B, S)).astype(
        np.int32)
    text = np.arange(4)
    grid = np.arange(16)
    t_row = np.concatenate([text, np.full(16, 4)])
    h_row = np.concatenate([text, 4 + grid // 4])
    w_row = np.concatenate([text, 4 + grid % 4])
    pos3 = np.broadcast_to(np.stack([t_row, h_row, w_row])[:, None],
                           (3, B, S)).astype(np.int32)
    lj, _ = JT.forward(params, jcfg, tokens=jnp.asarray(toks),
                       mrope_positions=jnp.asarray(pos3))
    tt = torch.from_numpy(toks).long()
    lt, _ = model(tt, mrope_positions=_t(pos3))
    _close(lj, lt)
    plain, _ = model(tt)
    same = torch.arange(S).expand(3, B, S)
    assert torch.equal(model(tt, mrope_positions=same)[0], plain)
    assert not torch.equal(lt, plain)


# -------------------------------------------------------------------- int8
def test_quantize_kv_bit_for_bit():
    """Values and scales equal JAX's; a row whose amax is 127 (scale 1)
    pins round-half-to-even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -63.5 -> -64."""
    rng = np.random.default_rng(9)
    t = rng.normal(size=(2, 5, 3, 8)).astype(np.float32) * 3
    t[0, 0, 0] = [127, 0.5, 1.5, 2.5, -63.5, 0, -127, 3.5]
    t[1, 1, 1] = 0.0                                         # amax 0
    wj, sj = jl._quantize_kv(jnp.asarray(t))
    wt, st = tl._quantize_kv(_t(t))
    assert wt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(wt.numpy(), np.asarray(wj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    assert wt[0, 0, 0].tolist() == [127, 0, 2, 2, -64, 0, -127, 4]


def test_int8_decode_matches_jax_and_reference_bounds(monkeypatch):
    """qwen2-vl-2b reduced, 16 decode steps over an int8 cache: logits
    match JAX's int8 decode; every stored value, dequantized, lies within
    scale / 2 of the fp32 K/V it stores (recorded as ``_quantize_kv``
    receives it; plus 1e-4 scale for the fp32 rounding of value x scale);
    against the model-dtype cache, the reference's bounds
    (``tests/test_models.py::test_int8_kv_cache_decode_accuracy``):
    relative logit error < 0.05 and >= 14 argmax agreements."""
    jcfg8, cfg8, params, m8 = _pair("qwen2-vl-2b", kv_cache_dtype="int8")
    cfg = dataclasses.replace(cfg8, kv_cache_dtype="model")
    m16 = params_from_reference(jax.tree.map(np.asarray, params), cfg)
    toks = np.random.default_rng(10).integers(1, cfg.vocab, 16)
    c8, c16 = m8.init_cache(1, 32), m16.init_cache(1, 32)
    cj = JT.init_cache(jcfg8, 1, 32)
    assert c8[0]["k"].dtype == torch.int8 and "k_scale" in c8[0]
    stored = []
    real = tl._quantize_kv
    monkeypatch.setattr(tl, "_quantize_kv",
                        lambda t: stored.append(t.clone()) or real(t))
    agree = 0
    for i, tok in enumerate(toks):
        tt = torch.tensor([int(tok)])
        l16, c16 = m16.decode_step(tt, c16, i)
        l8, c8 = m8.decode_step(tt, c8, i)
        lj, cj = _jdecode(params, jcfg8, jnp.asarray([tok], jnp.int32), cj,
                          jnp.int32(i))
        _close(lj, l8)
        agree += int(l16[0].argmax() == l8[0].argmax())
    rel = float((l16 - l8).abs().max() / (l16.abs().max() + 1e-9))
    assert rel < 0.05, rel
    assert agree >= 14, agree
    L = cfg.n_layers
    assert len(stored) == 16 * L * 2
    for i in range(16):
        for layer in range(L):
            for j, name in enumerate(("k", "v")):
                want = stored[(i * L + layer) * 2 + j][:, 0]
                scale = c8[layer][f"{name}_scale"][:, i, :, None]
                got = c8[layer][name][:, i].float() * scale
                assert bool(((got - want).abs()
                             <= scale * (0.5 + 1e-4)).all())


def test_int8_config_prefill_cache_stays_in_model_dtype():
    """As in JAX, the cache tensor's dtype picks the int8 path, so a cache
    built by the prefill stays in the model dtype under
    ``kv_cache_dtype="int8"`` and decodes unquantized (ROADMAP.md §3)."""
    jcfg, tcfg, params, model = _pair("qwen2-vl-2b", kv_cache_dtype="int8")
    toks = np.random.default_rng(11).integers(1, jcfg.vocab, (1, 8)).astype(
        np.int32)
    _, _, cj = JT.forward(params, jcfg, tokens=jnp.asarray(toks),
                          build_cache_len=12)
    _, _, ct = model(torch.from_numpy(toks).long(), build_cache_len=12)
    assert np.asarray(cj["seg0"]["k"]).dtype == np.float32
    assert ct[0]["k"].dtype == torch.float32 and "k_scale" not in ct[0]
    lj, _ = _jdecode(params, jcfg, jnp.asarray([3], jnp.int32), cj,
                     jnp.int32(8))
    lt, _ = model.decode_step(torch.tensor([3]), ct, 8)
    _close(lj, lt)
