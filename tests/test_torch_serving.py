"""The port's serving bridge vs the JAX package's, on the CPU.

Reduced qwen3-8b in fp32: the JAX params, carried across by
``params_from_reference``, give the port's ``Transformer`` the same
weights, so forward, prefill cache and decode logits must agree to 1e-4.
The paged KV cache runs one call sequence on both packages: page ids,
free lists, block tables and page contents must be equal.  The engines
must emit the same greedy tokens as JAX's engine and as the contiguous
decode.  Each JAX side is computed once per module.
"""
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jregistry
from repro.models import transformer as JT
from repro.serve import kv_cache as jkv
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import registry
from repro_torch.models.convert import params_from_reference
from repro_torch.models.layers import BLOCKWISE_THRESHOLD, attention
from repro_torch.models.transformer import Transformer, init_params
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.steps import make_prefill_step, make_serve_step

ROOT = Path(__file__).resolve().parents[1]
PROMPT = list(range(1, 9))
N_NEW = 5


def _reduced(reg):
    return dataclasses.replace(reg.get_config("qwen3-8b").reduced(),
                               dtype="float32", remat="none")


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _reduced(jregistry), _reduced(registry)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    params = JT.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_reference(jax.tree.map(np.asarray, params), tcfg)
    return SimpleNamespace(jcfg=jcfg, cfg=tcfg, params=params, model=model)


def _close(jax_x, torch_x, tol=1e-4):
    np.testing.assert_allclose(torch_x.numpy(), np.asarray(jax_x),
                               atol=tol, rtol=tol)


# ------------------------------------------------------------------ models
def test_configs_are_copies():
    from repro.configs import qwen3_8b as jq
    from repro_torch.configs import qwen3_8b as tq
    assert dataclasses.asdict(jq.CONFIG) == dataclasses.asdict(tq.CONFIG)


def test_forward_and_prefill_cache_match_jax(models):
    toks = np.random.default_rng(1).integers(1, 512, (2, 12)).astype(np.int32)
    lj, _, cj = JT.forward(models.params, models.jcfg, tokens=jnp.asarray(toks),
                           build_cache_len=16)
    lt, ct = make_prefill_step(models.cfg, 16)(
        models.model, {"tokens": torch.from_numpy(toks).long()})
    _close(lj[:, -1:], lt)
    _close(lj, models.model(torch.from_numpy(toks).long()))
    assert len(ct) == models.cfg.n_layers
    for li, c in enumerate(ct):
        for name in ("k", "v", "pos"):
            _close(cj["seg0"][name][li], c[name])


def test_decode_steps_match_jax(models):
    rng = np.random.default_rng(2)
    toks = rng.integers(1, 512, (2, 6)).astype(np.int32)
    _, _, cj = JT.forward(models.params, models.jcfg, tokens=jnp.asarray(toks),
                          build_cache_len=10)
    _, ct = models.model(torch.from_numpy(toks).long(), build_cache_len=10)
    step = make_serve_step(models.cfg)
    tok = toks[:, -1]
    for s in range(4):
        lj, cj = JT.decode_step(models.params, models.jcfg, jnp.asarray(tok),
                                cj, jnp.int32(6 + s))
        lt, ct = models.model.decode_step(torch.from_numpy(tok).long(), ct,
                                          6 + s)
        assert lt.dtype == torch.float32
        _close(lj, lt)
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        nxt, _ = step(models.model, [{k: v.clone() for k, v in c.items()}
                                     for c in ct],
                      torch.from_numpy(tok).long(), 7 + s)
        assert nxt.dtype == torch.int32 and nxt.shape == (2,)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_layer_functions_match_jax(kind):
    """The MLP kinds, both norms and the windowed causal mask, which the
    qwen3 stack alone does not reach."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    w = {n: (rng.normal(size=shape) / 4).astype(np.float32)
         for n, shape in (("wi", (16, 32)), ("wg", (16, 32)), ("wo", (32, 16)),
                          ("scale", (16,)), ("bias", (16,)))}
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    tp = SimpleNamespace(**{k: torch.from_numpy(v) for k, v in w.items()})
    tx = torch.from_numpy(x)
    _close(jl.mlp(jnp.asarray(x), jp, kind), tl.mlp(tx, tp, kind), 1e-5)
    for norm in ("rms", "layer"):
        _close(jl.apply_norm(jnp.asarray(x), jp, norm, 1e-5),
               tl.apply_norm(tx, tp, norm, 1e-5), 1e-5)
    assert np.array_equal(np.asarray(jl.causal_mask(5, 7, window=2, offset=3)),
                          tl.causal_mask(5, 7, window=2, offset=3).numpy())


def test_init_params_is_seeded():
    cfg = _reduced(registry)
    a, b = init_params(cfg, seed=3, device="cpu"), init_params(cfg, seed=3,
                                                                device="cpu")
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name
    w = a.layers[0].mlp.wo
    assert abs(float(w.std()) * cfg.d_ff ** 0.5 - 1) < 0.05   # 1/sqrt(fan_in)
    assert torch.equal(a.layers[0].norm1.scale, torch.ones(cfg.d_model))


def test_unported_parts_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        registry.get_config("mixtral-8x22b")
    with pytest.raises(KeyError):
        registry.get_config("no-such-arch")
    moe = dataclasses.replace(_reduced(registry), segments=(("moe", 2),))
    with pytest.raises(NotImplementedError, match="moe"):
        Transformer(moe, device="cpu")
    cfg = _reduced(registry)
    model = init_params(cfg, device="cpu")
    S = int((BLOCKWISE_THRESHOLD / cfg.n_heads) ** 0.5) + 1   # B*S*S*H above
    x = torch.zeros((1, S, cfg.d_model))
    with pytest.raises(NotImplementedError, match="blockwise"):
        attention(x, model.layers[0].attn, cfg,
                  positions=torch.arange(S)[None])


# ---------------------------------------------------------------- kv cache
def test_pack_key_matches_jax():
    seq = np.asarray([0, 5, 1000, 2**18 - 1])
    blk = np.asarray([0, 7, 123, 2**14 - 2])
    a, b = jkv.pack_key(seq, blk), tkv.pack_key(seq, blk)
    assert a.dtype == b.dtype == np.uint32 and np.array_equal(a, b)


L, KVH, D, NP, PS = 1, 2, 8, 16, 4


def _kv(B, base):
    """(B, KVH, D) values that differ in every (b, h, d): a transposed
    write cannot match."""
    return base + np.arange(B * KVH * D, dtype=np.float32).reshape(B, KVH, D)


def _cache_script(c, to_kv, to_np):
    """One call sequence; returns a snapshot after each step."""
    snaps = {}
    c.add_sequence(0)
    c.extend(0, 6)                          # 2 pages
    c.add_sequence(1)
    c.extend(1, 3)                          # 1 page
    snaps["alloc"] = (list(c.free), to_np(c.block_tables([0, 1], 2)))
    k2 = _kv(2, 100)                        # B == KVH
    c.write_token(0, [0, 1], [5, 2], to_kv(k2), to_kv(-k2))
    k1 = _kv(1, 1000)                       # B != KVH
    c.write_token(0, [0], [1], to_kv(k1), to_kv(-k1))
    kp, vp = c.layer_pages(0)
    snaps["pages"] = (to_np(kp), to_np(vp))
    c.free_sequence(0)
    c.maintain(8)
    c.add_sequence(2)
    c.extend(2, 9)                          # 3 pages, freed ones reused
    snaps["reuse"] = (list(c.free), to_np(c.block_tables([1, 2], 3)))
    c.free_sequence(1)
    c.free_sequence(2)
    snaps["freed"] = (list(c.free), None)
    return snaps


@pytest.fixture(scope="module")
def cache_runs():
    with jax.disable_jit():
        j = _cache_script(jkv.PagedKVCache(L, KVH, D, n_pages=NP, page_size=PS,
                                           dtype=jnp.float32),
                          jnp.asarray, np.asarray)
    t = _cache_script(tkv.PagedKVCache(L, KVH, D, n_pages=NP, page_size=PS,
                                       dtype=torch.float32, device="cpu"),
                      torch.from_numpy, lambda x: x.numpy())
    return j, t


@pytest.mark.parametrize("step", ["alloc", "reuse", "freed"])
def test_kv_cache_pages_and_tables_match_jax(cache_runs, step):
    (jfree, jt), (tfree, tt) = cache_runs[0][step], cache_runs[1][step]
    assert jfree == tfree
    if jt is not None:
        assert tt.dtype == np.int32 and np.array_equal(jt, tt)
    if step == "freed":
        assert len(tfree) == NP - 1


@pytest.mark.parametrize("which", ["k", "v"])
def test_kv_cache_write_token_matches_jax(cache_runs, which):
    """Written contents equal JAX's, with B == KVH and with B != KVH."""
    i = "kv".index(which)
    j, t = cache_runs[0]["pages"][i], cache_runs[1]["pages"][i]
    assert np.array_equal(j, t)
    sign = 1 if which == "k" else -1
    table = cache_runs[1]["alloc"][1]
    np.testing.assert_array_equal(t[:, table[0, 1], 1], sign * _kv(2, 100)[0])
    np.testing.assert_array_equal(t[:, table[1, 0], 2], sign * _kv(2, 100)[1])
    np.testing.assert_array_equal(t[:, table[0, 0], 1], sign * _kv(1, 1000)[0])


def test_kv_cache_seq_lens_matches_jax():
    caches = (jkv.PagedKVCache(L, KVH, D, n_pages=NP, page_size=PS,
                               dtype=jnp.float32),
              tkv.PagedKVCache(L, KVH, D, n_pages=NP, page_size=PS,
                               dtype=torch.float32, device="cpu"))
    with jax.disable_jit():
        for c in caches:
            c.add_sequence(3)
            c.add_sequence(7, 5)
            c.extend(3, 9)
            c.add_sequence(1)
        j = np.asarray(caches[0].seq_lens([7, 3, 1, 3]))
    t = caches[1].seq_lens(np.array([7, 3, 1, 3]))
    assert t.dtype == torch.int32 and t.device.type == "cpu"
    assert j.dtype == np.int32 and np.array_equal(j, t.numpy())
    assert t.tolist() == [5, 9, 0, 9]


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def jax_engine_tokens(models):
    eng = JaxEngine(models.jcfg, models.params, max_batch=2, n_pages=128,
                    page_size=8)
    reqs = eng.run([JaxRequest(i, PROMPT, max_new_tokens=N_NEW)
                    for i in range(2)])
    assert len(eng.cache.free) == 127
    return [r.out for r in reqs]


def test_engine_matches_jax_engine_and_contiguous_decode(models,
                                                        jax_engine_tokens):
    model = models.model
    cache = model.init_cache(1, 64)
    for i, t in enumerate(PROMPT):
        lg, cache = model.decode_step(torch.tensor([t]), cache, i)
    ref = [int(lg[0].argmax())]
    for s in range(N_NEW - 1):
        lg, cache = model.decode_step(torch.tensor([ref[-1]]), cache,
                                      len(PROMPT) + s)
        ref.append(int(lg[0].argmax()))

    eng = Engine(models.cfg, model, max_batch=2, n_pages=128, page_size=8)
    out = eng.run([Request(i, PROMPT, max_new_tokens=N_NEW) for i in range(2)])
    assert [r.out for r in out] == jax_engine_tokens == [ref, ref]
    assert all(r.done for r in out)
    assert len(eng.cache.free) == 127      # all pages reclaimed (page 0 null)
    assert len(eng.step_s) == N_NEW - 1 and len(eng.prefill_s) == 1
    assert all(len(v) == N_NEW - 1 for v in eng.decoder.index_s.values())


def test_serve_cli_on_cpu(capsys):
    serve_main(["--reduced", "--device", "cpu", "--requests", "3",
                "--prompt-len", "8", "--max-new", "4", "--max-batch", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 3 requests / 12 tokens")
    assert "tok/s on the CPU" in out[0]
    assert out[1].startswith("free pages after completion: 1023")
    assert len(out) == 5


def test_import_scan_covers_serving_modules():
    """tests/test_torch_nbtree.py's AST scan walks every ``*.py`` under
    src/repro_torch: the serving bridge's modules are among them."""
    files = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in (ROOT / "src" / "repro_torch").rglob("*.py")}
    assert {"models/layers.py", "models/transformer.py", "models/convert.py",
            "models/registry.py", "configs/base.py", "configs/qwen3_8b.py",
            "kernels/paged_attention.py", "serve/kv_cache.py",
            "serve/engine.py", "serve/steps.py", "launch/serve.py"} <= files
