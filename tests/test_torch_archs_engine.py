"""The paged engine and the serving CLI on the new archs, on the CPU.

The paged engine serves dense and ``swa`` stacks, as the JAX engine does:
on a reduced ``swa`` stack its greedy tokens must equal the JAX engine's
(both decode over every page with no window, so past the window they
differ from the windowed contiguous decode: the gap is measured), and on
reduced qwen2-vl-2b (dense, M-RoPE over text positions) too.  MoE, MLA,
recurrent, hybrid and encoder stacks are refused with the reference's
reasons.  The JAX engine's
page index compiles each new query shape, which takes most of this file's
time.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import registry as jregistry
from repro.models import transformer as JT
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import registry
from repro_torch.models.convert import params_from_reference
from repro_torch.serve.engine import Engine, PagedDecoder, Request


def _pair(arch, **kw):
    """(JAX cfg, port cfg, JAX params, port model): reduced, fp32, with the
    same weights."""
    jcfg, tcfg = (dataclasses.replace(reg.get_config(arch).reduced(),
                                      dtype="float32", remat="none", **kw)
                  for reg in (jregistry, registry))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    params = JT.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_reference(jax.tree.map(np.asarray, params), tcfg)
    return jcfg, tcfg, params, model


def test_swa_paged_engine_matches_jax_engine():
    """qwen3-8b reduced to an swa stack (window 16), prompts of 24 tokens
    (past the window, within window + 128), 8 new tokens: the port's
    engine gives the JAX engine's tokens.  Both decode over every page
    with no window, so past the window they differ from the windowed
    contiguous decode; the gap is measured here (ROADMAP.md §3)."""
    jcfg, tcfg, params, model = _pair("qwen3-8b", segments=(("swa", 2),))
    assert tcfg.swa_window == 16
    prompt = np.random.default_rng(7).integers(1, 512, 24).tolist()
    n_new = 8
    jeng = JaxEngine(jcfg, params, max_batch=2, n_pages=64, page_size=8)
    want = [r.out for r in jeng.run([JaxRequest(i, prompt, max_new_tokens=n_new)
                                     for i in range(2)])]
    eng = Engine(tcfg, model, max_batch=2, n_pages=64, page_size=8)
    got = eng.run([Request(i, prompt, max_new_tokens=n_new) for i in range(2)])
    assert [r.out for r in got] == want
    assert len(eng.cache.free) == 63

    # the windowed contiguous decode of the same tokens
    cache = model.init_cache(1, 64)
    seq = prompt + want[0][:-1]
    for i, t in enumerate(seq):
        logits, cache = model.decode_step(torch.tensor([t]), cache, i)
    gap = float((eng.decoder.last_logits[0] - logits[0]).abs().max())
    print(f"paged (no window) vs windowed contiguous decode, last step: "
          f"max abs logit gap {gap:.4g}")
    assert gap > 1e-2, "past the window the two decodes must differ"


def test_mrope_paged_engine_matches_jax_engine_and_contiguous_decode():
    """qwen2-vl-2b reduced, 2 requests of 12-token prompts, 6 new tokens:
    the port's engine (plain RoPE in its decode, M-RoPE with three equal
    rows in its prefill, as the JAX engine) gives the JAX engine's tokens
    and the contiguous decode's (M-RoPE throughout)."""
    jcfg, tcfg, params, model = _pair("qwen2-vl-2b")
    assert tcfg.mrope_sections is not None
    prompt = np.random.default_rng(8).integers(1, 512, 12).tolist()
    n_new = 6
    jeng = JaxEngine(jcfg, params, max_batch=2, n_pages=64, page_size=8)
    want = [r.out for r in jeng.run([JaxRequest(i, prompt, max_new_tokens=n_new)
                                     for i in range(2)])]
    eng = Engine(tcfg, model, max_batch=2, n_pages=64, page_size=8)
    got = eng.run([Request(i, prompt, max_new_tokens=n_new) for i in range(2)])
    assert [r.out for r in got] == want
    cache = model.init_cache(1, 32)
    for i, t in enumerate(prompt + want[0][:-1]):
        logits, cache = model.decode_step(torch.tensor([t]), cache, i)
        if i >= len(prompt) - 1:
            assert int(logits.argmax()) == want[0][i - len(prompt) + 1]
    torch.testing.assert_close(eng.decoder.last_logits[0], logits[0],
                               atol=1e-4, rtol=1e-4)


def test_paged_decoder_refuses_what_the_reference_refuses():
    cfg, _, _, model = _pair("deepseek-moe-16b")
    with pytest.raises(ValueError, match="attention backbones"):
        Engine(cfg, model)
    _, cfg, _, model = _pair("qwen3-8b", segments=(("swa", 2),))
    eng = Engine(cfg, model, max_batch=1, n_pages=64, page_size=8)
    assert isinstance(eng.decoder, PagedDecoder)
    long = [1] * (cfg.swa_window + 129)
    with pytest.raises(ValueError, match="prefill ring"):
        eng.run([Request(0, long, max_new_tokens=2)])


# ---------------------------------------------------------------------- CLI
def test_serve_cli_serves_gemma_on_cpu(capsys):
    serve_main(["--arch", "gemma-2b", "--reduced", "--device", "cpu",
                "--requests", "2", "--prompt-len", "8", "--max-new", "3",
                "--max-batch", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 2 requests / 6 tokens")
    assert out[1].startswith("free pages after completion: 1023")


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "xlstm-1.3b",
                                  "hymba-1.5b", "hubert-xlarge"])
def test_serve_cli_refuses_moe_with_the_reference_message(arch):
    """MoE, recurrent, hybrid and encoder stacks: the reference's exit."""
    with pytest.raises(SystemExit, match="paged-KV engine serves attention "
                                         "backbones; pick a dense/swa arch"):
        serve_main(["--arch", arch, "--reduced", "--device", "cpu"])


def test_serve_cli_serves_qwen2_vl_on_cpu(capsys):
    serve_main(["--arch", "qwen2-vl-2b", "--reduced", "--device", "cpu",
                "--requests", "2", "--prompt-len", "8", "--max-new", "3",
                "--max-batch", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 2 requests / 6 tokens")
    assert out[1].startswith("free pages after completion: 1023")
