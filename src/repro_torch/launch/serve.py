"""Serving CLI: continuous batching over the NB-tree paged KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --reduced --device cpu --requests 8 --prompt-len 16 --max-new 12

Without ``--reduced`` it serves the arch at full width in its config's
dtype (qwen3-8b: bf16, ~16.4 GB of weights), which needs the card.  The
paged engine serves dense and swa stacks (qwen3-8b, gemma-2b,
starcoder2-3b, qwen2-vl-2b: its text positions make M-RoPE plain RoPE);
for any other arch (MoE, MLA, recurrent, hybrid, encoder) the CLI exits
with the JAX one's message.
``--device`` defaults to ``cuda``.  Weights are random, drawn from seed 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import registry
from ..models.transformer import init_params
from ..serve.engine import PAGED_KINDS, Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32", remat="none")
    if any(k not in PAGED_KINDS for k, _ in cfg.segments):
        raise SystemExit("paged-KV engine serves attention backbones; "
                         "pick a dense/swa arch (qwen3-8b, gemma-2b, ...)")
    model = init_params(cfg, seed=0, device=dev)
    eng = Engine(cfg, model, max_batch=args.max_batch, n_pages=1024,
                 page_size=8)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(1, cfg.vocab, args.prompt_len).tolist(),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        where = f"on {torch.cuda.get_device_name(dev)}"
    else:
        where = "on the CPU (plain versions; no device metric)"
    t0 = time.perf_counter()
    eng.run(reqs)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in reqs)
    print(f"served {len(reqs)} requests / {tokens} tokens in {dt:.3f} s "
          f"({tokens / dt:.1f} tok/s {where})")
    print(f"free pages after completion: {len(eng.cache.free)} "
          f"(index height {eng.cache.index.height})")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.out}")


if __name__ == "__main__":
    main()
