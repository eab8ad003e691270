"""End-to-end training driver.

CPU-scale example (reduced config, real pipeline)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
      --reduced --device cpu --steps 50 --batch 8 --seq 64 \
      --ckpt-dir runs/train_gemma

Without ``--reduced`` it trains the arch at full width and depth in its
config's dtype (gemma-2b: bf16, 2,506,172,416 parameters, ~30 GB of
weights, gradients and fp32 AdamW state), which needs the card;
``--device`` defaults to ``cuda``.  ``--mesh single|multi`` (256 or 512
ranks with a "model" axis) needs the sharded train step of ROADMAP item
12's next slice and exits; ``--grad-compression`` needs a pod axis, so
it fails without a multi-pod mesh, as the reference's assertion does.
``main(argv)`` returns the trainer's history.
"""
from __future__ import annotations

import argparse

from ..data.pipeline import PackedBatches, StreamingIngest, synthetic_documents
from ..models import registry
from ..models.transformer import param_count
from ..optim import adamw
from ..optim.schedules import cosine_with_warmup
from ..train.trainer import Trainer


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", choices=["none", "single", "multi"], default="none")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (plain versions)")
    args = ap.parse_args(argv)

    if args.mesh != "none":
        raise SystemExit(
            f"--mesh {args.mesh} needs {512 if args.mesh == 'multi' else 256} "
            "ranks and the sharded train step over a 'model' axis "
            "(distributed/sharding.py), which comes with ROADMAP item 12's "
            "next slice")
    if args.grad_compression:
        ap.error("--grad-compression needs a mesh with a 'pod' axis")
    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.encoder_only:
        raise SystemExit("use a decoder arch for the LM training example")

    ingest = StreamingIngest()
    for doc in synthetic_documents(512, args.seq + 8, cfg.vocab):
        ingest.ingest(doc)
    print(f"ingested {len(ingest)} docs (NB-tree indexed, {ingest.dups} dups dropped)")
    batches = PackedBatches(ingest, args.batch, args.seq)

    opt_cfg = adamw.AdamWConfig(
        lr=cosine_with_warmup(args.lr, args.steps // 10 + 1, args.steps))
    tr = Trainer(cfg, device=args.device, opt_cfg=opt_cfg,
                 ckpt_dir=args.ckpt_dir, num_microbatches=args.microbatches)
    print(f"{cfg.name}: {param_count(tr.model):,} parameters ({cfg.dtype}, "
          f"remat {cfg.remat}) on {tr.device}")
    hist = tr.run(batches, args.steps, ckpt_every=args.ckpt_every)
    print(f"final loss {hist[-1]['loss']:.4f} "
          f"(first {hist[0]['loss']:.4f}) over {len(hist)} steps")
    return hist


if __name__ == "__main__":
    main()
