"""End-to-end training driver.

CPU-scale example (reduced config, real pipeline)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
      --reduced --device cpu --steps 50 --batch 8 --seq 64 \
      --ckpt-dir runs/train_gemma

Without ``--reduced`` it trains the arch at full width and depth in its
config's dtype (gemma-2b: bf16, 2,506,172,416 parameters, ~30 GB of
weights, gradients and fp32 AdamW state), which needs the card;
``--device`` defaults to ``cuda``.

``--mesh single|multi`` trains sharded (``distributed/sharding.py``) on
the production mesh, (16, 16) over ("data", "model") or (2, 16, 16) over
("pod", "data", "model"): one process a card under ``torchrun`` with 256
or 512 processes, whose environment (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) gives the process
group; in a world of another size it exits naming the rank count it
needs.  ``--batch`` must split over pod x data.  ``--grad-compression``
needs a pod axis, so it fails without a multi-pod mesh, as the
reference's assertion does.  ``main(argv)`` returns the trainer's
history.
"""
from __future__ import annotations

import argparse
import os

from ..data.pipeline import PackedBatches, StreamingIngest, synthetic_documents
from ..models import registry
from ..models.transformer import param_count
from ..optim import adamw
from ..optim.schedules import cosine_with_warmup
from ..train.trainer import Trainer
from .mesh import make_production_mesh, production_shape


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

    if args.grad_compression and args.mesh != "multi":
        ap.error("--grad-compression needs a mesh with a 'pod' axis "
                 "(--mesh multi)")
    mesh = _mesh(args) if args.mesh != "none" else None
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
    tr = Trainer(cfg, device=args.device, mesh=mesh, opt_cfg=opt_cfg,
                 ckpt_dir=args.ckpt_dir, num_microbatches=args.microbatches,
                 grad_compression=args.grad_compression)
    print(f"{cfg.name}: {param_count(tr.model):,} parameters ({cfg.dtype}, "
          f"remat {cfg.remat}) on {tr.device}")
    hist = tr.run(batches, args.steps, ckpt_every=args.ckpt_every)
    print(f"final loss {hist[-1]['loss']:.4f} "
          f"(first {hist[0]['loss']:.4f}) over {len(hist)} steps")
    return hist


def _mesh(args):
    """The production mesh over the ``torchrun`` world; exits unless the
    world has exactly its rank count and the batch splits over it."""
    shape, axes = production_shape(multi_pod=args.mesh == "multi")
    need = 1
    for n in shape:
        need *= n
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != need:
        raise SystemExit(
            f"--mesh {args.mesh} needs {need} ranks, a {shape} mesh over "
            f"{axes} (one process a card: torchrun --nproc-per-node ... "
            f"with {need} processes in all); this world has {world}")
    dp = need // shape[-1]
    if args.batch % dp:
        raise SystemExit(f"--batch {args.batch} does not split over the "
                         f"{dp} (pod x data) ranks of --mesh {args.mesh}")
    import torch
    import torch.distributed as dist

    on_cpu = args.device == "cpu"
    if not on_cpu:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("gloo" if on_cpu else "nccl")
    return make_production_mesh(multi_pod=args.mesh == "multi",
                                device_type="cpu" if on_cpu else "cuda")


if __name__ == "__main__":
    main()
