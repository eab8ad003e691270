"""Closed-loop workload driver for the ``torch-nbtree`` engine.

``run_workload(engine, workload)`` applies the preload, then the mixed
stream batch by batch, calling ``engine.maintain(budget)`` between batches
(the serving loop's deamortization knob), and records per-op latencies
into per-kind log-bucket histograms: the closed loop of
``repro/workloads/driver.py::run_workload``, with the same report shape.

CLI (runs on the card; ``--device cpu`` runs the plain versions)::

    PYTHONPATH=src python -m repro_torch.workloads.driver \
        --mix insert-heavy --ops 65536 --out runs/x.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from ..core.engine_api import OpKind, StorageEngine, make_engine
from ..obs.metrics import LogBucketHistogram
from .generator import MIXES, Workload, make_workload

#: the JAX package's closed-loop report layout (its schema version 8).
SCHEMA_VERSION = 8

#: engine configuration of the CLI: the deployment shape (f=4, sigma=4096).
ENGINE_CONFIG = dict(f=4, sigma=4096)


class LatencyHistogram:
    """Per-kind latency histogram of a driver report (a façade over
    :class:`LogBucketHistogram`: count, mean and p100 exact, p50/p99
    interpolated within a bucket)."""

    def __init__(self):
        self._h = LogBucketHistogram()

    @property
    def count(self) -> int:
        return self._h.count

    def add(self, latencies_s) -> None:
        self._h.add_many(np.asarray(latencies_s, np.float64))

    def to_dict(self) -> dict:
        s = self._h.summary()
        del s["p999_s"]         # per-kind blocks carry no p99.9
        return s


def run_workload(engine: StorageEngine, workload: Workload, *,
                 maintain_budget: int = 1) -> dict:
    """Drive ``workload`` through ``engine``; returns the JSON-ready report."""
    spec = workload.spec
    hists = {k: LatencyHistogram() for k in OpKind}

    pre = workload.preload_batch()
    engine.apply(pre)
    engine.drain()
    io_after_preload = engine.io_time_s()

    max_debt = 0
    for batch in workload.batches():
        res = engine.apply(batch)
        for k in OpKind:
            hists[k].add(res.latencies(k))
        max_debt = max(max_debt, engine.maintain(maintain_budget))
    debt_before_drain = engine.maintain(0)
    engine.drain()

    stats = engine.stats()
    return {
        "schema_version": SCHEMA_VERSION,
        "engine": engine.name,
        "workload": dataclasses.asdict(spec) | {
            "mix": {OpKind(k).name.lower(): p for k, p in spec.mix.items()}},
        "maintain_budget": maintain_budget,
        "preload_pairs": len(pre),
        "io_time_preload_s": io_after_preload,
        "max_pending_debt": int(max_debt),
        "pending_debt_before_drain": int(debt_before_drain),
        "per_kind": {OpKind(k).name.lower(): h.to_dict()
                     for k, h in hists.items() if h.count},
        "stats": dataclasses.asdict(stats),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mix", choices=sorted(MIXES), default="insert-heavy")
    ap.add_argument("--ops", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--preload", type=int, default=4096)
    ap.add_argument("--key-space", type=int, default=1 << 26)
    ap.add_argument("--dist", choices=("uniform", "zipfian", "hotspot"),
                    default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="workload stream seed (same seed -> same op stream)")
    ap.add_argument("--maintain-budget", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default="runs/torch_driver_report.json",
                    help="write the JSON report here")
    args = ap.parse_args(argv)

    overrides = dict(n_ops=args.ops, batch_size=args.batch,
                     preload=args.preload, key_space=args.key_space,
                     seed=args.seed)
    if args.dist:
        overrides["dist"] = args.dist
    engine = make_engine("torch-nbtree", device=args.device, **ENGINE_CONFIG)
    report = run_workload(engine, make_workload(args.mix, **overrides),
                          maintain_budget=args.maintain_budget)
    report["device"] = str(engine.idx.device)
    pk = report["per_kind"]
    line = " ".join(
        f"{kind}[p50={h['p50_s']*1e3:.3f}ms p99={h['p99_s']*1e3:.3f}ms "
        f"p100={h['p100_s']*1e3:.3f}ms]" for kind, h in pk.items())
    print(f"{engine.name} ({report['device']}) {args.mix}: {line} "
          f"pairs={report['stats']['total_pairs']}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
