"""Workload driver for the ``torch-nbtree`` engine, closed or open loop.

``run_workload(engine, workload)`` applies the preload, then the mixed
stream batch by batch, calling ``engine.maintain(budget)`` between batches
(the serving loop's deamortization knob), and records per-op latencies
into per-kind log-bucket histograms: the closed loop of
``repro/workloads/driver.py::run_workload``, with the same report shape.
``run_open_workload`` is its open-loop counterpart (DESIGN.md §7):
timestamped arrivals through the ingest frontend's bounded queue and group
commit; end-to-end latency = queueing + service, on the frontend's clock
(a virtual per-op service on this wall-clock engine).

CLI (runs on the card; ``--device cpu`` runs the plain versions)::

    PYTHONPATH=src python -m repro_torch.workloads.driver \
        --mix insert-heavy --ops 65536 --out runs/x.json
    PYTHONPATH=src python -m repro_torch.workloads.driver \
        --mix insert-heavy --arrival poisson --rate 20000 --ops 65536 \
        --trace runs/trace.json --out runs/ol.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from ..core.engine_api import OpKind, StorageEngine, make_engine
from ..obs.metrics import LogBucketHistogram, ObsConfig
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


def run_open_workload(engine: StorageEngine, workload: Workload, *,
                      arrival: str, rate: float,
                      duration_s: float | None = None,
                      maintain_budget: int = 1,
                      frontend_config=None,
                      obs: ObsConfig | None = None,
                      chaos_spec: str | None = None) -> dict:
    """Open-loop counterpart of :func:`run_workload`.

    Timestamps ``workload``'s op stream with the named arrival process and
    serves it through the ingest frontend; the report carries the SLO
    section under ``"open_loop"``.  ``maintain_budget`` shapes the default
    frontend config; an explicit ``frontend_config`` wins.  ``obs`` adds a
    windowed timeline, stall attribution and a span trace; ``chaos_spec``
    schedules faults against the frontend's own log (target ``"wal"``).
    """
    from ..ingest import (FrontendConfig, make_arrivals, make_trace,
                          run_open_loop)
    from ..wal import FaultSchedule

    if frontend_config is None:
        frontend_config = FrontendConfig(maintain_budget=maintain_budget)
    trace = make_trace(workload, make_arrivals(arrival, rate),
                       duration_s=duration_s)
    chaos = FaultSchedule.parse(chaos_spec) if chaos_spec else None
    report = run_open_loop(engine, trace, config=frontend_config, obs=obs,
                           chaos=chaos)
    report["schema_version"] = SCHEMA_VERSION
    report["workload"] = dataclasses.asdict(workload.spec) | {
        "mix": {OpKind(k).name.lower(): p
                for k, p in workload.spec.mix.items()}}
    return report


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
    ap.add_argument("--arrival", choices=("poisson", "mmpp", "diurnal"),
                    default=None,
                    help="open-loop mode: serve through the ingest frontend "
                         "with this arrival process")
    ap.add_argument("--rate", type=float, default=10_000.0,
                    help="open-loop offered rate, ops/second (poisson/"
                         "diurnal mean; mmpp burst rate)")
    ap.add_argument("--duration", type=float, default=None,
                    help="open-loop trace window in seconds (default: the "
                         "full --ops stream)")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="open-loop fault schedule: ';'-joined "
                         "kind@t[:target[:arg[:dur]]] events, kinds crash|"
                         "fsync_stall|latency_spike|torn_segment|bit_flip, "
                         "default target 'wal' (the frontend)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="open-loop mode: save a Chrome trace_event JSON of "
                         "the frontend's and the engine's spans here")
    ap.add_argument("--metrics-window", type=float, default=None,
                    metavar="SECONDS",
                    help="open-loop mode: windowed-metrics timeline width on "
                         "the frontend's clock (enables the report's 'obs' "
                         "section; 1.0 when only --trace is set)")
    ap.add_argument("--out", default="runs/torch_driver_report.json",
                    help="write the JSON report here")
    args = ap.parse_args(argv)
    if not args.arrival and (args.chaos or args.trace
                             or args.metrics_window is not None):
        ap.error("--chaos/--trace/--metrics-window need open-loop mode "
                 "(--arrival)")

    overrides = dict(n_ops=args.ops, batch_size=args.batch,
                     preload=args.preload, key_space=args.key_space,
                     seed=args.seed)
    if args.dist:
        overrides["dist"] = args.dist
    engine = make_engine("torch-nbtree", device=args.device, **ENGINE_CONFIG)
    workload = make_workload(args.mix, **overrides)
    device = str(engine.idx.device)
    if args.arrival:
        obs = None
        if args.trace or args.metrics_window is not None:
            obs = ObsConfig(window_s=args.metrics_window or 1.0,
                            trace_path=args.trace)
        report = run_open_workload(engine, workload, arrival=args.arrival,
                                   rate=args.rate, duration_s=args.duration,
                                   maintain_budget=args.maintain_budget,
                                   obs=obs, chaos_spec=args.chaos)
        report["device"] = device
        ol = report["open_loop"]
        ins = ol["per_kind_e2e"].get("insert", {})
        st = report["stats"]
        print(f"{engine.name} ({device}) {args.mix}+{args.arrival}"
              f"@{args.rate:g}/s: done={ol['n_done']} shed={ol['n_shed']} "
              f"commits={ol['server']['n_commits']} "
              f"debt_max={ol['stalls']['debt_max']}; {ol['service_model']} "
              f"e2e insert p50={ins.get('p50_s', 0)*1e3:.3f}ms "
              f"p99.9={ins.get('p999_s', 0)*1e3:.3f}ms; measured maintain "
              f"unit p99={st['maintain_unit_p99_s']*1e3:.3f}ms "
              f"p100={st['maintain_unit_p100_s']*1e3:.3f}ms "
              f"pairs={st['total_pairs']}")
        if obs is not None:
            ob = ol["obs"]
            print(f"    obs: {ob['n_windows']} windows "
                  f"stall_free={ob['stall_free_pct']:.1f}% "
                  f"trace_events={ob['trace']['events']}"
                  + (f" -> {args.trace}" if args.trace else ""))
    else:
        report = run_workload(engine, workload,
                              maintain_budget=args.maintain_budget)
        report["device"] = device
        pk = report["per_kind"]
        line = " ".join(
            f"{kind}[p50={h['p50_s']*1e3:.3f}ms p99={h['p99_s']*1e3:.3f}ms "
            f"p100={h['p100_s']*1e3:.3f}ms]" for kind, h in pk.items())
        print(f"{engine.name} ({device}) {args.mix}: {line} "
              f"pairs={report['stats']['total_pairs']}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
