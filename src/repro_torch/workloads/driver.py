"""Workload driver: stream any mix through any of the port's engines,
closed or open loop, one stream or several, replicated or not.

``run_workload(engine, workload)`` applies the preload, then the mixed
stream batch by batch, calling ``engine.maintain(budget)`` between batches
(the serving loop's deamortization knob), and records per-op latencies
into per-kind log-bucket histograms: the closed loop of
``repro/workloads/driver.py::run_workload``, with the same report shape.
``run_open_workload`` is its open-loop counterpart (DESIGN.md §7):
timestamped arrivals through the ingest frontend's bounded queue and group
commit; end-to-end latency = queueing + service, on the frontend's clock
(a virtual per-op service on this wall-clock engine).

``run_multi_workload`` / ``run_open_multi_workload`` drive one stream per
tenant, each namespace-encoded into its own key interval (``tenancy``):
closed loop, the streams interleave round-robin batch by batch; open
loop, they serve through the multi-tenant frontend (weighted-fair
admission, or the shared-FIFO baseline).  ``run_replicated_workload``
serves one stream through replicated range partitions (``replication``,
sim-clock tiers only) with an optional chaos schedule.  Reports keep the
JAX package's layout (its ``repro/workloads/driver.py``).

CLI (``torch-nbtree`` on the card by default; ``--device cpu`` runs the
plain versions; ``--engines all`` is :data:`FIVE_TIERS`; ``--shards N``
wraps each engine as ``sharded:<name>``; repeat ``--mix`` for one stream
per tenant; ``--replicas R`` replicates each range partition;
``--list-engines`` / ``--list-mixes`` print the registry and the mixes)::

    PYTHONPATH=src python -m repro_torch.workloads.driver \
        --mix insert-heavy --ops 65536 --out runs/x.json
    PYTHONPATH=src python -m repro_torch.workloads.driver \
        --mix insert-heavy --arrival poisson --rate 20000 --ops 65536 \
        --trace runs/trace.json --out runs/ol.json
    PYTHONPATH=src python -m repro_torch.workloads.driver --device cpu \
        --engines all --shards 4 --mix insert-heavy --mix ycsb-e \
        --arrival poisson --rate 4000 --out runs/tenants.json
    PYTHONPATH=src python -m repro_torch.workloads.driver --engines nbtree \
        --shards 2 --replicas 3 --arrival poisson --rate 20000 \
        --chaos 'crash@0.05:g0/primary' --out runs/repl.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from ..core.engine_api import (FIVE_TIERS, OpBatch, OpKind, StorageEngine,
                               available_engines, make_engine)
from ..device import resolve_device
from ..obs.metrics import LogBucketHistogram, ObsConfig
from .generator import MIXES, Workload, make_workload

#: the JAX package's report layout (its schema version 8).
SCHEMA_VERSION = 8

#: engine configuration of the CLI's device tier: the deployment shape
#: (f=4, sigma=4096).
ENGINE_CONFIG = dict(f=4, sigma=4096)

#: small-footprint constructor kwargs of the host tiers for CLI runs (the
#: JAX package's smoke configurations).
_SMALL_CONFIGS = {
    "nbtree": dict(f=3, sigma=1024),
    "nbtree-basic": dict(f=3, sigma=1024),
    "nbtree-nobloom": dict(f=3, sigma=1024),
    "lsm": dict(mem_pairs=1024),
    "blsm": dict(mem_pairs=1024),
    "btree": {},
    "bepsilon": dict(node_bytes=1 << 16, cached_levels=1),
}


def _spec_dict(spec) -> dict:
    return dataclasses.asdict(spec) | {
        "mix": {OpKind(k).name.lower(): p for k, p in spec.mix.items()}}


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

    def percentile(self, q: float) -> float:
        """Quantile at ``q`` in [0, 100]; exact at q=0 and q=100."""
        return self._h.quantile(q / 100.0)

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
        "workload": _spec_dict(spec),
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
    report["workload"] = _spec_dict(workload.spec)
    return report


def run_multi_workload(engine: StorageEngine, workloads: list, *,
                       maintain_budget: int = 1, namespace=None) -> dict:
    """Closed-loop multi-stream drive: one namespace per workload.

    Stream *i*'s keys are encoded into tenant *i*'s interval
    (``tenancy.NamespaceMap``) and the streams interleave round-robin
    batch by batch — deterministic contention on one shared engine — with
    latencies recorded into per-stream per-kind histograms.
    """
    from ..tenancy import NamespaceMap

    ns = namespace or NamespaceMap()
    pre = [ns.encode_batch(i, wl.preload_batch())
           for i, wl in enumerate(workloads)]
    pre = [b for b in pre if len(b)]
    n_pre = sum(len(b) for b in pre)
    if pre:
        engine.apply(OpBatch.concat(pre))
        engine.drain()

    hists = [{k: LatencyHistogram() for k in OpKind} for _ in workloads]
    iters = [wl.batches() for wl in workloads]
    alive = list(range(len(workloads)))
    max_debt = 0
    while alive:
        for i in list(alive):
            batch = next(iters[i], None)
            if batch is None:
                alive.remove(i)
                continue
            res = engine.apply(ns.encode_batch(i, batch))
            for k in OpKind:
                hists[i][k].add(res.latencies(k))
            max_debt = max(max_debt, engine.maintain(maintain_budget))
    debt_before_drain = engine.maintain(0)
    engine.drain()

    stats = engine.stats()
    streams = []
    for i, wl in enumerate(workloads):
        lo, hi = ns.tenant_interval(i)
        streams.append({
            "stream": i,
            "workload": _spec_dict(wl.spec),
            "interval": [int(lo), int(hi)],
            "live_pairs": int(engine.count_live_range(lo, hi)),
            "per_kind": {OpKind(k).name.lower(): h.to_dict()
                         for k, h in hists[i].items() if h.count},
        })
    return {
        "schema_version": SCHEMA_VERSION,
        "engine": engine.name,
        "namespace": ns.describe(),
        "maintain_budget": maintain_budget,
        "preload_pairs": n_pre,
        "max_pending_debt": int(max_debt),
        "pending_debt_before_drain": int(debt_before_drain),
        "streams": streams,
        "stats": dataclasses.asdict(stats),
    }


def run_open_multi_workload(engine: StorageEngine, workloads: list, *,
                            arrival: str, rate: float,
                            duration_s: float | None = None,
                            maintain_budget: int = 1, weights=None,
                            fair: bool = True,
                            obs: ObsConfig | None = None) -> dict:
    """Open-loop multi-stream drive through the multi-tenant frontend.

    One tenant per workload; every tenant gets its own instance of the
    named arrival process at ``rate`` (its trace seeded by its workload
    seed, so streams stay independent).  ``weights`` sets the DRR shares
    (default: equal); ``fair=False`` is the shared-FIFO baseline.
    """
    from ..ingest import FrontendConfig, make_arrivals, make_trace
    from ..tenancy import TenantConfig, run_multi_tenant

    tenants = [TenantConfig(i, name=wl.spec.name,
                            weight=(float(weights[i]) if weights else 1.0))
               for i, wl in enumerate(workloads)]
    traces = {i: make_trace(wl, make_arrivals(arrival, rate),
                            duration_s=duration_s)
              for i, wl in enumerate(workloads)}
    cfg = FrontendConfig(maintain_budget=maintain_budget)
    report = run_multi_tenant(engine, tenants, traces, config=cfg, fair=fair,
                              obs=obs)
    report["schema_version"] = SCHEMA_VERSION
    report["workloads"] = [_spec_dict(wl.spec) for wl in workloads]
    return report


def run_replicated_workload(engine_name: str, workload: Workload, *,
                            arrival: str, rate: float,
                            duration_s: float | None = None,
                            groups: int = 4, replicas: int = 2,
                            ack_mode: str = "quorum",
                            chaos_spec: str | None = None,
                            maintain_budget: int = 1,
                            obs: ObsConfig | None = None,
                            directory: str | None = None,
                            base_kw: dict | None = None) -> dict:
    """Replicated open loop (DESIGN.md §12): R WAL-shipped copies per range.

    Serves the open-loop trace through :class:`repro_torch.replication.
    ReplicatedFrontend` — ``groups`` range partitions, each a primary plus
    ``replicas - 1`` replicas acking at ``ack_mode`` ("quorum" or
    "primary").  ``chaos_spec`` is the ``--chaos`` DSL; the report gains a
    ``"replication"`` section with failover events and per-group
    availability timelines.  WAL segment directories live under
    ``directory`` (a temporary directory when None).  Replication runs on
    the sim-clock tiers only.
    """
    import tempfile

    from ..ingest import FrontendConfig, make_arrivals, make_trace
    from ..replication import ReplicationConfig, run_replicated
    from ..wal import FaultSchedule

    def factory():
        return make_engine(engine_name, **(base_kw or {}))

    trace = make_trace(workload, make_arrivals(arrival, rate),
                       duration_s=duration_s)
    chaos = FaultSchedule.parse(chaos_spec) if chaos_spec else None
    rep = ReplicationConfig(replicas=replicas, ack_mode=ack_mode)
    cfg = FrontendConfig(maintain_budget=maintain_budget)
    kw = dict(groups=groups, replication=rep, config=cfg, chaos=chaos,
              obs=obs)
    if directory is None:
        with tempfile.TemporaryDirectory(prefix="repro_torch_repl_") as d:
            report = run_replicated(factory, trace, d, **kw)
    else:
        report = run_replicated(factory, trace, directory, **kw)
    report["schema_version"] = SCHEMA_VERSION
    report["workload"] = _spec_dict(workload.spec)
    return report


def _resolve_engine_names(engines, parser: argparse.ArgumentParser) -> tuple:
    """'all' -> the five paper tiers; anything unknown is a CLI error."""
    if engines == ["all"]:
        return FIVE_TIERS
    known = set(available_engines())
    bad = [n for n in engines if n not in known]
    if bad:
        parser.error(f"unknown engine(s): {', '.join(sorted(bad))}; "
                     f"registered: {', '.join(available_engines())} "
                     "(--list-engines to enumerate)")
    return tuple(engines)


def _print_closed(engine, report, mix) -> None:
    pk = report["per_kind"]
    line = " ".join(
        f"{kind}[p50={h['p50_s']*1e3:.3f}ms p99={h['p99_s']*1e3:.3f}ms "
        f"p100={h['p100_s']*1e3:.3f}ms]" for kind, h in pk.items())
    print(f"{engine.name} ({report['device']}) {mix}: {line} "
          f"pairs={report['stats']['total_pairs']} "
          f"shards={report['stats']['shards']}")


def _print_open(engine, report, args, mix, obs) -> None:
    ol = report["open_loop"]
    ins = ol["per_kind_e2e"].get("insert", {})
    st = report["stats"]
    print(f"{engine.name} ({report['device']}) {mix}+{args.arrival}"
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


def _print_multi(engine, report, args, mixes) -> None:
    if args.arrival:
        ol = report["open_loop"]
        print(f"{engine.name} ({report['device']}) {len(mixes)} streams "
              f"+{args.arrival}@{args.rate:g}/s fair={ol['fair']}: "
              f"shed={ol['n_shed']} "
              f"util={ol['server']['utilization']:.2f}; "
              f"{ol['service_model']} e2e")
        for tid, t in sorted(ol["tenants"].items()):
            sub = t["open_loop"]
            ins = sub["per_kind_e2e"].get("insert", {})
            print(f"    stream {tid} ({t['name']}, w={t['weight']:g}): "
                  f"done={sub['n_done']} shed={sub['n_shed']} "
                  f"insert p99.9={ins.get('p999_s', 0)*1e3:.3f}ms "
                  f"live={t['live_pairs']}")
        return
    print(f"{engine.name} ({report['device']}) {len(mixes)} streams "
          f"closed-loop: pairs={report['stats']['total_pairs']}")
    for s in report["streams"]:
        line = " ".join(f"{kind}[p50={h['p50_s']*1e3:.3f}ms "
                        f"p99={h['p99_s']*1e3:.3f}ms]"
                        for kind, h in s["per_kind"].items())
        print(f"    stream {s['stream']} ({s['workload']['name']}): "
              f"{line} live={s['live_pairs']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--engines", nargs="+", default=["torch-nbtree"],
                    help="engine names, or 'all' for the five paper tiers "
                         f"({', '.join(FIVE_TIERS)}); see --list-engines")
    ap.add_argument("--list-engines", action="store_true",
                    help="print the registered engine names and exit")
    ap.add_argument("--list-mixes", action="store_true",
                    help="print the named workload mixes and exit")
    ap.add_argument("--mix", action="append", choices=sorted(MIXES),
                    help="workload mix; repeat for one stream per tenant "
                         "(multi-stream mode). Default: insert-heavy")
    ap.add_argument("--weights", nargs="+", type=float, default=None,
                    help="multi-stream fair-share weights, one per --mix")
    ap.add_argument("--unfair", action="store_true",
                    help="multi-stream open loop: shared-FIFO baseline "
                         "instead of weighted-fair admission")
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
                    help="device of torch-nbtree: cuda (default; raises "
                         "without a card) or cpu")
    ap.add_argument("--shards", type=int, default=1,
                    help="N > 1 wraps each engine as sharded:<name> with N "
                         "shards; with --replicas, the range group count")
    ap.add_argument("--partition", choices=("range", "hash"), default="range")
    ap.add_argument("--replicas", type=int, default=0, metavar="R",
                    help="replicated open loop: R WAL-shipped copies per "
                         "range partition (sim-clock tiers; needs "
                         "--arrival)")
    ap.add_argument("--ack", choices=("quorum", "primary"), default="quorum",
                    help="replicated ack mode: a majority of copies "
                         "(quorum) or the primary's fsync only")
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
                         "fsync_stall|latency_spike|torn_segment|bit_flip; "
                         "default target 'wal' (the frontend), with "
                         "--replicas targets like g0/primary, g1/r0, g2")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="open-loop mode: save a Chrome trace_event JSON of "
                         "the frontend's and the engine's spans here")
    ap.add_argument("--metrics-window", type=float, default=None,
                    metavar="SECONDS",
                    help="open-loop mode: windowed-metrics timeline width on "
                         "the frontend's clock (enables the report's 'obs' "
                         "section; 1.0 when only --trace is set)")
    ap.add_argument("--out", default="runs/torch_driver_report.json",
                    help="write the JSON report here (one engine: its "
                         "report; several: a list under 'reports')")
    args = ap.parse_args(argv)
    if args.list_engines:
        for name in available_engines():
            print(name)
        print("sharded:<base>  (any of the above via --shards N)")
        return
    if args.list_mixes:
        for name in sorted(MIXES):
            kinds = {OpKind(k).name.lower(): p for k, p in MIXES[name].items()}
            print(f"{name}: {kinds}")
        return
    if not args.arrival and (args.chaos or args.trace or args.replicas
                             or args.metrics_window is not None):
        ap.error("--chaos/--trace/--metrics-window/--replicas need open-loop "
                 "mode (--arrival)")
    names = _resolve_engine_names(args.engines, ap)
    mixes = args.mix or ["insert-heavy"]
    if args.weights is not None and len(args.weights) != len(mixes):
        ap.error("--weights needs exactly one value per --mix")
    if args.replicas:
        if len(mixes) > 1:
            ap.error("--replicas runs a single stream (one --mix)")
        if "torch-nbtree" in names:
            ap.error("--replicas runs on the sim-clock tiers only; drop "
                     "torch-nbtree from --engines")
    if args.trace and len(names) > 1:
        ap.error("--trace needs a single --engines value")

    overrides = dict(n_ops=args.ops, batch_size=args.batch,
                     preload=args.preload, key_space=args.key_space,
                     seed=args.seed)
    if args.dist:
        overrides["dist"] = args.dist
    obs = None
    if args.trace or args.metrics_window is not None:
        obs = ObsConfig(window_s=args.metrics_window or 1.0,
                        trace_path=args.trace)

    reports = []
    for name in names:
        if name == "torch-nbtree":
            base_kw = dict(ENGINE_CONFIG, device=args.device)
        else:
            base_kw = _SMALL_CONFIGS.get(name, {})
        if args.replicas:
            workload = make_workload(mixes[0], **overrides)
            report = run_replicated_workload(
                name, workload, arrival=args.arrival, rate=args.rate,
                duration_s=args.duration, groups=max(1, args.shards),
                replicas=args.replicas, ack_mode=args.ack,
                chaos_spec=args.chaos, maintain_budget=args.maintain_budget,
                obs=obs, base_kw=base_kw)
            report["device"] = "host"
            reports.append(report)
            rep = report["replication"]
            ins = report["per_kind_e2e"].get("insert", {})
            down = sum(a["downtime_s"] for a in rep["availability"])
            print(f"{name} R={args.replicas}/{args.ack} "
                  f"x{rep['n_groups']} groups {mixes[0]}+{args.arrival}"
                  f"@{args.rate:g}/s: done={report['n_done']} "
                  f"shed={report['n_shed']} acked={rep['acked_commits']} "
                  f"failovers={len(rep['failovers'])} "
                  f"downtime={down*1e3:.1f}ms "
                  f"insert p99.9={ins.get('p999_s', 0)*1e3:.3f}ms")
            continue
        if args.shards > 1:
            engine = make_engine(f"sharded:{name}", shards=args.shards,
                                 partition=args.partition, **base_kw)
        else:
            engine = make_engine(name, **base_kw)
        device = (str(resolve_device(args.device))
                  if name == "torch-nbtree" else "host")
        if len(mixes) > 1:
            # one stream per mix, each in its own namespace; stream seeds
            # decorrelated as the scenario catalog does.
            workloads = [make_workload(m, **overrides
                                       | {"seed": args.seed * 1000 + i})
                         for i, m in enumerate(mixes)]
            if args.arrival:
                report = run_open_multi_workload(
                    engine, workloads, arrival=args.arrival, rate=args.rate,
                    duration_s=args.duration,
                    maintain_budget=args.maintain_budget,
                    weights=args.weights, fair=not args.unfair, obs=obs)
            else:
                report = run_multi_workload(
                    engine, workloads, maintain_budget=args.maintain_budget)
            report["device"] = device
            _print_multi(engine, report, args, mixes)
        elif args.arrival:
            workload = make_workload(mixes[0], **overrides)
            report = run_open_workload(engine, workload, arrival=args.arrival,
                                       rate=args.rate,
                                       duration_s=args.duration,
                                       maintain_budget=args.maintain_budget,
                                       obs=obs, chaos_spec=args.chaos)
            report["device"] = device
            _print_open(engine, report, args, mixes[0], obs)
        else:
            workload = make_workload(mixes[0], **overrides)
            report = run_workload(engine, workload,
                                  maintain_budget=args.maintain_budget)
            report["device"] = device
            _print_closed(engine, report, mixes[0])
        reports.append(report)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        out = reports[0] if len(reports) == 1 else {
            "schema_version": SCHEMA_VERSION,
            "mix": mixes[0] if len(mixes) == 1 else list(mixes),
            "seed": args.seed, "shards": args.shards,
            "arrival": args.arrival, "reports": reports}
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
