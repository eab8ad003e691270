"""One run of one cell: set-up, the measured window, the readings, the check.

The window drives the program's storage entry in a closed loop, as a
batching client does: ``apply(batch)``, which returns once the device has
answered, then ``maintain(1)``, the paper's one maintenance unit a step; the
next batch goes out once both have returned.  An iteration's wall time is
that of the two calls.  Nothing is generated, compiled or checked inside the
window: the batches are made in set-up (or, past ``prefetch_batches``, as
the window reaches them), and the reference runs once it has closed.

A traced run (``trace``) adds the instruments every per-layer metric reads:
an ``obs.trace.Tracer`` on the engine (its ``flush_unit`` spans), the
engine's counters before and after, the units ``apply`` ran under
backpressure, each index impl call's host span, and ``torch.profiler`` over
the whole window.  Its window has two halves.  In the first the program runs
as in a timed run: the device's busy time, its idle share and the
``breakdown`` come from this half alone.  At the first iteration boundary
past the middle the device is synchronised and the kernel wrappers of
``kernel_work`` go on, which count each launch's least time with small
kernels of their own: the roofline shares come from the second half alone.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
import warnings

import numpy as np

from . import devtrace, kernel_work
from .reference import LastWriterWins, scan_mismatches, table_mismatches
from .spec import ROOT, Cell
from .traffic import READ, SCAN, WRITE, Traffic

#: top-level modules that no run may load: the JAX package and JAX itself
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")
#: events the engine's tracer keeps (a run that drops any reads no span)
TRACER_CAPACITY = 1 << 20


def forbidden_loaded(names=None) -> list:
    """Forbidden top-level modules among ``names`` (``sys.modules``),
    compared whole: ``repro_torch`` is not ``repro``."""
    tops = {name.split(".", 1)[0]
            for name in list(sys.modules if names is None else names)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


@dataclasses.dataclass
class Observation:
    """What one run saw; each metric reader takes what it needs from it."""

    setup_s: float
    window_s: float
    iterations: int
    ops_per_batch: dict          # op -> count in every batch of the mix
    iter_s: np.ndarray           # each iteration's apply + maintain(1)
    debts: np.ndarray            # what each maintain(1) returned
    sharded: bool
    # traced runs only
    backpressure_units: np.ndarray | None = None
    counters: dict | None = None   # EngineStats counters gained in the window
    flush_unit_s: list | None = None
    dropped_events: int = 0
    device: devtrace.DeviceTrace | None = None    # the plain first half
    kernel_trace: devtrace.DeviceTrace | None = None  # the wrapped half
    kernel_least: dict | None = None   # entry point -> (launches, least s)

    def total(self, *ops) -> int:
        return self.iterations * sum(self.ops_per_batch[o] for o in ops)


def _engines(eng) -> tuple:
    return tuple(getattr(eng, "shard_engines", (eng,)))


def _units(eng) -> int:
    return sum(e.idx.units_done for e in _engines(eng))


_COUNTERS = ("device_dispatches", "bloom_probes", "bloom_negative_skips",
             "bloom_false_positives", "maintain_units")


def _counters(eng) -> dict:
    st = eng.stats()
    return {k: getattr(st, k) for k in _COUNTERS}


def footprint(eng) -> str:
    """What the index holds on the device at the window's end: node rows
    allocated and reserved, the bytes of those rows, and the pairs they
    hold at 12 bytes a pair (a uint32 key kept in 8 bytes, an int32 value)."""
    idx = [e.idx for e in _engines(eng) if hasattr(e, "idx")]
    if not idx:
        return "index footprint: not an NB-tree engine"
    used = sum(i._next_id for i in idx)
    reserved = sum(i.max_nodes for i in idx)
    row = idx[0].table_bytes() // idx[0].max_nodes
    pairs = sum(i.total_pairs() for i in idx)
    return (f"index footprint: {used} of {reserved} node rows in use "
            f"({used * row} of {reserved * row} B of tables, {row} B a "
            f"row); {pairs} pairs held ({12 * pairs} B live)")


class Run:
    """One run of ``cell`` on ``device`` (``"cuda"`` on the card; the CPU
    only in tests).  ``engine_factory(config, device)`` puts another engine
    in the program's place (the control, a fault)."""

    def __init__(self, cell_name: str, seed: int, seconds: float,
                 trace: bool, *, root=ROOT, device: str = "cuda",
                 engine_factory=None, config_overrides=None,
                 mix_overrides=None, t_start: float | None = None,
                 log=None):
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.cell = Cell(cell_name, root)
        self.cell.config.update(config_overrides or {})
        self.cell.mix.update(mix_overrides or {})
        self.seed, self.seconds, self.trace = int(seed), seconds, bool(trace)
        self.device_name = device
        self.engine_factory = engine_factory
        self.log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))

    # ------------------------------------------------------------- set-up
    def _build(self):
        cfg = self.cell.config
        if self.engine_factory is not None:
            return self.engine_factory(cfg, self.dev)
        return self.make_engine(cfg["engine"], device=self.dev,
                                **cfg.get("engine_kwargs", {}))

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def _op(self, b):
        return self.OpBatch(b.kinds, b.keys, b.vals, b.his)

    def _lap(self, what: str) -> None:
        """Log the seconds since the last lap (set-up and closing phases)."""
        now = time.perf_counter()
        self.laps.append((what, now - self._last))
        self._last = now

    def setup(self):
        self.laps, self._last = [], self.t_start
        import torch

        from repro_torch.core.engine_api import OpBatch, OpKind, make_engine
        self.torch, self.OpBatch = torch, OpBatch
        self.make_engine = make_engine
        if (int(OpKind.INSERT), int(OpKind.QUERY), int(OpKind.RANGE)) != (
                WRITE, READ, SCAN):
            raise RuntimeError("the program's OpKind codes changed")
        self.dev = torch.device(self.device_name)
        if self.dev.type == "cuda":
            torch.cuda.init()
        self._lap("imports and device")
        if self.dev.type == "cuda":
            from repro_torch.kernels import _build
            _build.library()                # built once per checkout
        self._lap("kernel library")
        traffic = self.traffic = Traffic(self.cell.config, self.cell.mix,
                                         self.seed)
        n = traffic.prefetch()
        self._ops = {t: self._op(traffic.batch(t)) for t in range(n)}
        self._lap(f"traffic ({n} batches)")
        if traffic.warmup_batches:
            eng = self._build()
            for b in traffic.warmup():
                eng.apply(self._op(b))
                eng.maintain(1)
            self._sync()
            del eng
            gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)
        self._lap(f"warm-up ({traffic.warmup_batches} batches)")
        eng = self._build()
        for keys, vals in traffic.preload_batches():
            eng.apply(OpBatch.inserts(keys, vals))
            eng.maintain(1)
        if traffic.recordcount:
            eng.drain()
        self._sync()
        self._lap(f"engine and load ({traffic.recordcount} records)")
        return eng

    def _stream(self, t: int):
        ob = self._ops.get(t)
        if ob is None:
            ob = self._ops[t] = self._op(self.traffic.batch(t))
        return ob

    # -------------------------------------------------------------- window
    def window(self, eng) -> dict:
        """The measured loop; returns what the readers and the check need."""
        trace, perf = self.trace, time.perf_counter
        keep = bool(self.traffic.counts["read"] or self.traffic.counts["scan"])
        iter_s, debts, results, bp, phases = [], [], [], [], []
        gc.collect()
        gc.freeze()
        self._sync()
        self._lap("tracing on" if trace else "gc")
        setup_s = perf() - self.t_start
        t0 = perf()
        t_mid = None
        t = 0
        while True:
            ob = self._stream(t)
            if trace:
                u0 = _units(eng)
            a = perf()
            res = eng.apply(ob)
            b = perf()
            if trace:
                bp.append(_units(eng) - u0)
            debts.append(eng.maintain(1))
            c = perf()
            iter_s.append(c - a)
            if trace:
                phases.append((a, b, c))
            if keep:
                results.append(res)
            t += 1
            if c - t0 >= self.seconds:
                break
            if trace and t_mid is None and c - t0 >= self.seconds / 2:
                self._sync()
                t_mid = perf()
                self.work.__enter__()
        gc.unfreeze()
        return dict(setup_s=setup_s, t0=t0, t_mid=t_mid, t1=c, iterations=t,
                    iter_s=np.asarray(iter_s), debts=np.asarray(debts),
                    results=results, bp=np.asarray(bp), phases=phases)

    # -------------------------------------------------------------- tracing
    def _start_trace(self, eng):
        from repro_torch.core import torch_nbtree
        from repro_torch.kernels import ops
        from repro_torch.obs.trace import Tracer

        torch = self.torch
        self.counters0 = _counters(eng)
        self.tracer = Tracer(capacity=TRACER_CAPACITY)
        eng.attach_tracer(self.tracer)
        self.impl_spans = spans = []
        plain = self._plain_device_call = torch_nbtree._device_call

        def timed_call(fn, *args, **kwargs):
            a = time.perf_counter_ns()
            try:
                return plain(fn, *args, **kwargs)
            finally:
                spans.append((a, time.perf_counter_ns(),
                              getattr(fn, "__name__", "impl")))

        torch_nbtree._device_call = timed_call
        rates = kernel_work.peaks(torch.cuda.get_device_name(self.dev)
                                  if self.dev.type == "cuda" else "")
        self.work = kernel_work.KernelWork(ops, rates)  # on at mid-window
        self.prof = None
        self.marker_ns = None
        if self.dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            torch.cuda.synchronize(self.dev)
            self.marker_ns = time.perf_counter_ns()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize(self.dev)

    def _stop_trace(self, eng, w: dict) -> dict:
        from repro_torch.core import torch_nbtree

        if self.prof is not None:
            with warnings.catch_warnings():    # "clears events each cycle"
                warnings.simplefilter("ignore", UserWarning)
                self.prof.stop()
        self.work.__exit__(None, None, None)
        torch_nbtree._device_call = self._plain_device_call
        counters1 = _counters(eng)
        out = dict(
            backpressure_units=w["bp"],
            counters={k: counters1[k] - self.counters0[k] for k in _COUNTERS},
            flush_unit_s=[e["dur"] / 1e6
                          for e in self.tracer.spans("flush_unit")],
            dropped_events=self.tracer.dropped_events,
            kernel_least=self.work.least_time_s(),
            device=None, kernel_trace=None)
        if self.prof is not None:
            events = devtrace.device_events(self.prof)
            offset = devtrace.clock_offset(self.marker_ns, events)
            t0, t1 = int(w["t0"] * 1e9), int(w["t1"] * 1e9)
            mid = t1 if w["t_mid"] is None else int(w["t_mid"] * 1e9)
            out["device"] = devtrace.DeviceTrace(events, t0, mid, offset)
            if mid < t1:
                out["kernel_trace"] = devtrace.DeviceTrace(events, mid, t1,
                                                           offset)
        return out

    def breakdown(self, device: devtrace.DeviceTrace, w: dict) -> dict:
        """The ten device operations that took most time and the ten host
        activities under which the device idled most, in seconds."""
        host = devtrace.HostSpans()
        host.add_layer(self.impl_spans)
        ns = [(int(a * 1e9), int(b * 1e9), int(c * 1e9))
              for a, b, c in w["phases"]]
        host.add_layer([(a, b, "apply: host outside impls") for a, b, _ in ns]
                       + [(b, c, "maintain: host outside impls")
                          for _, b, c in ns])
        return {"device_ops": [[k, v] for k, v in
                               device.by_name().most_common(10)],
                "idle_gaps": device.idle_gaps(
                    host, "loop between batches")[:10]}

    # ---------------------------------------------------------------- check
    def check(self, w: dict, table) -> dict:
        """Every read and scan answer of the window and the final table
        against the reference: ``{name: (mismatches, limit)}``."""
        tr = self.traffic
        ref = LastWriterWins()
        start = 0
        for keys, vals in tr.preload_batches():
            ref.write(keys, vals, np.arange(start, start + len(keys)))
            start += len(keys)
        for t in range(w["iterations"] if tr.has_writes else 0):
            b = tr.batch(t)
            m = np.flatnonzero(b.kinds == WRITE)
            ref.write(b.keys[m], b.vals[m], tr.op_time(t) + m)
        checks = {}
        if tr.counts["read"]:
            bad = 0
            for t, res in enumerate(w["results"]):
                b = tr.batch(t)
                m = np.flatnonzero(b.kinds == READ)
                found, vals = ref.read(b.keys[m], tr.op_time(t) + m)
                bad += int(((np.asarray(res.found)[m] != found)
                            | (np.asarray(res.values)[m] != vals)).sum())
            checks["read_mismatches"] = (bad, 0)
        if tr.counts["scan"]:
            bad = 0
            for t, res in enumerate(w["results"]):
                b = tr.batch(t)
                m = np.flatnonzero(b.kinds == SCAN)
                rk, rv, rc = ref.scan(b.keys[m], b.his[m], tr.op_time(t) + m)
                hits = [res.range_hits[i] for i in m]
                counts = np.array([len(h[0]) for h in hits], np.int64)
                keys = np.concatenate([h[0] for h in hits])
                vals = np.concatenate([h[1] for h in hits])
                bad += scan_mismatches(keys, vals, counts, rk, rv, rc)
                bad += int(np.asarray(res.range_truncated)[m].sum())
            checks["scan_mismatches"] = (bad, 0)
        checks["table_mismatches"] = (table_mismatches(*table, *ref.table()),
                                      0)
        return checks

    # ------------------------------------------------------------------ run
    def run(self) -> dict:
        eng = self.setup()
        if self.trace:
            self._start_trace(eng)
        w = self.window(eng)
        self._sync()
        torch = self.torch
        peak = (torch.cuda.max_memory_allocated(self.dev)
                if self.dev.type == "cuda" else 0)
        self._last = time.perf_counter()
        traced = self._stop_trace(eng, w) if self.trace else {}
        self._lap("trace read")
        obs = Observation(
            setup_s=w["setup_s"], window_s=w["t1"] - w["t0"],
            iterations=w["iterations"], ops_per_batch=self.traffic.counts,
            iter_s=w["iter_s"], debts=w["debts"],
            sharded=hasattr(eng, "shard_engines"), **traced)
        self.log(f"window: {obs.window_s:.6f} s, {obs.iterations} "
                 f"iterations of {self.traffic.batch_size} ops; tail "
                 f"samples (iterations): {len(obs.iter_s)}")
        ends = np.cumsum(obs.iter_s)
        slices = np.bincount((ends // 5).astype(np.int64))
        self.log("iterations a 5 s of the loop's own time: "
                 + " ".join(str(n) for n in slices)
                 + f"; iteration p50 {np.median(obs.iter_s) * 1e3:.3f} ms")
        if obs.sharded:
            self.log(f"shards at the window's end: {len(eng.shard_engines)}"
                     f", hot-shard splits since the start: {eng.n_splits}")
        self.log(footprint(eng))
        if self.trace:
            self.log(f"flush_unit spans: {len(obs.flush_unit_s)}, dropped "
                     f"events: {obs.dropped_events}")
        metrics = {}
        for m in self.cell.metrics(self.trace):
            value = self.cell.reader(m["name"])(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        table = eng.dump_live()
        del eng
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        self._lap("final table")
        checks = self.check(w, table)
        self._lap("reference check")
        self.log("phases: "
                 + ", ".join(f"{k} {v:.3f} s" for k, v in self.laps))
        device = {"platform": "gpu" if self.dev.type == "cuda" else "cpu",
                  "kind": (torch.cuda.get_device_name(self.dev)
                           if self.dev.type == "cuda" else "cpu"),
                  "count": self.cell.chips, "memory_peak_bytes": int(peak)}
        out = {"correct": all(v <= lim for v, lim in checks.values()),
               "attempted": obs.total("insert", "update", "read", "scan"),
               "failed": sum(v for v, _ in checks.values()),
               "metrics": metrics, "device": device}
        if obs.device is not None:
            device["busy_s"] = obs.device.busy_s
            device["window_s"] = obs.device.window_s
            out["breakdown"] = self.breakdown(obs.device, w)
        out["checks"] = {k: {"value": v, "limit": lim}
                         for k, (v, lim) in checks.items()}
        return out
