"""The readers of the program's own spans: ``index.backpressure_ms_p99``
and ``shard.split_stall_max_ms`` on synthetic observations, where the
harness's ``Run`` holds the spans, and in whole traced runs on the CPU."""
import json
from pathlib import Path

import numpy as np
import pytest

from nbbench.harness import Observation, Run
from nbbench.spans import window_spans
from nbbench.spec import Cell

ROOT = Path(__file__).resolve().parents[2]
BP, SPLIT = "index.backpressure_ms_p99", "shard.split_stall_max_ms"


def _reader(name):
    return Cell("ordered-load.range4", ROOT).reader(name)


def _obs(phases, events=None, units=None, dropped=0):
    obs = Observation(
        setup_s=1.0, window_s=phases[-1][2] - phases[0][0],
        iterations=len(phases), ops_per_batch={"insert": 4, "update": 0,
                                               "read": 0, "scan": 0},
        iter_s=np.array([c - a for a, _, c in phases]),
        debts=np.zeros(len(phases)), sharded=True,
        backpressure_units=np.asarray(
            units if units is not None else [1] * len(phases)),
        dropped_events=dropped)
    if events is not None:
        obs.trace_events, obs.phases = events, phases
    return obs


def _span(cat, name, t_s, dur_s, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": round(t_s * 1e6, 3),
            "dur": round(dur_s * 1e6, 3), "args": args}


def _bp(t_s, dur_s):
    return _span("cascade", "backpressure_unit", t_s, dur_s, kind="flush",
                 depth=1)


#: three iterations: apply in [10k, 10k + 1), maintain(1) up to 10k + 2
PHASES = [(10.0 * k, 10.0 * k + 1, 10.0 * k + 2) for k in range(1, 4)]


def test_backpressure_sums_the_units_that_start_inside_apply():
    events = [
        _bp(10.1, 0.2), _bp(10.5, 0.1),        # iteration 1: 0.3 s
        _bp(11.5, 5.0),                         # its maintain: left out
        _span("flush_unit", "maintain_unit", 11.2, 9.0, kind="flush",
              depth=0),                         # not a backpressure unit
        _bp(30.0, 0.05),                        # iteration 3, at its start
        _bp(31.0, 0.4),                         # at its apply's end: out
        _bp(5.0, 1.0),                          # before the window
    ]                                           # iteration 2: none, 0
    got = _reader(BP)(_obs(PHASES, events, units=[2, 0, 1]))
    assert got == pytest.approx(300.0)
    # nearest rank over 200 iterations: the third largest
    phases = [(10.0 * k, 10.0 * k + 1, 10.0 * k + 2) for k in range(1, 201)]
    events = [_bp(phases[i][0] + 0.5, d)
              for i, d in ((3, 0.010), (70, 0.020), (150, 0.030))]
    assert _reader(BP)(_obs(phases, events)) == pytest.approx(10.0)


def test_backpressure_without_its_spans():
    """No reading where apply ran units and no span says how long (a
    program that records none) or the tracer dropped events; 0 where
    apply ran no unit."""
    read = _reader(BP)
    assert read(_obs(PHASES, [], units=[0, 3, 0])) is None
    assert read(_obs(PHASES, [], units=[0, 0, 0])) == 0.0
    assert read(_obs(PHASES, [_bp(10.1, 0.2)], dropped=4)) is None
    assert read(_obs(PHASES)) is None               # no spans anywhere


def test_split_stall_is_the_longest_split_in_the_window():
    read = _reader(SPLIT)
    split = dict(shard=3, pivot=7, left_pairs=5, right_pairs=5, n_shards=5)
    events = [
        _span("shard_split", "split", 11.5, 1.5, **split),
        _span("shard_split", "split", 21.5, 2.5, **split),
        _span("shard_split", "split", 5.0, 9.0, **split),     # before it
        {"ph": "i", "cat": "shard_split", "name": "split", "ts": 2.2e7,
         "s": "g"},                             # an instant: not a span
        _span("cascade", "backpressure_unit", 12.0, 0.5),
    ]
    assert read(_obs(PHASES, events)) == pytest.approx(2500.0)
    assert read(_obs(PHASES, events[2:])) is None       # no split in it
    assert read(_obs(PHASES, events, dropped=1)) is None
    assert read(_obs(PHASES)) is None


def test_spans_are_found_on_the_reading_run():
    """Without them on the ``Observation``, the readers take the tracer's
    events and the window's stamps from the ``Run`` reading them."""
    from repro_torch.obs.trace import Tracer

    class Reading:
        def __init__(self):
            self.tracer = Tracer()
            self.tracer.complete("cascade", "backpressure_unit", 10.2, 0.25)
            self.tracer.complete("shard_split", "split", 20.5, 1.25)

        def run(self, readers):
            w = {"phases": PHASES}
            obs = _obs(w["phases"])
            return [r(obs) for r in readers]

    assert Reading().run([_reader(BP), _reader(SPLIT)]) == [
        pytest.approx(250.0), pytest.approx(1250.0)]
    assert window_spans(_obs(PHASES)) is None        # nobody holds them


@pytest.mark.parametrize("cell", ["ycsb-load.nbtree", "ordered-load.range4"])
def test_traced_run_reads_the_program_spans(cell, tiny):
    """A whole traced CPU run: the backpressure spans inside apply are
    the units counted there, every split of the window is one span, and
    the readers report from them."""
    seen = {}

    class Spy(Run):
        def window(self, eng):
            seen["splits0"] = getattr(eng, "n_splits", 0)
            seen["w"] = super().window(eng)
            seen["splits1"] = getattr(eng, "n_splits", 0)
            return seen["w"]

    cfg = json.loads((ROOT / "nbbench" / "configs" / {
        "ycsb-load.nbtree": "ycsb-nbtree.json",
        "ordered-load.range4": "ycsb-nbtree-range4.json"}[cell]).read_text())
    config, mix = tiny(cell, cfg["engine_kwargs"])
    # four sigmas a batch: from the second batch on, every apply fills the
    # root and runs units under backpressure, however few batches the
    # window holds
    mix["batch"] = 4 * config["engine_kwargs"]["sigma"]
    run = Spy(cell, 2**31 + 23, 1.0, True, device="cpu",
              config_overrides=config, mix_overrides=mix,
              log=lambda *a: None)
    out = run.run()
    assert out["correct"], out["checks"]
    w = seen["w"]
    a = np.array([p[0] for p in w["phases"]]) * 1e6
    b = np.array([p[1] for p in w["phases"]]) * 1e6
    starts = np.array([e["ts"] for e in run.tracer.spans("cascade")
                       if e["name"] == "backpressure_unit"])
    inside = ((starts[:, None] >= a) & (starts[:, None] < b)).any(axis=1)
    assert inside.sum() == w["bp"].sum() > 0
    assert BP in out["metrics"]
    lo, hi = w["phases"][0][0] * 1e6, w["phases"][-1][2] * 1e6
    splits = [e for e in run.tracer.spans("shard_split")
              if lo <= e["ts"] < hi]
    assert len(splits) == seen["splits1"] - seen["splits0"]
    assert (SPLIT in out["metrics"]) == bool(splits)
    if splits:
        assert out["metrics"][SPLIT]["value"] == pytest.approx(
            max(e["dur"] for e in splits) / 1e3)


# ------------------------------------------------------------ on the card
#: impls whose idle seconds the two attributions compare
IDLE_IMPLS = ("_flush_impl", "_split_impl", "_insert_impl")


class ClockRun(Run):
    """A traced run that keeps its window's stamps, the ensemble's splits
    around it, the interpreter's collection pauses inside it and the
    device trace of the window's first half."""

    def window(self, eng):
        import gc
        import time

        self.splits = [getattr(eng, "n_splits", 0)]
        self.gc_pauses, start = [], []

        def pause(phase, info):
            if phase == "start":
                start[:] = [time.perf_counter()]
            elif start:
                self.gc_pauses.append((start[0], time.perf_counter()))

        gc.callbacks.append(pause)
        try:
            self.w = super().window(eng)
        finally:
            gc.callbacks.remove(pause)
        self.splits.append(getattr(eng, "n_splits", 0))
        return self.w

    def breakdown(self, device, w):
        self.device_trace = device
        return super().breakdown(device, w)


def clock_agreement(run: ClockRun, out: dict) -> dict:
    """What a traced card run shows of the one clock: the program's
    ``dispatch`` spans against the harness's own span of each impl call
    (one each, in order; a ``_flush_impl`` span holds the harness's, their
    starts apart by ``start_gap_us``), the idle seconds under
    :data:`IDLE_IMPLS` by the harness's ``breakdown`` and by the same
    attribution from the program's spans, the window's splits against its
    ``shard_split`` spans and its backpressure spans against the units
    counted inside ``apply``."""
    from nbbench import devtrace

    w = run.w
    spans = sorted(run.tracer.spans("dispatch"), key=lambda e: e["ts"])
    calls = sorted(run.impl_spans)
    named = [(e["name"], n) for e, (_, _, n) in zip(spans, calls)]
    gaps, held, late = [], 0, []
    for e, (a, b, name) in zip(spans, calls):
        if name == "_flush_impl" and e["name"] == name:
            gaps.append(a / 1e3 - e["ts"])
            held += e["ts"] <= a / 1e3 and b / 1e3 <= e["ts"] + e["dur"]
            if gaps[-1] >= 20:
                late.append((e["ts"], a / 1e3))
    paused = sum(any(p0 * 1e6 < t1 and t0 < p1 * 1e6
                     for p0, p1 in run.gc_pauses) for t0, t1 in late)
    host = devtrace.HostSpans()
    host.add_layer([(int(e["ts"] * 1e3), int((e["ts"] + e["dur"]) * 1e3),
                     e["name"]) for e in spans])
    ns = [(int(a * 1e9), int(b * 1e9), int(c * 1e9))
          for a, b, c in w["phases"]]
    host.add_layer([(a, b, "apply: host outside impls") for a, b, _ in ns]
                   + [(b, c, "maintain: host outside impls")
                      for _, b, c in ns])
    ours = dict(run.device_trace.idle_gaps(host, "loop between batches"))
    theirs = dict(out["breakdown"]["idle_gaps"])
    lo, hi = w["phases"][0][0] * 1e6, w["phases"][-1][2] * 1e6
    a = np.array([p[0] for p in w["phases"]]) * 1e6
    b = np.array([p[1] for p in w["phases"]]) * 1e6
    starts = np.array([e["ts"] for e in run.tracer.spans("cascade")
                       if e["name"] == "backpressure_unit"])
    inside = ((starts[:, None] >= a) & (starts[:, None] < b)).any(axis=1)
    return {
        "dispatch_spans": len(spans), "impl_calls": len(calls),
        "names_agree": all(x == y for x, y in named),
        "flush_calls": len(gaps), "flush_held": int(held),
        "start_gap_us": dict(zip(
            ("p50", "p99", "p999", "max"),
            np.quantile(gaps, [0.5, 0.99, 0.999, 1.0]).tolist()))
        if gaps else None,
        "gaps_20us_or_more": [len(late), paused],
        "gc_pauses": len(run.gc_pauses),
        "idle_s": {k: [theirs.get(k, 0.0), ours.get(k, 0.0)]
                   for k in IDLE_IMPLS},
        "splits": [run.splits[1] - run.splits[0], sum(
            lo <= e["ts"] < hi for e in run.tracer.spans("shard_split"))],
        "split_s": [[round(e["dur"] / 1e6, 6)] + [
            round(e["args"][k], 6) for k in ("drain_s", "extract_s",
                                             "reinsert_s")]
            + [e["args"]["left_pairs"] + e["args"]["right_pairs"]]
            for e in run.tracer.spans("shard_split")],
        "iteration_ms": dict(zip(("p50", "p99"), (np.quantile(
            w["iter_s"], [0.5, 0.99]) * 1e3).tolist())),
        "backpressure": [int(w["bp"].sum()), int(inside.sum())],
        "dropped_events": run.tracer.dropped_events,
    }


@pytest.mark.card
@pytest.mark.parametrize("cell", ["ycsb-load.nbtree", "ordered-load.range4"])
def test_program_spans_share_the_harness_clock_on_the_card(card, cell, tiny):
    """A short traced run on the card at the tiny size: every impl call's
    program span holds the harness's, starts under 20 us apart, and both
    attribute the device's idle time alike (5%)."""
    cfg = json.loads((ROOT / "nbbench" / "configs" / {
        "ycsb-load.nbtree": "ycsb-nbtree.json",
        "ordered-load.range4": "ycsb-nbtree-range4.json"}[cell]).read_text())
    config, mix = tiny(cell, cfg["engine_kwargs"])
    run = ClockRun(cell, 2**31 + 29, 2.0, True, device="cuda",
                   config_overrides=config, mix_overrides=mix,
                   log=lambda *a: None)
    out = run.run()
    assert out["correct"], out["checks"]
    got = clock_agreement(run, out)
    print(cell, json.dumps(got))
    assert got["dispatch_spans"] == got["impl_calls"] and got["names_agree"]
    assert got["flush_held"] == got["flush_calls"] > 0
    assert got["start_gap_us"]["p99"] < 20
    for harness, program in got["idle_s"].values():
        assert program == pytest.approx(harness, rel=0.05, abs=1e-4)
    assert got["splits"][0] == got["splits"][1]
    assert got["backpressure"][0] == got["backpressure"][1]
    assert got["dropped_events"] == 0
