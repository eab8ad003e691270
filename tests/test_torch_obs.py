"""The port's observability layer (``repro_torch.obs``) vs the JAX package's.

The same inputs go through both copies: the log-bucket histogram, the
windowed-metrics timeline, stall detection and attribution, and the span
tracer's Chrome ``trace_event`` JSON must come out equal, to the byte
where a file is written.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.obs import LogBucketHistogram as JaxHist
from repro.obs import ObsConfig as JaxObsConfig
from repro.obs import Tracer as JaxTracer
from repro.obs import WindowedMetrics as JaxWindows
from repro.obs import attribute_stalls as jax_attribute
from repro.obs import detect_stalls as jax_detect
from repro.obs import validate_chrome_trace as jax_validate
from repro_torch.obs import (SPAN_CATEGORIES, LogBucketHistogram, ObsConfig,
                             Tracer, WindowedMetrics, attribute_stalls,
                             detect_stalls, validate_chrome_trace)
from repro_torch.obs.metrics import BUCKET_EDGES_S


def _samples(dist, n=20_000):
    rng = np.random.default_rng({"lognormal": 1, "uniform": 2,
                                 "bimodal": 3}[dist])
    if dist == "lognormal":
        return rng.lognormal(mean=-7.0, sigma=2.0, size=n)
    if dist == "uniform":
        return rng.uniform(1e-6, 1e-2, size=n)
    return np.concatenate([rng.normal(1e-4, 1e-5, n // 2),
                           rng.normal(5e-2, 5e-3, n // 2)]).clip(1e-9)


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "bimodal"])
def test_histogram_matches_jax(dist):
    xs = _samples(dist)
    ours, theirs = LogBucketHistogram(), JaxHist()
    ours.add_many(xs[:-50])
    theirs.add_many(xs[:-50])
    for x in xs[-50:]:                      # the scalar path too
        ours.add(float(x))
        theirs.add(float(x))
    assert np.array_equal(ours.counts, theirs.counts)
    assert (ours.count, ours.total, ours.min, ours.max) == \
        (theirs.count, theirs.total, theirs.min, theirs.max)
    for q in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)
    assert ours.summary() == theirs.summary()
    # within one bucket of the exact order statistic, as the JAX tests hold
    ratio = float(BUCKET_EDGES_S[1] / BUCKET_EDGES_S[0])
    for q in (0.5, 0.99):
        exact = float(np.quantile(xs, q, method="lower"))
        assert exact / ratio / 1.0001 <= ours.quantile(q) <= \
            exact * ratio * 1.0001


def test_histogram_merge_reset_and_edges_match_jax():
    xs = [1e-6, 3e-4, 2e-1, 5.0, 1e-12, 1e9]      # out-of-range clamps
    a, b, ja, jb = (LogBucketHistogram(), LogBucketHistogram(), JaxHist(),
                    JaxHist())
    a.add_many(xs)
    ja.add_many(xs)
    b.add_many([5e-3, 7e-3])
    jb.add_many([5e-3, 7e-3])
    a.merge(b)
    ja.merge(jb)
    assert a.summary() == ja.summary()
    a.reset()
    ja.reset()
    assert a.summary() == ja.summary() and a.count == 0
    assert dataclasses.asdict(ObsConfig()) == dataclasses.asdict(
        JaxObsConfig())


def _feed_windows(wm, rng):
    """A timeline with a clock jump followed by a shed, a stall and a
    trailing partial window."""
    t = 0.0
    for i in range(40):
        t += float(rng.exponential(0.05))
        lat = rng.lognormal(-7.0, 0.3, int(rng.integers(1, 9)))
        if 20 <= i < 23:
            lat = lat * 40.0                       # stalled windows
        wm.record(t, lat, ops=len(lat), queue_depth=int(rng.integers(0, 64)),
                  debt=int(rng.integers(0, 3)))
        if i == 30:
            t += 1.7                               # clock jump
            wm.record_shed(t, 5)
    wm.record(t + 0.01, 2e-3)                      # scalar latency
    return t + 0.5


@pytest.mark.parametrize("window_s,stall_k", [(0.1, 4.0), (0.25, 2.0)])
def test_windowed_metrics_match_jax(window_s, stall_k):
    ours = WindowedMetrics(window_s, stall_k=stall_k, stall_trailing=8)
    theirs = JaxWindows(window_s, stall_k=stall_k, stall_trailing=8)
    t_end = _feed_windows(ours, np.random.default_rng(4))
    _feed_windows(theirs, np.random.default_rng(4))
    a, b = ours.finish(t_end), theirs.finish(t_end)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert a["n_windows"] > a["n_active_windows"] > 0
    assert any(w["shed"] == 5 for w in a["timeline"])
    with pytest.raises(ValueError):
        WindowedMetrics(0.0)


def _windows(p99s):
    return [{"t_start_s": float(i), "t_end_s": float(i + 1), "ops": 100,
             "p99_s": p, "p50_s": p / 2} for i, p in enumerate(p99s)]


@pytest.mark.parametrize("p99s,kw", [
    ([1e-3] * 10 + [10e-3] + [1e-3] * 5, dict(k=4.0)),
    ([1e-3] * 8 + [20e-3] * 3 + [1e-3] * 4, dict(k=4.0)),
    ([50e-3, 1e-3, 1e-3, 1e-3, 1e-3], dict(k=4.0, min_history=4)),
    ([1e-3, 2e-3] * 12 + [9e-3], dict(k=3.0, trailing=4)),
], ids=["spike", "consecutive", "warmup", "short-trailing"])
def test_stall_detection_and_attribution_match_jax(p99s, kw):
    ws = _windows(p99s)
    ours, theirs = detect_stalls(ws, **kw), jax_detect(ws, **kw)
    assert ours == theirs
    tr, jtr = Tracer(), JaxTracer()
    for t in (tr, jtr):
        for i in range(len(p99s)):
            t.complete("commit", "group", i + 0.2, 0.1)
            t.complete(SPAN_CATEGORIES[i % 4], "x", i + 0.1, 0.05 * (i % 5))
        t.instant("shed", "insert", 3.5, count=2)
    assert attribute_stalls(ours, tr.events()) == \
        jax_attribute(theirs, jtr.events())
    assert attribute_stalls(ours, []) == jax_attribute(theirs, [])


def test_tracer_chrome_json_matches_jax(tmp_path):
    ours, theirs = Tracer(capacity=16), JaxTracer(capacity=16)
    for t in (ours, theirs):
        for i in range(40):
            t.complete(SPAN_CATEGORIES[i % len(SPAN_CATEGORIES)],
                       f"span{i}", i * 1e-3, 1.5e-4, lsn=i)
        t.instant("shed", "queue_full", 0.05, n=3)
        t.complete("no-such-category", "odd", 0.06, 1e-5)
    assert ours.to_chrome() == theirs.to_chrome()
    assert (len(ours), ours.dropped_events) == (16, 26)
    ours.save(str(tmp_path / "a.json"))
    theirs.save(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    obj = json.loads((tmp_path / "a.json").read_text())
    assert validate_chrome_trace(obj) == [] == jax_validate(obj)
    assert ours.spans("commit") == theirs.spans("commit")
    assert ours.categories() == theirs.categories()
    off = Tracer(enabled=False)
    off.complete("commit", "c", 0.0, 1.0)
    assert len(off) == 0


@pytest.mark.parametrize("obj", [
    [],
    {"traceEvents": 3},
    {"traceEvents": [{"ph": "X", "ts": "a", "name": 1},
                     {"ph": "i", "ts": 1.0, "name": "n", "s": "q"},
                     {"ph": "X", "ts": 1.0, "name": "n"}, 7]},
], ids=["not-a-dict", "not-a-list", "bad-events"])
def test_validate_chrome_trace_matches_jax(obj):
    assert validate_chrome_trace(obj) == jax_validate(obj) != []


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "bimodal"])
def test_latency_histogram_percentile_matches_jax(dist):
    """``workloads/driver.py``'s ``LatencyHistogram.percentile`` equals the JAX
    package's at every quantile, exact at 0 and 100, and its report block
    too."""
    from repro.workloads.driver import LatencyHistogram as JaxLatency
    from repro_torch.workloads.driver import LatencyHistogram

    xs = _samples(dist)
    ours, theirs = LatencyHistogram(), JaxLatency()
    ours.add(xs)
    theirs.add(xs)
    assert ours.count == theirs.count == len(xs)
    for q in (0.0, 1.0, 50.0, 90.0, 99.0, 99.9, 100.0):
        assert ours.percentile(q) == theirs.percentile(q)
    assert ours.percentile(0.0) == xs.min()
    assert ours.percentile(100.0) == xs.max()
    assert ours.to_dict() == theirs.to_dict()
