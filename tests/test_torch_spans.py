"""The device tier's spans on the CPU: one host clock for the index, its
engine and a wall-clock ensemble (shards born by a split included), the
units ``insert_batch`` runs under backpressure, each unit's kind and
depth, a hot-shard split's parts, and tracing that changes no state."""
import time

import numpy as np
import pytest
import torch

from repro_torch.core import torch_nbtree
from repro_torch.core.engine_api import OpBatch, make_engine
from repro_torch.obs.trace import Tracer

KEYS, VALS = np.uint64, np.int64
#: a two-shard range ensemble that splits its hot shard within a few
#: ``maintain(4)`` calls (``test_torch_shard.py``'s split shape)
SPLIT_KW = dict(shards=2, min_split_pairs=64, skew_factor=1.5, f=4, sigma=64,
                max_nodes=64, max_results=256)


def _timed(tracer, calls, fn, *args):
    """``fn(*args)`` with ``perf_counter()`` read around it; ``calls`` gets
    ``(before, after, the events it recorded)``."""
    n0 = len(tracer)
    t0 = time.perf_counter()
    out = fn(*args)
    t1 = time.perf_counter()
    calls.append((t0, t1, tracer.events()[n0:]))
    return out


def _depth(node) -> int:
    d = 0
    while node.parent is not None:
        d, node = d + 1, node.parent
    return d


def test_spans_share_the_host_clock_across_a_split():
    """Every span of the ensemble, its engines and their indexes, those of
    the two shards a split builds included, starts and ends inside the
    ``perf_counter()`` readings around the call that made it; the split's
    span holds its re-insert's backpressure units and its parts."""
    tr = Tracer(capacity=1 << 18)
    eng = make_engine("sharded:torch-nbtree", device="cpu", **SPLIT_KW)
    eng.attach_tracer(tr)
    calls = []
    _timed(tr, calls, eng.apply, OpBatch.inserts(
        np.arange(1, 201, dtype=KEYS), np.arange(200, dtype=VALS)))
    lo, _ = eng.partitioner.interval(1)
    extra = np.arange(lo, lo + 3000, dtype=KEYS)
    _timed(tr, calls, eng.apply, OpBatch.inserts(extra, extra.astype(VALS)))
    old = set(map(id, eng.shard_engines))
    hot_pairs = eng.shard_engines[1].count_live()
    for _ in range(64):
        if eng.n_splits:
            break
        _timed(tr, calls, eng.maintain, 4)
    assert eng.n_splits == 1
    born = [e for e in eng.shard_engines if id(e) not in old]
    assert len(born) == 2
    for _ in range(4):
        _timed(tr, calls, eng.maintain, 1)
    _timed(tr, calls, eng.apply, OpBatch.inserts(
        extra + np.uint64(5000), extra.astype(VALS)))
    assert tr.dropped_events == 0 and len(tr) == sum(len(c[2]) for c in calls)
    for t0, t1, events in calls:
        for e in events:
            assert e["ph"] == "X", e        # the wall tier records no instant
            assert t0 * 1e6 - 1e-3 <= e["ts"], e
            assert e["ts"] + e["dur"] <= t1 * 1e6 + 2e-3, e
    splits = tr.spans("shard_split")
    assert len(splits) == eng.n_splits == 1
    sp = splits[0]
    a = sp["args"]
    assert (a["shard"], a["n_shards"]) == (1, 3)
    assert a["left_pairs"] + a["right_pairs"] == hot_pairs
    parts = a["drain_s"] + a["extract_s"] + a["reinsert_s"]
    assert min(a["drain_s"], a["extract_s"], a["reinsert_s"]) >= 0
    assert parts * 1e6 <= sp["dur"] + 2e-3
    end = sp["ts"] + sp["dur"]
    inside = [e for e in tr.spans("cascade")
              if sp["ts"] <= e["ts"] and e["ts"] + e["dur"] <= end]
    assert inside and all(e["name"] == "backpressure_unit" for e in inside)
    # the re-insert's units ran in the born shards' indexes, on one clock
    # with the spans of the shards that were there before
    reinsert_from = sp["ts"] + (a["drain_s"] + a["extract_s"]) * 1e6
    assert all(e["ts"] >= reinsert_from - 1e-3 for e in inside)
    assert sum(e.idx.units_done for e in born) >= len(inside)
    assert {"dispatch", "flush_unit", "cascade", "shard_split"} <= \
        tr.categories()


def test_backpressure_spans_count_the_units_inside_apply():
    """One ``backpressure_unit`` span (category ``cascade``) for each unit
    ``apply`` runs, and none for the units of ``maintain``, which its
    ``flush_unit`` spans time; both carry the unit's kind and depth as the
    index ran it."""
    tr = Tracer(capacity=1 << 18)
    eng = make_engine("torch-nbtree", device="cpu", f=4, sigma=64,
                      max_nodes=64)
    eng.attach_tracer(tr)
    idx = eng.idx
    ran = []
    real_flush, real_upward, real_root = (idx._flush, idx._split_upward,
                                          idx._split_root_leaf)

    def flush(node):
        ran.append(("flush", _depth(node)))
        real_flush(node)

    def upward(node):
        ran.append(("split", _depth(node)))
        real_upward(node)

    def root_leaf():
        ran.append(("split", 0))
        real_root()

    idx._flush, idx._split_upward, idx._split_root_leaf = (flush, upward,
                                                           root_leaf)
    rng = np.random.default_rng(7)
    inside = 0
    for _ in range(24):
        keys = (rng.choice(1 << 20, 300, replace=False) + 1).astype(KEYS)
        u0, n0 = idx.units_done, len(tr)
        eng.apply(OpBatch.inserts(keys, keys.astype(VALS)))
        gained = idx.units_done - u0
        events = tr.events()[n0:]
        bp = [e for e in events if e["name"] == "backpressure_unit"]
        assert len(bp) == gained
        assert all(e["cat"] == "cascade" for e in bp)
        assert not [e for e in events if e["cat"] == "flush_unit"]
        inside += gained
        u0, n0 = idx.units_done, len(tr)
        eng.maintain(1)
        events = tr.events()[n0:]
        assert len([e for e in events if e["cat"] == "flush_unit"]) == \
            idx.units_done - u0
        assert not [e for e in events if e["name"] == "backpressure_unit"]
    assert inside > 0
    units = [(e["args"]["kind"], e["args"]["depth"]) for e in tr.events()
             if e["name"] in ("backpressure_unit", "maintain_unit")]
    assert units == ran
    assert {k for k, _ in units} == {"flush", "split"}
    assert max(d for _, d in units) >= 1


@pytest.mark.parametrize("name,kw", [
    ("torch-nbtree", dict(f=4, sigma=64, max_nodes=64)),
    ("torch-nbtree", dict(f=4, sigma=64, max_nodes=64, fused=False)),
    ("sharded:torch-nbtree", SPLIT_KW),
], ids=["fused", "eager", "sharded"])
def test_tracing_changes_no_count_and_no_table(name, kw):
    """The same op stream, traced and not: the same impl calls counted,
    the same units and the same tables, bit for bit."""
    engines = [make_engine(name, device="cpu", **kw) for _ in range(2)]
    tr = Tracer(capacity=1 << 18)
    engines[1].attach_tracer(tr)
    rng = np.random.default_rng(3)
    for eng in engines:
        eng.apply(OpBatch.inserts(np.arange(1, 201, dtype=KEYS),
                                  np.arange(200, dtype=VALS)))
    for t in range(12):
        keys = (rng.choice(1 << 16, 400, replace=False) + 1).astype(KEYS)
        for eng in engines:
            eng.apply(OpBatch.inserts(keys, np.full(400, t, VALS)))
            eng.apply(OpBatch.deletes(keys[:16]))
            eng.maintain(2)
    for eng in engines:
        eng.drain()
    plain, traced = engines
    assert len(tr.spans("dispatch")) > 0
    assert plain.stats().device_dispatches == traced.stats().device_dispatches
    shards = list(zip(getattr(plain, "shard_engines", (plain,)),
                      getattr(traced, "shard_engines", (traced,))))
    if name.startswith("sharded"):
        assert plain.n_splits == traced.n_splits == len(
            tr.spans("shard_split")) >= 1
    for p, q in shards:
        assert p.idx.units_done == q.idx.units_done
        for table in ("pivots", "children", "nchild", "run_keys",
                      "run_vals", "run_count", "bloom"):
            assert torch.equal(getattr(p.idx, table), getattr(q.idx, table))
    for a, b in zip(plain.dump_live(), traced.dump_live()):
        assert np.array_equal(a, b)


def test_guard_read_is_a_span_but_not_a_dispatch():
    """``_overflowing_child``'s count read (one big sorted batch at sigma
    64) records a ``dispatch`` span and stays out of ``dispatch_count``."""
    tr = Tracer(capacity=1 << 18)
    eng = make_engine("torch-nbtree", f=4, sigma=64, max_nodes=64,
                      device="cpu")
    eng.attach_tracer(tr)
    keys = np.arange(1, 4097, dtype=np.uint32) * 5
    d0 = eng.idx.dispatch_count
    eng.apply(OpBatch.inserts(keys, np.arange(4096, dtype=np.int32)))
    eng.drain()
    spans = tr.spans("dispatch")
    reads = [e for e in spans if e["name"] == torch_nbtree._flush_lens.__name__]
    assert reads, "the guard never read: the case no longer covers it"
    assert len(spans) - len(reads) == eng.idx.dispatch_count - d0
