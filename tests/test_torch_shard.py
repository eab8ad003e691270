"""The port's sharded layer (``repro_torch.shard``, ``distributed``) vs the
JAX package's, on the CPU.

* Partitioners, the debt scheduler, the heartbeat monitor and the
  straggler detector equal the JAX package's bit for bit on seeded inputs.
* On the sim-clock tiers a sharded run is a pure function of (stream,
  config), so the port's reports equal the JAX package's field for field:
  closed and open multi-stream drives over ``sharded:nbtree`` (range and
  hash placement) and hot-shard splits over ``sharded:nbtree`` and
  ``sharded:lsm`` (every stats snapshot along the way).
* The 4-shard delete-churn conformance stream through every tier of the
  port's ``FIVE_TIERS`` against a sorted-dict oracle.
* The device tier: ``sharded:torch-nbtree`` (plain versions on the CPU)
  against ``sharded:jax-nbtree`` across a hot-shard split, by answers and
  by each shard's ``dump_live`` (maintenance order is wall-clock driven on
  both, so the tables are not compared); a split reads a device shard
  without the capped RANGE op.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

import repro.core.jax_nbtree as jax_nbtree
from repro.core.engine_api import OpBatch as JaxOpBatch
from repro.core.engine_api import make_engine as make_jax_engine
from repro.distributed.fault_tolerance import \
    HeartbeatMonitor as JaxHeartbeatMonitor
from repro.distributed.fault_tolerance import \
    StragglerDetector as JaxStragglerDetector
from repro.shard import DebtScheduler as JaxDebtScheduler
from repro.shard import HashPartitioner as JaxHashPartitioner
from repro.shard import RangePartitioner as JaxRangePartitioner
from repro.workloads import make_workload as make_jax_workload
from repro.workloads.driver import run_multi_workload as jax_run_multi
from repro.workloads.driver import run_open_multi_workload as jax_run_open_multi
from repro.workloads.driver import run_workload as jax_run_workload
from repro_torch.core.engine_api import (FIVE_TIERS, OpBatch, OpKind,
                                         make_engine)
from repro_torch.core.torch_nbtree import NBTreeIndex
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     StragglerDetector)
from repro_torch.shard import (DebtScheduler, HashPartitioner,
                               RangePartitioner, ShardedEngine)
from repro_torch.workloads import make_workload
from repro_torch.workloads.driver import (run_multi_workload,
                                          run_open_multi_workload,
                                          run_workload)

KEYS = np.uint64
VALS = np.int64

#: small per-shard configurations (the JAX package's sharded tests')
CONFIGS = {
    "nbtree": dict(f=3, sigma=128),
    "lsm": dict(mem_pairs=128),
    "btree": {},
    "bepsilon": dict(node_bytes=1 << 14, cached_levels=1),
    "torch-nbtree": dict(f=4, sigma=128, max_nodes=64, device="cpu"),
}


@pytest.fixture
def jax_reads_op_by_op(monkeypatch):
    """The JAX index's read paths under ``jax.disable_jit()``: the same XLA
    operations, op by op, without a minute-long compile per shape."""
    for name in ("query_batch", "range_query_batch"):
        real = getattr(jax_nbtree.NBTreeIndex, name)

        def op_by_op(self, *a, _real=real, **k):
            with jax.disable_jit():
                return _real(self, *a, **k)

        monkeypatch.setattr(jax_nbtree.NBTreeIndex, name, op_by_op)


def _canon(report) -> str:
    return json.dumps(report, sort_keys=True, default=float)


# ------------------------------------------------------------- partitioners
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_range_partitioner_matches_jax(seed):
    rng = np.random.default_rng(seed)
    sample = rng.integers(1, 1 << 31, 500 + 300 * seed, dtype=np.uint64)
    sample[::7] = sample[0]                     # duplicates collapse
    probe = np.concatenate([rng.integers(0, 1 << 32, 400, dtype=np.uint64),
                            np.array([0, 2**64 - 1], KEYS)])
    for n in (1, 2, 5, 16):
        ours = RangePartitioner.from_sample(sample, n)
        theirs = JaxRangePartitioner.from_sample(sample, n)
        assert ours.pivots.dtype == theirs.pivots.dtype
        assert np.array_equal(ours.pivots, theirs.pivots)
        assert np.array_equal(ours.shard_of(probe), theirs.shard_of(probe))
        for lo, hi in rng.integers(0, 1 << 31, (20, 2)).tolist():
            assert ours.shards_for_range(lo, hi) == \
                theirs.shards_for_range(lo, hi)
        for sid in range(ours.n_shards):
            assert ours.interval(sid) == theirs.interval(sid)
        lo, hi = ours.interval(ours.n_shards - 1)
        cut = lo + 1 + int(rng.integers(0, 1000))
        ours.split(ours.n_shards - 1, cut)
        theirs.split(theirs.n_shards - 1, cut)
        assert np.array_equal(ours.pivots, theirs.pivots)
    for n, hi in ((1, 10), (4, 1 << 20), (7, 1000)):
        assert np.array_equal(RangePartitioner.even(n, hi).pivots,
                              JaxRangePartitioner.even(n, hi).pivots)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_hash_partitioner_matches_jax(n):
    keys = np.random.default_rng(n).integers(0, 2**63, 2000, dtype=np.uint64)
    ours, theirs = HashPartitioner(n), JaxHashPartitioner(n)
    got, want = ours.shard_of(keys), theirs.shard_of(keys)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert ours.shards_for_range(5, 9) == theirs.shards_for_range(5, 9)
    assert ours.shards_for_range(9, 5) == range(0)
    assert not ours.can_split and np.bincount(got, minlength=n).min() > 0


# ---------------------------------------------------------------- scheduling
@pytest.mark.parametrize("boost", [1.0, 2.0])
def test_debt_scheduler_matches_jax(boost):
    rng = np.random.default_rng(int(boost * 10))
    ours, theirs = DebtScheduler(boost), JaxDebtScheduler(boost)
    for _ in range(300):
        n = int(rng.integers(1, 7))
        debts = rng.integers(0, 6, n).tolist()
        slow = tuple(np.flatnonzero(rng.random(n) < 0.3).tolist())
        budget = int(rng.integers(-1, 12))
        a = ours.allocate(debts, budget, stragglers=slow)
        b = theirs.allocate(debts, budget, stragglers=slow)
        assert a == b
        assert sum(a) == min(max(budget, 0), sum(debts))
        assert ours._rr == theirs._rr


def test_heartbeat_and_straggler_detector_match_jax():
    rng = np.random.default_rng(3)
    hosts = [f"g{g}/n{k}" for g in range(3) for k in range(2)]
    ours = HeartbeatMonitor(hosts, timeout=0.005)
    theirs = JaxHeartbeatMonitor(hosts, timeout=0.005)
    t = 0.0
    for step in range(400):
        t += float(rng.exponential(0.001))
        for h in hosts:
            if rng.random() < 0.8:
                assert ours.beat(h, t) == theirs.beat(h, t)
        if step % 97 == 50:
            h = hosts[int(rng.integers(len(hosts)))]
            ours.revive(h, t)
            theirs.revive(h, t)
        assert ours.advance(t) == theirs.advance(t)
    assert ours.dead == theirs.dead and ours.last_beat == theirs.last_beat
    ours.forget(hosts[0])
    theirs.forget(hosts[0])
    assert ours.last_beat == theirs.last_beat
    steps = HeartbeatMonitor([0, 1], timeout_steps=3)
    steps.beat(0, 2)
    assert steps.advance(4) == [1]

    sd, jsd = StragglerDetector(list(range(8))), \
        JaxStragglerDetector(list(range(8)))
    for i in range(200):
        host, sec = i % 8, float(rng.lognormal(-6, 0.1)) * (5 if i % 8 == 3
                                                             else 1)
        sd.record(host, sec)
        jsd.record(host, sec)
        assert sd.stragglers() == jsd.stragglers()
    assert sd.stragglers() == [3] and sd.ewma == jsd.ewma


# ------------------------------------------------- sim tiers: field for field
def _streams(port: bool, n_ops=384):
    mk = make_workload if port else make_jax_workload
    return [mk(m, n_ops=n_ops, preload=128, key_space=1 << 14,
               batch_size=64, seed=i)
            for i, m in enumerate(("insert-heavy", "delete-churn",
                                   "ycsb-e"))]


@pytest.mark.parametrize("partition", ["range", "hash"])
@pytest.mark.parametrize("loop", ["closed", "open"])
def test_sharded_multi_stream_reports_equal_jax(loop, partition):
    reps = []
    for port in (True, False):
        eng = (make_engine if port else make_jax_engine)(
            "sharded:nbtree", shards=3, partition=partition, f=3, sigma=64)
        wls = _streams(port)
        if loop == "closed":
            run = run_multi_workload if port else jax_run_multi
            reps.append(run(eng, wls, maintain_budget=2))
        else:
            run = run_open_multi_workload if port else jax_run_open_multi
            reps.append(run(eng, wls, arrival="poisson", rate=30_000.0,
                            weights=[2.0, 1.0, 1.0], maintain_budget=2))
    assert _canon(reps[0]) == _canon(reps[1])
    st = reps[0]["stats"]
    assert st["engine"] == "sharded:nbtree" and st["shards"] >= 3
    assert st["total_pairs"] > 0 and st["pending_debt"] == 0


@pytest.mark.parametrize("base", ["nbtree", "lsm"])
def test_hot_shard_split_sim_stats_equal_jax(base):
    """A moving hotspot forces splits: every answer and every stats
    snapshot equals the JAX package's, and stays monotone across them."""
    kw = dict(key_space=1 << 14, n_ops=768, batch_size=128, preload=256,
              seed=5)
    cfg = {"nbtree": dict(f=3, sigma=128), "lsm": dict(mem_pairs=128)}[base]
    ours = make_engine(f"sharded:{base}", shards=2, min_split_pairs=96,
                       skew_factor=1.5, **cfg)
    theirs = make_jax_engine(f"sharded:{base}", shards=2, min_split_pairs=96,
                             skew_factor=1.5, **cfg)
    wl, jwl = make_workload("hotspot-shift", **kw), \
        make_jax_workload("hotspot-shift", **kw)
    ours.apply(wl.preload_batch())
    theirs.apply(jwl.preload_batch())
    last_io = 0.0
    for b, jb in zip(wl.batches(), jwl.batches()):
        r, jr = ours.apply(b), theirs.apply(jb)
        assert np.array_equal(r.found, jr.found)
        assert np.array_equal(r.values, jr.values)
        assert np.array_equal(r.latency_s, jr.latency_s)
        for i in np.flatnonzero(b.kinds == int(OpKind.RANGE)):
            assert np.array_equal(r.range_hits[i][0], jr.range_hits[i][0])
            assert np.array_equal(r.range_hits[i][1], jr.range_hits[i][1])
        assert ours.maintain(4) == theirs.maintain(4)
        st, jst = ours.stats(), theirs.stats()
        assert dataclasses.asdict(st) == dataclasses.asdict(jst)
        assert st.io_time_s >= last_io
        last_io = st.io_time_s
    assert ours.n_splits == theirs.n_splits > 0
    assert np.array_equal(ours.partitioner.pivots, theirs.partitioner.pivots)
    rep = run_workload(make_engine(f"sharded:{base}", shards=2, **cfg),
                       make_workload("hotspot-shift", **kw))
    jrep = jax_run_workload(make_jax_engine(f"sharded:{base}", shards=2,
                                            **cfg),
                            make_jax_workload("hotspot-shift", **kw))
    assert _canon(rep) == _canon(jrep)


# ------------------------------------------------- 4-shard conformance suite
def _oracle_stream():
    wl = make_workload("delete-churn", key_space=4096, n_ops=320,
                       batch_size=64, preload=192, range_selectivity=0.01,
                       seed=11)
    pre = wl.preload_batch()
    batches = list(wl.batches())
    model = dict(zip(pre.keys.tolist(), pre.vals.tolist()))
    expected = []
    for b in batches:
        exp = []
        for i in range(len(b)):
            kind, k = OpKind(int(b.kinds[i])), int(b.keys[i])
            if kind is OpKind.INSERT:
                model[k] = int(b.vals[i])
                exp.append(None)
            elif kind is OpKind.DELETE:
                model.pop(k, None)
                exp.append(None)
            elif kind is OpKind.QUERY:
                exp.append(model.get(k))
            else:
                ks = sorted(x for x in model if k <= x <= int(b.his[i]))
                exp.append((ks, [model[x] for x in ks]))
        expected.append(exp)
    return pre, batches, expected, len(model)


@pytest.fixture(scope="module")
def churn_stream():
    return _oracle_stream()


@pytest.mark.parametrize("name", FIVE_TIERS)
def test_sharded_conformance(name, churn_stream):
    pre, batches, expected, n_live = churn_stream
    eng = make_engine(f"sharded:{name}", shards=4, min_split_pairs=64,
                      skew_factor=2.0, **CONFIGS[name])
    eng.apply(pre)
    eng.drain()
    last_io = eng.io_time_s()
    for bi, (b, exp) in enumerate(zip(batches, expected)):
        res = eng.apply(b)
        assert not res.range_truncated.any(), (name, bi)
        for i in range(len(b)):
            kind = OpKind(int(b.kinds[i]))
            if kind is OpKind.QUERY:
                assert bool(res.found[i]) == (exp[i] is not None), (bi, i)
                if exp[i] is not None:
                    assert int(res.values[i]) == exp[i], (bi, i)
            elif kind is OpKind.RANGE:
                rk, rv = res.range_hits[i]
                assert rk.tolist() == exp[i][0], (bi, i)
                assert rv.tolist() == exp[i][1], (bi, i)
        eng.maintain(2)
        assert eng.io_time_s() >= last_io, (name, bi)
        last_io = eng.io_time_s()
    eng.drain()
    s = eng.stats()
    assert s.total_pairs == n_live and s.pending_debt == 0
    assert s.physical_pairs >= s.total_pairs
    assert s.shards >= 4 and len(s.shard_debt) == s.shards
    assert s.n_inserts + s.n_deletes + s.n_queries + s.n_ranges \
        == len(pre) + sum(len(b) for b in batches)
    assert s.clock == ("wall" if name == "torch-nbtree" else "sim")


@pytest.mark.parametrize("name", ["nbtree", "torch-nbtree"])
def test_sharded_matches_unsharded_interleaved(name):
    """Ungrouped batches: ranges spanning shards interleaved with writes."""
    rng = np.random.default_rng(7)
    sh = make_engine(f"sharded:{name}", shards=4, **CONFIGS[name])
    ref = make_engine(name, **CONFIGS[name])
    keys = rng.permutation(np.arange(1, 801, dtype=KEYS))
    pre = OpBatch.inserts(keys, np.arange(1, 801, dtype=VALS))
    sh.apply(pre)
    ref.apply(pre)
    for step in range(6):
        n = 48
        kinds = rng.integers(0, 4, n).astype(np.int8)
        ks = rng.integers(1, 1000, n, dtype=KEYS)
        vals = np.where(kinds == int(OpKind.INSERT),
                        np.arange(n, dtype=VALS) + 1000 * step, 0)
        his = np.where(kinds == int(OpKind.RANGE), ks + KEYS(120),
                       0).astype(KEYS)
        b = OpBatch(kinds, ks, vals, his)
        r1, r2 = sh.apply(b), ref.apply(b)
        assert r1.found.tolist() == r2.found.tolist(), step
        assert r1.values.tolist() == r2.values.tolist(), step
        for i in np.flatnonzero(kinds == int(OpKind.RANGE)):
            assert r1.range_hits[i][0].tolist() \
                == r2.range_hits[i][0].tolist(), (step, i)
            assert r1.range_hits[i][1].tolist() \
                == r2.range_hits[i][1].tolist(), (step, i)
        sh.maintain(2)
        ref.maintain(2)
    sh.drain()
    ref.drain()
    for a, b in zip(sh.dump_live(), ref.dump_live()):
        assert np.array_equal(a, b)


def test_sharded_registry_empty_batches_and_clock():
    with pytest.raises(KeyError):
        make_engine("sharded:no-such-base")
    eng = make_engine("sharded:torch-nbtree", shards=4, device="cpu")
    assert isinstance(eng, ShardedEngine) and eng.name == \
        "sharded:torch-nbtree"
    # the ensemble knows its clock before the first batch (the JAX
    # package's reports "sim" until then)
    assert eng.stats().clock == "wall"
    assert make_jax_engine("sharded:jax-nbtree", shards=4).stats().clock \
        == "sim"
    assert len(eng.apply(OpBatch.empty()).kinds) == 0
    res = eng.apply(OpBatch.queries([5, 10]))   # a query-only bootstrap
    assert not res.found.any()
    assert eng.apply(OpBatch.ranges([1], [100])).range_hits[0][0].tolist() \
        == []
    lsm = make_engine("sharded:lsm", shards=2, mem_pairs=64)
    lsm.apply(OpBatch.inserts(np.arange(1, 65, dtype=KEYS),
                              np.arange(64, dtype=VALS)))
    s = lsm.stats()
    assert s.shards == 2 and len(s.shard_debt) == 2
    assert s.n_inserts == 64 and s.total_pairs == 64 and s.clock == "sim"


# ------------------------------------------------------------- device tier
def _hot_batch(rng, lo, hi, n, base, n_del, n_q):
    """Inserts concentrated in [lo, hi) plus deletes and point reads of
    the live keys, grouped by kind."""
    ins = rng.integers(lo, hi, n, dtype=KEYS)
    dels = rng.choice(ins, n_del, replace=False)
    q = np.concatenate([rng.choice(ins, n_q // 2),
                        rng.integers(1, 4000, n_q - n_q // 2, dtype=KEYS)])
    kinds = np.concatenate([np.full(n, int(OpKind.INSERT), np.int8),
                            np.full(n_del, int(OpKind.DELETE), np.int8),
                            np.full(len(q), int(OpKind.QUERY), np.int8)])
    keys = np.concatenate([ins, dels, q])
    vals = np.concatenate([np.arange(base, base + n, dtype=VALS),
                           np.zeros(n_del + len(q), VALS)])
    return kinds, keys, vals


def _same_shards(ours, theirs):
    assert ours.n_splits == theirs.n_splits
    assert np.array_equal(ours.partitioner.pivots, theirs.partitioner.pivots)
    for a, b in zip(ours.shard_engines, theirs.shard_engines, strict=True):
        (ak, av), (bk, bv) = a.dump_live(), b.dump_live()
        assert np.array_equal(ak, bk) and np.array_equal(av, bv)


def test_device_sharded_matches_jax_across_hot_split(jax_reads_op_by_op):
    """``sharded:torch-nbtree`` vs ``sharded:jax-nbtree`` at f=4, sigma 64:
    a preload, then a hot batch into one shard; the split decision reads
    host counters only, so both split at the same pivot.  Answers and
    each shard's live pairs must agree before and after the split."""
    rng = np.random.default_rng(4)
    kw = dict(shards=2, min_split_pairs=96, skew_factor=1.5, f=4, sigma=64,
              max_nodes=64)
    ours = make_engine("sharded:torch-nbtree", device="cpu", **kw)
    theirs = make_jax_engine("sharded:jax-nbtree", **kw)
    pre = (rng.choice(3999, 240, replace=False) + 1).astype(KEYS)
    for e, B in ((ours, OpBatch), (theirs, JaxOpBatch)):
        e.apply(B.inserts(pre, pre.astype(VALS)))
        e.maintain(4)
    _same_shards(ours, theirs)
    lo, hi = ours.partitioner.interval(1)
    kinds, keys, vals = _hot_batch(rng, lo, min(hi, 4000), 200, 10_000,
                                   20, 16)
    r = ours.apply(OpBatch(kinds, keys, vals, np.zeros(len(keys), KEYS)))
    jr = theirs.apply(JaxOpBatch(kinds, keys, vals,
                                 np.zeros(len(keys), KEYS)))
    assert np.array_equal(r.found, jr.found) and r.found.any()
    assert np.array_equal(r.values, jr.values)
    ours.maintain(4)
    theirs.maintain(4)
    assert ours.n_splits == 1, "the hot batch must force a split"
    _same_shards(ours, theirs)
    # reads fan out across the new layout: point reads on both sides of
    # the new pivot, one range over every shard
    q = np.concatenate([pre[:8], keys[:8]])
    r = ours.apply(OpBatch.concat([OpBatch.queries(q),
                                  OpBatch.ranges([1], [4000])]))
    jr = theirs.apply(JaxOpBatch.concat([JaxOpBatch.queries(q),
                                         JaxOpBatch.ranges([1], [4000])]))
    live_k, live_v = ours.dump_live()
    pos = np.searchsorted(live_k, q).clip(max=len(live_k) - 1)
    assert np.array_equal(r.found[:len(q)], live_k[pos] == q)
    assert r.found.any()
    assert np.array_equal(r.found, jr.found)
    assert np.array_equal(r.values, jr.values)
    assert np.array_equal(r.range_hits[-1][0], jr.range_hits[-1][0])
    assert np.array_equal(r.range_hits[-1][0], live_k)
    assert np.array_equal(r.range_hits[-1][1], live_v)


def test_device_split_reads_the_shard_without_a_capped_range(
        monkeypatch, jax_reads_op_by_op):
    """The split of a device shard above ``max_results`` runs no range
    descent and leaves every cap where it was, with the same halves as the
    JAX package's split, whose extraction reruns its descent at doubled
    caps until the shard fits and keeps the last cap (1,024 here; above
    2^20 live pairs it raises)."""
    calls = {"port": [], "jax": []}
    for key, cls in (("port", NBTreeIndex), ("jax", jax_nbtree.NBTreeIndex)):
        real = cls.range_query_batch

        def counting(self, *a, _real=real, _log=calls[key], **k):
            _log.append(k.get("max_results"))
            return _real(self, *a, **k)

        monkeypatch.setattr(cls, "range_query_batch", counting)
    kw = dict(shards=2, min_split_pairs=64, skew_factor=1.5, f=4, sigma=64,
              max_nodes=64, max_results=256)
    ours = make_engine("sharded:torch-nbtree", device="cpu", **kw)
    theirs = make_jax_engine("sharded:jax-nbtree", **kw)
    hot = {}
    for name, e, B in (("port", ours, OpBatch), ("jax", theirs, JaxOpBatch)):
        e.apply(B.inserts(np.arange(1, 201, dtype=KEYS),
                          np.arange(200, dtype=VALS)))
        hot[name] = e.shard_engines[1]
        lo, _ = e.partitioner.interval(1)
        extra = np.arange(lo, lo + 600, dtype=KEYS)
        e.apply(B.inserts(extra, extra.astype(VALS)))
        for _ in range(64):
            if e.n_splits:
                break
            e.maintain(4)
        assert e.n_splits == 1 and hot[name] not in e.shard_engines
    assert calls["port"] == [], "the split ran a range descent"
    assert hot["port"]._max_results == 256
    assert all(e._max_results == 256 for e in ours.shard_engines)
    assert calls["jax"] == [256, 512, 1024]
    assert hot["jax"]._max_results == 1024
    _same_shards(ours, theirs)
    assert sum(len(e.dump_live()[0]) for e in ours.shard_engines[1:]) == 600
    # a sim-clock shard still pays for its extraction as a charged RANGE
    sim = make_engine("sharded:nbtree", shards=2, min_split_pairs=64,
                      skew_factor=1.5, f=3, sigma=64)
    sim.apply(OpBatch.inserts(np.arange(1, 201, dtype=KEYS),
                              np.arange(200, dtype=VALS)))
    lo, _ = sim.partitioner.interval(1)
    io = sim.io_time_s()
    sim.apply(OpBatch.inserts(np.arange(lo, lo + 600, dtype=KEYS),
                              np.arange(600, dtype=VALS)))
    for _ in range(64):
        if sim.n_splits:
            break
        sim.maintain(4)
    assert sim.n_splits == 1 and sim.stats().n_ranges == 0
    assert sim._retired[0] > io
