"""The port's multi-tenant front door (``repro_torch.tenancy``,
``workloads/tenants.py``) vs the JAX package's, on the CPU.

* Namespace packing, the weighted-fair queue and the tenant scenarios equal
  the JAX package's bit for bit.
* On the sim tiers (``nbtree``, ``sharded:nbtree``) a multi-tenant run is
  a pure function of (traces, configs), so the port's report equals the
  JAX package's field for field, fair and unfair, with a WAL and the obs
  layer on; the WAL segments are byte-equal and each package recovers the
  other's namespaces.
* Snapshots pinned at commit boundaries mid-run, while cascades proceed,
  equal a sorted-dict oracle frozen at their watermark on the sim and the
  device tiers, sharded or not; a durable run killed mid-flight recovers
  every namespace (``recover_namespace``) to its acked prefix.
"""
import json

import numpy as np
import pytest

from repro.core.engine_api import make_engine as make_jax_engine
from repro.ingest import DurabilityConfig as JaxDurability
from repro.ingest import FrontendConfig as JaxFrontendConfig
from repro.obs import ObsConfig as JaxObsConfig
from repro.tenancy import NamespaceMap as JaxNamespaceMap
from repro.tenancy import WeightedFairQueue as JaxWFQ
from repro.tenancy import recover_namespace as jax_recover_namespace
from repro.tenancy import run_multi_tenant as jax_run_multi_tenant
from repro.workloads.tenants import build_scenario as jax_build_scenario
from repro_torch.core.engine_api import OpBatch, OpKind, make_engine
from repro_torch.ingest import DurabilityConfig, FrontendConfig
from repro_torch.obs import ObsConfig
from repro_torch.tenancy import (MultiTenantFrontend, NamespaceMap,
                                 SnapshotManager, TenantConfig,
                                 WeightedFairQueue, recover_namespace,
                                 run_multi_tenant)
from repro_torch.wal import CrashPoint, FaultInjector, SimulatedCrash, recover
from repro_torch.workloads.driver import main as driver_main
from repro_torch.workloads.tenants import (SCENARIOS, TenantStream,
                                           build_scenario, build_streams)

KEYS = np.uint64
VALS = np.int64


# ---------------------------------------------------------------- namespaces
@pytest.mark.parametrize("bits", [1, 4, 9])
def test_namespace_matches_jax(bits):
    ours, theirs = NamespaceMap(bits), JaxNamespaceMap(bits)
    assert ours.describe() == theirs.describe()
    rng = np.random.default_rng(bits)
    for tid in (0, ours.max_tenants - 1):
        local = rng.integers(1, ours.max_local_key + 1, 300).astype(KEYS)
        a, b = ours.encode(tid, local), theirs.encode(tid, local)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert int(a.max()) < (1 << 31)
        for x, y in zip(ours.decode(a), theirs.decode(a)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert ours.tenant_interval(tid) == theirs.tenant_interval(tid)
    b = OpBatch.concat([OpBatch.inserts([7], [70]),
                        OpBatch.ranges([10, 20], [15, 25])])
    enc = ours.encode_batch(ours.max_tenants - 1, b)
    lo, _ = ours.tenant_interval(ours.max_tenants - 1)
    assert enc.keys.tolist() == [lo + 6, lo + 9, lo + 19]
    assert enc.his.tolist() == [0, lo + 14, lo + 24]
    with pytest.raises(AssertionError):
        ours.encode(ours.max_tenants, [1])
    with pytest.raises(AssertionError):
        ours.encode(0, [0])


# ----------------------------------------------------------------- fair queue
@pytest.mark.parametrize("seed", [0, 1])
def test_fair_queue_matches_jax(seed):
    """Random offers and takes: the same items leave in the same order,
    with the same per-tenant ledger, under DRR's mid-visit resume."""
    rng = np.random.default_rng(seed)
    ours, theirs = WeightedFairQueue(quantum=8), JaxWFQ(quantum=8)
    for tid, w, mq in ((0, 3.0, 64), (2, 1.0, 16), (5, 0.5, 200)):
        ours.add_tenant(tid, weight=w, max_queue=mq)
        theirs.add_tenant(tid, weight=w, max_queue=mq)
    item = 0
    for _ in range(400):
        for _ in range(int(rng.integers(0, 12))):
            tid = int(rng.choice([0, 2, 5], p=[0.6, 0.3, 0.1]))
            assert ours.offer(tid, item) == theirs.offer(tid, item)
            item += 1
        n = int(rng.integers(0, 10))
        assert ours.take(n) == theirs.take(n)
        assert ours.heads() == theirs.heads()
        assert ours.backlog() == theirs.backlog()
    assert ours.stats() == theirs.stats()
    assert ours.stats()["2"]["shed"] > 0


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenarios_match_jax(name):
    kw = {"noisy-neighbor": dict(n_ops=300, aggressor_rate=20_000.0),
          "mixed-oltp": dict(n_ops=300, base_rate=5000.0)}[name]
    tenants, traces = build_scenario(name, seed=3, **kw)
    jt, jtr = jax_build_scenario(name, seed=3, **kw)
    assert [t.label for t in tenants] == [t.label for t in jt]
    assert [(t.tenant_id, t.weight, t.max_queue, t.slo_p999_s)
            for t in tenants] == [(t.tenant_id, t.weight, t.max_queue,
                                   t.slo_p999_s) for t in jt]
    assert sorted(traces) == sorted(jtr)
    for tid, tr in traces.items():
        other = jtr[tid]
        assert np.array_equal(tr.t_arrive, other.t_arrive)
        for f in ("kinds", "keys", "vals", "his"):
            assert np.array_equal(getattr(tr.ops, f), getattr(other.ops, f))
            assert np.array_equal(getattr(tr.preload, f),
                                  getattr(other.preload, f))
        assert tr.arrival == other.arrival


# --------------------------------------------------- sim tiers: field for field
def _mt_report(port, engine_name, fair, tmp_path):
    d = tmp_path / ("port" if port else "jax")
    tenants, traces = (build_scenario if port else jax_build_scenario)(
        "noisy-neighbor", seed=4, n_ops=300, victim_rate=2000.0,
        aggressor_rate=30_000.0, aggressor_queue=64)
    eng = (make_engine if port else make_jax_engine)(engine_name, f=3,
                                                     sigma=64)
    cfg = (FrontendConfig if port else JaxFrontendConfig)(
        max_queue=256, commit_ops=16, linger_s=5e-4)
    dur = (DurabilityConfig if port else JaxDurability)(
        str(d), segment_bytes=4096, checkpoint_every_commits=16)
    obs = (ObsConfig if port else JaxObsConfig)(
        window_s=0.01, trace_path=str(tmp_path / f"{port}.trace.json"))
    rep = (run_multi_tenant if port else jax_run_multi_tenant)(
        eng, tenants, traces, config=cfg, durability=dur, fair=fair,
        obs=obs)
    ol = rep["open_loop"]
    ol["durability"]["config"]["directory"] = "<dir>"
    ol["obs"]["trace"]["path"] = "<path>"
    return json.dumps(rep, sort_keys=True, default=float), rep, d


@pytest.mark.parametrize("fair", [True, False], ids=["fair", "unfair"])
@pytest.mark.parametrize("engine_name", ["nbtree", "sharded:nbtree"])
def test_multi_tenant_report_equals_jax(tmp_path, engine_name, fair):
    ours, rep, d = _mt_report(True, engine_name, fair, tmp_path)
    theirs, _, jd = _mt_report(False, engine_name, fair, tmp_path)
    assert ours == theirs
    ol = rep["open_loop"]
    assert ol["fair"] is fair and ol["service_model"] == "charged"
    assert ol["admission"]["2"]["shed"] > 0
    if not fair:
        assert ol["admission"]["0"]["shed"] + ol["admission"]["1"]["shed"] \
            > 0, "the shared FIFO sheds the victims too"
    assert ol["durability"]["checkpoints"]["taken"] > 1
    # the same bytes on disk, and each package recovers the other's log
    for sub in ("wal", "checkpoints"):
        files = sorted(p.relative_to(d / sub) for p in (d / sub).rglob("*")
                       if p.is_file())
        assert files
        for rel in files:
            assert (d / sub / rel).read_bytes() == \
                (jd / sub / rel).read_bytes(), rel
    for tid in (0, 2):
        a = recover_namespace(str(jd), lambda: make_engine("nbtree", f=3,
                                                           sigma=64), tid)
        b = jax_recover_namespace(str(d), lambda: make_jax_engine(
            "nbtree", f=3, sigma=64), tid)
        for x, y in zip(a.engine.dump_live(), b.engine.dump_live()):
            assert np.array_equal(x, y)
        assert len(a.engine.dump_live()[0]) == \
            rep["open_loop"]["tenants"][str(tid)]["live_pairs"]


# ------------------------------------------------- snapshots mid-cascade
def _oracle_from_acked(preloads, acked):
    """Sorted-dict ground truth over encoded keys: preload + acked ops."""
    d = {}
    for b in preloads:
        d.update(zip(b.keys.tolist(), b.vals.tolist()))
    for _lsn, kinds, keys, vals in acked:
        for kk, k, v in zip(kinds.tolist(), keys.tolist(), vals.tolist()):
            if kk == int(OpKind.INSERT):
                d[int(k)] = int(v)
            else:
                d.pop(int(k), None)
    return d


def _scoped(d, interval):
    lo, hi = interval
    return sorted((k, v) for k, v in d.items() if lo <= k <= hi)


ENGINES = {
    "nbtree": dict(f=3, sigma=64),
    "sharded:nbtree": dict(shards=3, f=3, sigma=64),
    "torch-nbtree": dict(f=4, sigma=64, max_nodes=128, device="cpu"),
    "sharded:torch-nbtree": dict(shards=3, f=4, sigma=64, max_nodes=64,
                                 device="cpu"),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_snapshot_differential_vs_oracle_mid_cascade(tmp_path, name):
    """Pin whole-keyspace and one-tenant views at commit boundaries mid-run,
    let ingest and cascades proceed, then hold every view against an
    oracle frozen at its own watermark."""
    ns = NamespaceMap()
    streams = [
        TenantStream(tenant=TenantConfig(0, weight=2.0), mix="delete-churn",
                     n_ops=600, preload=128, key_space=1 << 14,
                     arrival={"process": "poisson", "rate": 50_000.0}),
        TenantStream(tenant=TenantConfig(1), mix="insert-heavy",
                     n_ops=600, preload=128, key_space=1 << 14,
                     arrival={"process": "poisson", "rate": 50_000.0}),
    ]
    tenants, traces = build_streams(streams, seed=3)
    eng = make_engine(name, **ENGINES[name])
    fe = MultiTenantFrontend(
        eng, tenants, FrontendConfig(max_queue=4096, commit_ops=32),
        durability=DurabilityConfig(str(tmp_path)), namespace=ns)
    pinned = []

    def on_commit(front, _t):
        if front._n_commits % 7 == 3 and len(pinned) < 8:
            pre = [ns.encode_batch(t, traces[t].preload) for t in traces]
            oracle = _oracle_from_acked(pre, front.acked)
            pinned.append((front.pin_snapshot(), oracle, None))
            pinned.append((front.pin_snapshot(tenant_id=0), oracle,
                           ns.tenant_interval(0)))

    rep = fe.run(traces, on_commit=on_commit)
    assert len(pinned) == 8 and rep["snapshots"]["pins"] == 8
    assert rep["service_model"] == ("virtual" if "torch" in name
                                    else "charged")
    assert eng.stats().maintain_units > 0 or "torch" not in name
    for snap, oracle, interval in pinned:
        want = _scoped(oracle, interval) if interval else \
            sorted(oracle.items())
        assert snap.keys.tolist() == [k for k, _ in want]
        assert snap.vals.tolist() == [v for _, v in want]
        probe = snap.keys[:8]
        found, vals = snap.query(probe)
        assert found.all()
        assert vals.tolist() == [oracle[int(k)] for k in probe]
    # the engine moved on after every pin
    assert len(eng.dump_live()[0]) != len(pinned[0][0])


def test_snapshot_manager_freezes_the_view():
    eng = make_engine("torch-nbtree", f=4, sigma=64, max_nodes=64,
                      device="cpu")
    keys = np.arange(10, 200, 2, dtype=KEYS)
    eng.apply(OpBatch.inserts(keys, keys.astype(VALS)))
    sm = SnapshotManager(eng)
    snap = sm.pin(watermark_lsn=1)
    eng.apply(OpBatch.deletes(keys[:50]))
    eng.apply(OpBatch.inserts(np.array([11, 13], KEYS),
                              np.array([1, 2], VALS)))
    eng.drain()
    found, vals = snap.query(np.array([10, 11, 12, 13], KEYS))
    assert found.tolist() == [True, False, True, False]
    assert vals.tolist() == [10, 0, 12, 0]
    assert snap.range(10, 20)[0].tolist() == [10, 12, 14, 16, 18, 20]
    sm.release(snap)
    assert sm.stats() == {"pins": 1, "releases": 1, "active": 0,
                          "active_pairs": 0, "pinned_pairs_max": 95}


# --------------------------------------------------------- crash + recovery
RECOVERY_ENGINES = {
    "nbtree": lambda: make_engine("nbtree", f=3, sigma=64),
    "sharded:torch-nbtree": lambda: make_engine(
        "sharded:torch-nbtree", shards=4, f=4, sigma=64, max_nodes=64,
        device="cpu"),
}


@pytest.mark.parametrize("name", sorted(RECOVERY_ENGINES))
def test_crash_recovers_every_namespace(tmp_path, name):
    """A durable 3-tenant run killed after an fsync: global recovery and
    each tenant's ``recover_namespace`` equal the acked-prefix oracle."""
    factory = RECOVERY_ENGINES[name]
    ns = NamespaceMap()
    streams = [
        TenantStream(tenant=TenantConfig(0, weight=2.0), mix="delete-churn",
                     n_ops=700, preload=128, key_space=1 << 14,
                     arrival={"process": "poisson", "rate": 50_000.0}),
        TenantStream(tenant=TenantConfig(1), mix="insert-heavy",
                     n_ops=700, preload=128, key_space=1 << 14,
                     arrival={"process": "poisson", "rate": 50_000.0}),
        TenantStream(tenant=TenantConfig(5), mix="ycsb-e",
                     n_ops=400, preload=64, key_space=1 << 14,
                     arrival={"process": "poisson", "rate": 30_000.0}),
    ]
    tenants, traces = build_streams(streams, seed=7)
    inj = FaultInjector(CrashPoint.AFTER_WAL_FSYNC, at_occurrence=11)
    fe = MultiTenantFrontend(
        factory(), tenants, FrontendConfig(max_queue=4096, commit_ops=32),
        durability=DurabilityConfig(str(tmp_path), segment_bytes=4096,
                                    checkpoint_every_commits=6),
        injector=inj)
    with pytest.raises(SimulatedCrash):
        fe.run(traces)
    assert inj.fired and len(fe.acked) == 11
    pre = [ns.encode_batch(t, traces[t].preload) for t in sorted(traces)]
    oracle = _oracle_from_acked(pre, fe.acked)
    rr = recover(str(tmp_path), factory)
    rk, rv = rr.engine.dump_live()
    assert list(zip(rk.tolist(), rv.tolist())) == sorted(oracle.items())
    assert rr.last_lsn == fe.last_acked_lsn
    assert {int(k) >> ns.key_bits for k in oracle} == {0, 1, 5}
    for tid in (0, 1, 5):
        one = recover_namespace(str(tmp_path), factory, tid, namespace=ns)
        assert one.key_range == ns.tenant_interval(tid)
        ok, ov = one.engine.dump_live()
        assert list(zip(ok.tolist(), ov.tolist())) == \
            _scoped(oracle, ns.tenant_interval(tid))
        assert one.last_lsn == rr.last_lsn
        assert one.engine.stats().applied_lsn == rr.last_lsn


# --------------------------------------------------------------------- driver
def test_driver_cli_multi_mix_on_cpu(tmp_path, capsys):
    out = tmp_path / "multi.json"
    driver_main(["--engines", "torch-nbtree", "nbtree", "--device", "cpu",
                 "--shards", "2", "--mix", "insert-heavy", "--mix",
                 "point-read-heavy", "--weights", "2", "1", "--arrival",
                 "poisson", "--rate", "8000", "--ops", "256", "--batch",
                 "64", "--preload", "128", "--key-space", "16384",
                 "--out", str(out)])
    data = json.loads(out.read_text())
    assert data["mix"] == ["insert-heavy", "point-read-heavy"]
    dev, host = data["reports"]
    assert dev["device"] == "cpu" and host["device"] == "host"
    for rep in (dev, host):
        ol = rep["open_loop"]
        assert ol["fair"] and set(ol["tenants"]) == {"0", "1"}
        assert ol["tenants"]["0"]["weight"] == 2.0
        assert ol["n_done"] == 512 and rep["stats"]["shards"] >= 2
    assert dev["open_loop"]["service_model"] == "virtual"
    # the same streams leave the same live pairs in every namespace
    assert [t["live_pairs"] for t in dev["open_loop"]["tenants"].values()] \
        == [t["live_pairs"] for t in host["open_loop"]["tenants"].values()]
    assert "stream 1" in capsys.readouterr().out
    driver_main(["--engines", "nbtree", "--mix", "insert-heavy", "--mix",
                 "ycsb-e", "--ops", "256", "--batch", "64", "--preload",
                 "64", "--key-space", "16384", "--out", str(out)])
    rep = json.loads(out.read_text())
    assert len(rep["streams"]) == 2
    assert sum(s["live_pairs"] for s in rep["streams"]) == \
        rep["stats"]["total_pairs"]
    with pytest.raises(SystemExit):
        driver_main(["--mix", "ycsb-a", "--mix", "ycsb-e", "--weights", "1"])
