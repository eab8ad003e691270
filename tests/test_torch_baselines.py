"""The port's host comparison tiers (``core/{lsm,btree,bepsilon}.py`` and
their engines ``lsm``, ``blsm``, ``btree``, ``bepsilon``) vs the JAX
package's, on the CPU.

They are sim-clock cost models, so on the same seeded ops every return
value (answer and charged seconds) and every stats field must equal the
JAX package's; the closed- and open-loop driver reports equal its too.
The port's registry carries ``FIVE_TIERS`` with its device tier in
``jax-nbtree``'s place.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.core.bepsilon import BEpsilonTree as JaxBEpsilonTree
from repro.core.btree import BPlusTree as JaxBPlusTree
from repro.core.btree import BPlusTreeBulk as JaxBPlusTreeBulk
from repro.core.engine_api import FIVE_TIERS as JAX_FIVE_TIERS
from repro.core.engine_api import make_engine as make_jax_engine
from repro.core.lsm import LSMTree as JaxLSMTree
from repro.ingest import PoissonArrivals as JaxPoisson
from repro.ingest import make_trace as make_jax_trace
from repro.ingest import run_open_loop as jax_run_open_loop
from repro.workloads import make_workload as make_jax_workload
from repro.workloads.driver import run_workload as jax_run_workload
from repro_torch.core.bepsilon import BEpsilonTree
from repro_torch.core.btree import BPlusTree, BPlusTreeBulk
from repro_torch.core.engine_api import (FIVE_TIERS, available_engines,
                                         make_engine)
from repro_torch.core.lsm import LSMTree
from repro_torch.ingest import PoissonArrivals, make_trace, run_open_loop
from repro_torch.workloads import make_workload
from repro_torch.workloads.driver import main as driver_main
from repro_torch.workloads.driver import run_workload

HOST_TIERS = {
    "lsm": dict(mem_pairs=128),
    "blsm": dict(mem_pairs=128),
    "btree": {},
    "bepsilon": dict(node_bytes=1 << 14, cached_levels=1),
}


def _canon(report) -> str:
    return json.dumps(report, sort_keys=True, default=float)


@pytest.mark.parametrize("ours,theirs,kw", [
    (LSMTree, JaxLSMTree, dict(mem_pairs=64)),
    (LSMTree, JaxLSMTree, dict(mem_pairs=64, max_levels=3)),
    (BPlusTree, JaxBPlusTree, {}),
    (BEpsilonTree, JaxBEpsilonTree, dict(node_bytes=1 << 12, fanout=4,
                                          cached_levels=1)),
], ids=["lsm", "blsm", "btree", "bepsilon"])
def test_host_structures_match_jax_op_by_op(ours, theirs, kw):
    """Every return value (charged seconds included) of a random
    insert/delete/query/range interleaving equals the JAX package's."""
    rng = np.random.default_rng(len(kw))
    a, b = ours(**kw), theirs(**kw)
    for step in range(3000):
        k = np.uint64(rng.integers(1, 5000))
        r = rng.random()
        if r < 0.6:
            assert a.insert(k, step) == b.insert(k, step)
        elif r < 0.7:
            assert a.delete(k) == b.delete(k)
        elif r < 0.95:
            assert a.query(k) == b.query(k)
        else:
            (ak, av), (bk, bv) = (a.range_query(int(k), int(k) + 200),
                                  b.range_query(int(k), int(k) + 200))
            assert np.array_equal(ak, bk) and np.array_equal(av, bv)
            assert a._last_query_time == b._last_query_time
    assert a.total_pairs() == b.total_pairs()
    counters = ("seeks", "bytes_read", "bytes_written", "pages", "time")
    assert [getattr(a.cm, c) for c in counters] == \
        [getattr(b.cm, c) for c in counters]
    assert a.cm.time > 0


def test_bulk_btree_matches_jax():
    rng = np.random.default_rng(2)
    keys = np.sort(rng.choice(10_000_000, 5000, replace=False).astype(
        np.uint64) + 1)
    vals = np.arange(5000, dtype=np.int64)
    a, b = BPlusTreeBulk(keys, vals), JaxBPlusTreeBulk(keys, vals)
    for k in np.concatenate([keys[::97], keys[::131] + 1]):
        assert a.query(k) == b.query(k)
    for lo in keys[::500]:
        (ak, av), (bk, bv) = a.range_query(int(lo), int(lo) + 50_000), \
            b.range_query(int(lo), int(lo) + 50_000)
        assert np.array_equal(ak, bk) and np.array_equal(av, bv)
    assert a.get(keys[777]) == 777 and a.total_pairs() == b.total_pairs()


@pytest.mark.parametrize("name", sorted(HOST_TIERS))
def test_host_engine_reports_equal_jax(name):
    """Closed loop (delete-churn) and open loop (insert-heavy, Poisson):
    reports field for field, stats included."""
    kw = HOST_TIERS[name]
    wl = dict(key_space=1 << 14, n_ops=1024, preload=512, batch_size=128,
              seed=3)
    rep = run_workload(make_engine(name, **kw),
                       make_workload("delete-churn", **wl), maintain_budget=2)
    jrep = jax_run_workload(make_jax_engine(name, **kw),
                            make_jax_workload("delete-churn", **wl),
                            maintain_budget=2)
    assert _canon(rep) == _canon(jrep)
    st = rep["stats"]
    assert st["engine"] == name and st["clock"] == "sim"
    assert st["io_time_s"] > 0 and st["total_pairs"] > 0
    ol = run_open_loop(make_engine(name, **kw),
                       make_trace(make_workload("insert-heavy", **wl),
                                  PoissonArrivals(20_000.0)))
    jol = jax_run_open_loop(make_jax_engine(name, **kw),
                            make_jax_trace(make_jax_workload("insert-heavy",
                                                             **wl),
                                           JaxPoisson(20_000.0)))
    assert _canon(ol) == _canon(jol)
    assert ol["open_loop"]["service_model"] == "charged"


def test_registry_carries_five_tiers():
    assert FIVE_TIERS == ("nbtree", "lsm", "btree", "bepsilon",
                          "torch-nbtree")
    assert FIVE_TIERS[:4] == JAX_FIVE_TIERS[:4]
    assert {"nbtree", "nbtree-basic", "nbtree-nobloom", "lsm", "blsm",
            "btree", "bepsilon", "torch-nbtree"} == set(available_engines())
    blsm = make_engine("blsm", mem_pairs=64)
    assert blsm.name == "blsm" and blsm.impl.max_levels == 3
    assert make_engine("blsm", max_levels=5).impl.max_levels == 5
    for name in FIVE_TIERS:
        kw = dict(device="cpu") if name == "torch-nbtree" else {}
        eng = make_engine(name, **kw)
        assert eng.name == name
        assert eng.stats().clock == ("wall" if name == "torch-nbtree"
                                     else "sim")


def test_driver_cli_all_tiers_on_cpu(tmp_path, capsys):
    out = tmp_path / "all.json"
    driver_main(["--engines", "all", "--device", "cpu", "--mix",
                 "delete-churn", "--ops", "512", "--batch", "128",
                 "--preload", "256", "--key-space", "16384", "--out",
                 str(out)])
    data = json.loads(out.read_text())
    reps = data["reports"]
    assert [r["engine"] for r in reps] == list(FIVE_TIERS)
    assert [r["device"] for r in reps] == ["host"] * 4 + ["cpu"]
    # the same stream leaves the same live pairs on every tier
    assert len({r["stats"]["total_pairs"] for r in reps}) == 1
    assert all(r["stats"]["pending_debt"] == 0 for r in reps)
    assert capsys.readouterr().out.count("delete-churn") == 5


def test_bulk_btree_engine_matches_jax():
    """``BulkBTreeEngine`` (``btree-bulk``, static): built from the same
    keys, every QUERY and RANGE answer and charged second, its stats and
    its live dump equal the JAX package's; an INSERT or DELETE raises
    ``UnsupportedOp`` in both."""
    from repro.core import engine_api as jea
    from repro_torch.core import engine_api as tea

    rng = np.random.default_rng(5)
    keys = rng.choice(1 << 20, 4096, replace=False).astype(np.uint64) + 1
    vals = rng.integers(0, 1 << 30, 4096)
    ours, theirs = (tea.BulkBTreeEngine(keys, vals),
                    jea.BulkBTreeEngine(keys, vals))
    assert ours.name == theirs.name == "btree-bulk"
    assert "btree-bulk" not in available_engines()
    n = 512
    qk = np.concatenate([keys[:n // 2], rng.integers(1, 1 << 20, n // 2)
                         .astype(np.uint64)])
    kinds = np.array([int(tea.OpKind.QUERY)] * n + [int(tea.OpKind.RANGE)] * 64)
    lo = rng.integers(1, 1 << 20, 64).astype(np.uint64)
    b = dict(kinds=kinds, keys=np.concatenate([qk, lo]),
             vals=np.zeros(n + 64, np.int64),
             his=np.concatenate([np.zeros(n, np.uint64), lo + 5000]))
    a = ours.apply(tea.OpBatch(**b))
    w = theirs.apply(jea.OpBatch(**b))
    assert np.array_equal(a.found, w.found)
    assert np.array_equal(a.values, w.values)
    assert np.array_equal(a.latency_s, w.latency_s)
    assert a.found[:n // 2].all()
    for x, y in zip(a.range_hits, w.range_hits):
        if x is None:
            assert y is None
        else:
            assert all(np.array_equal(p, q) for p, q in zip(x, y))
    assert ours.count_live() == theirs.count_live() == 4096
    assert all(np.array_equal(x, y) for x, y in zip(ours.dump_live(),
                                                    theirs.dump_live()))
    assert _canon(dataclasses.asdict(ours.stats())) == _canon(
        dataclasses.asdict(theirs.stats()))
    for kind in (tea.OpKind.INSERT, tea.OpKind.DELETE):
        one = dict(kinds=np.array([int(kind)]), keys=keys[:1],
                   vals=np.zeros(1, np.int64), his=np.zeros(1, np.uint64))
        with pytest.raises(tea.UnsupportedOp):
            ours.apply(tea.OpBatch(**one))
        with pytest.raises(jea.UnsupportedOp):
            theirs.apply(jea.OpBatch(**one))
