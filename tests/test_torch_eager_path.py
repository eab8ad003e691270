"""The port's eager write path (``NBTreeIndex(fused=False)``) on the CPU.

The JAX package keeps its pre-fusion eager write path as the differential
oracle and ingest baseline; the port keeps it too.  Held here: the port's
eager index against JAX's eager index (Pallas in interpret mode) after
every maintenance unit, tables, host tree, pending queue and dispatch
count; the port's eager index against its fused one and a dict oracle;
each unit's sequence of dispatches against JAX's; a JAX eager index's
state continuing in the port; and the driver's report on both packages'
eager engines.  Shapes are small (f=3, sigma=256, max_nodes=8), so the
tables grow mid-run.
"""
import jax
import numpy as np
import pytest
from test_fused_maintenance import _apply_round as _fused_round
from test_torch_nbtree import TABLES, Pair, _assert_same, _jax_state, _pool

import repro.core.jax_nbtree as jnb
from repro.core.engine_api import make_engine as make_jax_engine
from repro.workloads import make_workload as make_jax_workload
from repro.workloads.driver import run_workload as jax_run_workload
from repro_torch.core import torch_nbtree
from repro_torch.core.engine_api import make_engine
from repro_torch.core.state import export_state, index_from_reference
from repro_torch.core.torch_nbtree import NBTreeIndex
from repro_torch.workloads import make_workload
from repro_torch.workloads.driver import run_workload

EAGER = dict(f=3, sigma=256, max_nodes=8, fused=False)


def _apply_round(idx, oracle: dict, rng, pool, cursor: int) -> int:
    """``tests/test_fused_maintenance.py::_apply_round`` with its batch
    sizes drawn from two values each: every new size compiles the JAX
    eager path's sort and merge anew (~1 s a size on the CPU)."""
    n = int(rng.choice((128, 192)))
    ks = pool[cursor: cursor + n]
    vs = (np.arange(len(ks)) + cursor).astype(np.int32)
    idx.insert_batch(ks, vs)
    oracle.update(zip(ks.tolist(), vs.tolist()))
    if rng.random() < 0.4 and cursor:
        dk = pool[max(0, cursor - int(rng.choice((32, 48)))): cursor]
        idx.delete_batch(dk)
        oracle.update((k, None) for k in dk.tolist())
    idx.maintain(int(rng.integers(0, 3)))
    return cursor + n


class EagerPair(Pair):
    """``Pair`` under ``_apply_round``'s index interface: both indexes are
    compared after each write batch and after every maintenance unit."""

    def insert_batch(self, ks, vs):
        self.insert(ks, vs)
        _assert_same(self.j, self.t, f"insert after unit {self.units}")

    def delete_batch(self, ks):
        self.delete(ks)
        _assert_same(self.j, self.t, f"delete after unit {self.units}")


def _check_reads(idx, oracle: dict, rng) -> None:
    """Point and range answers of ``idx`` against the dict oracle."""
    seen = np.array(sorted(oracle), np.uint32)
    q = rng.choice(seen, min(800, len(seen)), replace=False)
    p, v = idx.query_batch(q)
    p, v = p.numpy(), v.numpy()
    for j, k in enumerate(q.tolist()):
        want = oracle.get(k)
        assert p[j] == (want is not None), k
        if want is not None:
            assert v[j] == want, k
    live = sorted(k for k, v in oracle.items() if v is not None)
    lo, hi = live[len(live) // 4], live[3 * len(live) // 4]
    want_r = [(k, oracle[k]) for k in live if lo <= k <= hi]
    rk, rv, cnt, trunc = idx.range_query_batch(
        np.asarray([lo]), np.asarray([hi]), max_results=len(want_r) + 8)
    assert not bool(trunc[0])
    c = int(cnt[0])
    assert list(zip(rk[0, :c].tolist(), rv[0, :c].tolist())) == want_r


def test_eager_matches_jax_eager_after_every_unit():
    """(a) ``_apply_round``'s random rounds into both eager indexes: the
    seven tables bit for bit, ``_next_id``, the pending queue, the host
    tree and ``dispatch_count`` equal after every write and every unit;
    then the port's answers equal a dict oracle's."""
    p = EagerPair(**EAGER)
    oracle: dict = {}
    rng, pool, cursor = np.random.default_rng(21), _pool(20, 6000), 0
    for _ in range(14):
        cursor = _apply_round(p, oracle, rng, pool, cursor)
    p.drain()
    assert p.units > 10 and p.t.max_nodes > EAGER["max_nodes"]
    p.t.check_invariants()
    # the read paths are the same on both write paths and are held
    # against JAX's in tests/test_torch_nbtree.py: the oracle suffices here
    _check_reads(p.t, oracle, rng)


def test_eager_matches_fused_and_oracle():
    """(b) 18 rounds into the port's eager and fused indexes: tables and
    host trees bit for bit after every round, then both against a dict
    oracle (the port's ``test_fused_matches_eager_and_oracle``)."""
    rng_a, rng_b, rng_q = (np.random.default_rng(s) for s in (21, 21, 99))
    pool = _pool(20, 6000)
    cfg = dict(EAGER, device="cpu")
    fused = NBTreeIndex(**(cfg | {"fused": True}))
    eager = NBTreeIndex(**cfg)
    oracle: dict = {}
    shadow: dict = {}
    ca = cb = 0
    for r in range(18):
        ca = _fused_round(fused, oracle, rng_a, pool, ca)
        cb = _fused_round(eager, shadow, rng_b, pool, cb)
        assert ca == cb and oracle == shadow       # identical op streams
        if r % 6 == 5:
            fused.drain()
            eager.drain()
        ft, ftree = export_state(fused)
        et, etree = export_state(eager)
        for name in TABLES:
            assert np.array_equal(ft[name], et[name]), (r, name)
        del ftree["counters"], etree["counters"]   # dispatch counts differ
        assert ftree == etree, r
    fused.drain()
    eager.drain()
    assert fused.max_nodes == eager.max_nodes > EAGER["max_nodes"]
    assert eager.dispatch_count > 5 * fused.dispatch_count
    for idx in (fused, eager):
        idx.check_invariants()
        _check_reads(idx, oracle, rng_q)


def _recording(monkeypatch, module, calls: list):
    real = module._device_call

    def record(fn, *args, **kwargs):
        calls.append(getattr(fn, "__name__", None) or repr(fn))
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(module, "_device_call", record)


@pytest.mark.parametrize("cfg,deletes", [
    (dict(f=4, sigma=128, max_nodes=16), False),
    (dict(f=3, sigma=64, max_nodes=8), True),
], ids=["f4-inserts", "f3-deletes"])
def test_unit_dispatches_match_jax(monkeypatch, cfg, deletes):
    """(c) Each insert batch's and each maintain unit's dispatches, by
    name and in order, equal the JAX eager index's on the same unit (JAX's
    un-jitted ``.at[row].set`` is the port's ``_write_row``)."""
    jc: list = []
    tc: list = []
    _recording(monkeypatch, jnb, jc)
    _recording(monkeypatch, torch_nbtree, tc)
    j = jnb.NBTreeIndex(fused=False, **cfg)
    t = NBTreeIndex(fused=False, device="cpu", **cfg)
    pool = _pool(7, 2560)
    kinds = {"insert": 0, "flush": 0, "split": 0}

    def same(kind):
        assert [{"set": "_write_row"}.get(n, n) for n in jc] == tc, kind
        assert len(tc) > 0
        kinds[kind] += 1
        jc.clear()
        tc.clear()

    for i in range(0, len(pool), 128):
        for idx in (j, t):
            idx.insert_batch(pool[i:i + 128], np.arange(128, dtype=np.int32))
        same("insert")
        if deletes and i % 512 == 384:
            for idx in (j, t):
                idx.delete_batch(pool[i - 128:i])
            same("insert")
        while t._pending:
            node = next((n for n in t._pending if n.count > t.sigma), None)
            leaf = node is not None and node.is_leaf
            assert j.maintain(1) == t.maintain(1)
            if node is None:
                assert not jc and not tc    # stale entries retire for free
                continue
            same("split" if leaf else "flush")
    assert kinds["flush"] > 10 and kinds["split"] > 2 and kinds["insert"] >= 20
    assert j.dispatch_count == t.dispatch_count


def test_state_from_jax_eager_continues_like_jax():
    """(d) A JAX eager index's state, loaded mid-maintenance with
    ``index_from_reference(..., fused=False)``, continues bit for bit and
    dispatch for dispatch."""
    pool = _pool(5, 3000)
    j = jnb.NBTreeIndex(f=3, sigma=128, max_nodes=8, fused=False)
    for i in range(0, 1536, 128):
        j.insert_batch(pool[i:i + 128], np.arange(128, dtype=np.int32) + i)
        j.maintain(1)
    assert j._pending                                  # pending work carried
    tables, tree = _jax_state(j)
    t = index_from_reference(tables, tree, f=3, sigma=128, fused=False,
                             device="cpu")
    assert not t._fused
    _assert_same(j, t, "loaded")
    p = Pair.__new__(Pair)
    p.j, p.t, p.units = j, t, 0
    p.delete(pool[:128])
    p.insert(pool[1536:1792], np.arange(256, dtype=np.int32))
    _assert_same(j, t, "after writes")
    p.drain()
    assert p.units > 0 and t.max_nodes > 8


def _report(port: bool) -> dict:
    kw = dict(key_space=4096, n_ops=256, batch_size=256, preload=512,
              range_selectivity=0.01, seed=3)
    cfg = dict(EAGER, max_levels=3)
    if port:
        eng = make_engine("torch-nbtree", device="cpu", **cfg)
        rep = run_workload(eng, make_workload("delete-churn", **kw))
    else:
        eng = make_jax_engine("jax-nbtree", **cfg)
        for name in ("query_batch", "range_query_batch"):
            real = getattr(eng.idx, name)

            def op_by_op(*a, _real=real, **k):
                # the same XLA ops, without a compile per read shape
                with jax.disable_jit():
                    return _real(*a, **k)

            setattr(eng.idx, name, op_by_op)
        rep = jax_run_workload(eng, make_jax_workload("delete-churn", **kw))
    assert not eng.idx._fused
    return rep


def test_driver_report_counts_match_jax_eager():
    """(e) ``make_engine("torch-nbtree", fused=False)`` through the driver's
    closed loop counts what ``jax-nbtree`` with ``fused=False`` counts:
    every op kind, pair, unit, dispatch and Bloom tally of the report."""
    ours, theirs = _report(True), _report(False)
    wall = {"io_time_s", "io_time_preload_s", "maintain_wall_s",
            "maintain_unit_p50_s", "maintain_unit_p99_s",
            "maintain_unit_p100_s", "engine"}
    for rep in (ours, theirs):
        rep["per_kind"] = {k: h["count"] for k, h in rep["per_kind"].items()}
        rep["stats"] = {k: v for k, v in rep["stats"].items()
                        if k not in wall}
        for k in wall:
            rep.pop(k, None)
    assert ours == theirs
    st = ours["stats"]
    assert st["device_dispatches"] > 0 and st["maintain_units"] > 0
    assert st["n_deletes"] > 0 and st["n_ranges"] > 0
    assert st["pending_debt"] == 0
