"""The port's device tier vs the JAX package's, on the CPU.

The same op streams go through ``repro.core.jax_nbtree.NBTreeIndex``
(fused path, Pallas kernels in interpret mode) and
``repro_torch.core.torch_nbtree.NBTreeIndex(device="cpu")`` (plain
versions of the kernels).  After every maintenance unit all seven node
tables must be bit-identical, along with the host tree, the pending queue,
the dispatch count and, after reads, the Bloom tallies.  The JAX read paths
run under ``jax.disable_jit()``: the same XLA operations, op by op, which
spares the minute-long CPU compile of the range descent.
"""
import ast
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.engine_api import OpBatch as JaxOpBatch
from repro.core.engine_api import make_engine as make_jax_engine
from repro.core.jax_nbtree import NBTreeIndex as JaxIndex
from repro.workloads import make_workload as make_jax_workload
from repro_torch.core import torch_nbtree
from repro_torch.core.engine_api import OpKind, TorchNBTreeEngine, make_engine
from repro_torch.core.state import export_state, index_from_reference
from repro_torch.core.torch_nbtree import NBTreeIndex
from repro_torch.workloads import MIXES, make_workload
from repro_torch.workloads.driver import main as driver_main

ROOT = Path(__file__).resolve().parents[1]
TABLES = ("run_keys", "run_vals", "run_count", "bloom", "pivots", "children",
          "nchild")


def _pool(seed, n):
    """n distinct keys in [1, 2^31)."""
    rng = np.random.default_rng(seed)
    return (rng.choice(2**31 - 1, n, replace=False) + 1).astype(np.uint32)


def _jax_state(idx: JaxIndex):
    """The JAX index in the port's exchange format (numpy on this side)."""
    tables = {name: np.asarray(getattr(idx, name)) for name in TABLES}

    def node(n):
        return {"nid": n.nid, "skeys": [int(k) for k in n.skeys],
                "count": int(n.count), "children": [node(c) for c in n.children]}

    tree = {"root": node(idx.root), "next_id": idx._next_id,
            "pending": [[n.nid, int(n.count)] for n in idx._pending],
            "counters": {c: int(getattr(idx, c)) for c in (
                "n_items", "units_done", "bloom_probes", "bloom_negative_skips",
                "bloom_false_positives", "dispatch_count")}}
    return tables, tree


def _assert_same(j: JaxIndex, t: NBTreeIndex, tag, counters=True) -> None:
    jt, jtree = _jax_state(j)
    tt, ttree = export_state(t)
    for name in TABLES:
        assert jt[name].dtype == tt[name].dtype, (tag, name)
        assert np.array_equal(jt[name], tt[name]), (tag, name)
    if not counters:
        del jtree["counters"], ttree["counters"]
    assert jtree == ttree, tag


class Pair:
    """One op stream into both indexes, compared after every maintain unit."""

    def __init__(self, **cfg):
        self.j = JaxIndex(**cfg)
        self.t = NBTreeIndex(device="cpu", **cfg)
        self.units = 0

    def insert(self, ks, vs):
        self.j.insert_batch(ks, vs)
        self.t.insert_batch(ks, vs)

    def delete(self, ks):
        self.j.delete_batch(ks)
        self.t.delete_batch(ks)

    def maintain(self, k):
        for _ in range(k):
            a, b = self.j.maintain(1), self.t.maintain(1)
            assert a == b
            self.units += 1
            _assert_same(self.j, self.t, f"unit {self.units}")

    def drain(self):
        while self.j._pending:
            self.maintain(1)
        assert not self.t._pending

    def reads(self, q, lo, hi, max_results):
        with jax.disable_jit():
            pj, vj = self.j.query_batch(q)
            rj = self.j.range_query_batch(lo, hi, max_results=max_results)
        pt, vt = self.t.query_batch(q)
        rt = self.t.range_query_batch(lo, hi, max_results=max_results)
        assert np.array_equal(np.asarray(pj), pt.numpy())
        assert np.array_equal(np.asarray(vj), vt.numpy())
        for a, b in zip(rj, rt):
            assert np.array_equal(np.asarray(a).astype(np.int64),
                                  b.numpy().astype(np.int64))
        _assert_same(self.j, self.t, "after reads")   # tallies included
        return pt.numpy(), vt.numpy(), [x.numpy() for x in rt]


def _stream_fused_rounds(p: Pair, oracle: dict):
    """tests/test_fused_maintenance.py::_apply_round, 7 rounds; batch sizes
    come from a short list, as each new size compiles the JAX insert anew."""
    rng, pool, cursor = np.random.default_rng(21), _pool(20, 6000), 0
    for _ in range(7):
        n = int(rng.choice((128, 192)))
        ks = pool[cursor: cursor + n]
        vs = (np.arange(len(ks)) + cursor).astype(np.int32)
        p.insert(ks, vs)
        oracle.update(zip(ks.tolist(), vs.tolist()))
        if rng.random() < 0.4 and cursor:
            dk = pool[cursor - 48: cursor]
            p.delete(dk)
            oracle.update((k, None) for k in dk.tolist())
        p.maintain(int(rng.integers(0, 3)))
        cursor += n


def _stream_interleaved(p: Pair, oracle: dict):
    """tests/test_range_queries.py's random interleaving (seed 1, 12 ops)."""
    rng = np.random.default_rng(1)
    for _ in range(12):
        op = rng.choice(["insert", "insert", "insert", "delete", "maintain",
                         "drain"])
        if op == "insert":
            n = int(rng.choice((32, 64, 128)))
            ks = rng.integers(1, 50_000, n).astype(np.uint32)
            vs = rng.integers(0, 2**20, n).astype(np.int32)
            p.insert(ks, vs)
            oracle.update(zip(ks.tolist(), vs.tolist()))
        elif op == "delete":
            live = sorted(k for k, v in oracle.items() if v is not None) or [1]
            ks = rng.choice(np.array(live, np.uint32), int(rng.choice((32, 64))))
            ks[::4] = rng.integers(1, 50_000, len(ks[::4]))
            p.delete(ks)
            oracle.update((k, None) for k in ks.tolist())
        elif op == "maintain":
            p.maintain(int(rng.integers(1, 4)))
        else:
            p.drain()


def _stream_grow(p: Pair, oracle: dict):
    """tests/test_jax_nbtree.py::test_grow_tables: one 3000-key batch."""
    keys = _pool(8, 3000)
    vals = np.arange(3000, dtype=np.int32)
    p.insert(keys, vals)
    oracle.update(zip(keys.tolist(), vals.tolist()))


@pytest.mark.parametrize("stream,cfg", [
    (_stream_fused_rounds, dict(f=3, sigma=256, max_nodes=64, max_levels=6)),
    (_stream_interleaved, dict(f=3, sigma=128, max_nodes=64, max_levels=6)),
    (_stream_grow, dict(f=3, sigma=64, max_nodes=16, max_levels=6)),
], ids=["fused-rounds", "range-interleave", "grow-tables"])
def test_tables_match_jax_after_every_unit(stream, cfg):
    p = Pair(**cfg)
    oracle: dict = {}
    stream(p, oracle)
    p.drain()
    p.t.check_invariants()
    assert p.t.max_nodes == p.j.max_nodes and p.units > 0
    if stream is _stream_grow:
        assert p.t.max_nodes > cfg["max_nodes"]     # growth happened
    # reads: the port's height+1-level descent == JAX's max_levels+1 levels
    assert p.t.height < p.t.max_levels
    keys = np.array(sorted(oracle), np.uint32)
    q = np.concatenate([keys[: 240], np.array([2**31 + 5] * 16, np.uint32)])
    live = sorted(k for k, v in oracle.items() if v is not None)
    lo = np.array([1, live[len(live) // 4], 40, live[5]], np.uint32)
    hi = np.array([2**31, live[len(live) // 2], 10, live[5]], np.uint32)
    pres, vals, (rk, rv, rc, rtr) = p.reads(q, lo, hi, max_results=4096)
    for i, k in enumerate(q.tolist()):            # sorted-dict oracle
        want = oracle.get(k)
        assert bool(pres[i]) == (want is not None), k
        if want is not None:
            assert vals[i] == want, k
    for b in range(len(lo)):
        want = [k for k in live if lo[b] <= k <= hi[b]]
        assert not rtr[b] and rk[b, : rc[b]].tolist() == want
        assert rv[b, : rc[b]].tolist() == [oracle[k] for k in want]


def _reads_jit_queries(p: Pair, q, lo, hi):
    """``Pair.reads`` with JAX's point descent jitted: its shape is fixed
    here, so it compiles once, while op by op it costs ~0.5 s a call."""
    pj, vj = p.j.query_batch(q)
    with jax.disable_jit():
        rj = p.j.range_query_batch(lo, hi, max_results=128)
    pt, vt = p.t.query_batch(q)
    rt = p.t.range_query_batch(lo, hi, max_results=128)
    assert np.array_equal(np.asarray(pj), pt.numpy())
    assert np.array_equal(np.asarray(vj), vt.numpy())
    for a, b in zip(rj, rt):
        assert np.array_equal(np.asarray(a).astype(np.int64),
                              b.numpy().astype(np.int64))
    _assert_same(p.j, p.t, "after reads")   # tallies included
    return pt.numpy(), vt.numpy(), [x.numpy() for x in rt]


def test_high_key_stream_matches_jax_after_every_unit():
    """Keys from [2^32 - 4000, 2^32 - 1) plus 0, 1, 2^31 - 1 and 2^31 (and
    the sentinel 2^32 - 1): every table after every one of 20 units, and
    every point and range read after each, equal JAX's.  The inserted key
    2^32 - 1 reads back absent in both packages: ``KEY_MAX32`` is the
    shared padding sentinel, named as reserved by the port's protocol.
    A query of that key routes through the KEY_MAX-padded pivots, which
    JAX follows for ``max_levels + 1`` levels and the port for
    ``height + 1``, so only its answer (not its Bloom tally) is compared,
    once, after the stream."""
    from repro_torch.core import engine_api
    assert "KEY_MAX32" in engine_api.__doc__
    sentinel = 2**32 - 1
    rng = np.random.default_rng(12)
    high = rng.permutation(np.arange(2**32 - 4000, sentinel, dtype=np.int64))
    special = np.array([0, 1, 2**31 - 1, 2**31], np.int64)
    pool = np.concatenate([special, [sentinel], high]).astype(np.uint32)
    p = Pair(f=3, sigma=64, max_nodes=64, max_levels=6)
    oracle: dict = {}
    q = np.concatenate([special, high[:40], [2**32 - 4001]]).astype(np.uint32)
    lo = np.array([0, 2**31, 2**32 - 4000, 2**32 - 60, 2**32 - 2, 5],
                  np.uint32)
    hi = np.array([2**31 - 1, 2**31 + 5, 2**32 - 3900, sentinel, sentinel, 4],
                  np.uint32)
    cursor = 0
    while p.units < 20:
        ks = pool[cursor: cursor + 128]
        vs = (np.arange(len(ks)) + cursor).astype(np.int32)
        p.insert(ks, vs)
        oracle.update(zip(ks.tolist(), vs.tolist()))
        if cursor == 256:
            p.delete(pool[1:3])
            oracle.update((k, None) for k in pool[1:3].tolist())
        cursor += 128
        for _ in range(2):
            p.maintain(1)
            pres, vals, (rk, rv, rc, rtr) = _reads_jit_queries(p, q, lo, hi)
    for i, k in enumerate(q.tolist()):
        want = oracle.get(k)
        assert bool(pres[i]) == (want is not None), k
        if want is not None:
            assert vals[i] == want, k
    live = sorted(k for k, v in oracle.items()
                  if v is not None and k != sentinel)
    for b in range(len(lo)):
        want = [k for k in live if lo[b] <= k <= hi[b]]
        assert not rtr[b] and rk[b, : rc[b]].tolist() == want
    assert oracle[sentinel] is not None               # it was inserted ...
    s = np.array([sentinel, 2**32 - 4000], np.uint32)
    with jax.disable_jit():
        pj, vj = p.j.query_batch(s)
    pt, vt = p.t.query_batch(s)
    assert np.array_equal(np.asarray(pj), pt.numpy())
    assert np.array_equal(np.asarray(vj), vt.numpy())
    assert not pt[0]                                  # ... and reads absent


def test_state_roundtrip_continues_like_jax():
    """Load a JAX index's state mid-maintenance into the port, then run the
    same ops on both: tables stay bit-identical, and the export round-trips."""
    pool = _pool(5, 3000)
    j = JaxIndex(f=3, sigma=64, max_nodes=32)
    for i in range(0, 1536, 128):
        j.insert_batch(pool[i:i + 128], np.arange(128, dtype=np.int32) + i)
        j.maintain(1)
    assert j._pending                                  # pending work carried
    tables, tree = _jax_state(j)
    t = index_from_reference(tables, tree, f=3, sigma=64, device="cpu")
    _assert_same(j, t, "loaded")
    p = Pair.__new__(Pair)
    p.j, p.t, p.units = j, t, 0
    p.delete(pool[:100])
    p.insert(pool[1536:1664], np.arange(128, dtype=np.int32))
    p.drain()
    with pytest.raises(ValueError, match="shape"):
        index_from_reference(tables, tree, f=4, sigma=64, device="cpu")


def _workload(**overrides):
    kw = dict(key_space=4096, n_ops=512, batch_size=128, preload=256,
              range_selectivity=0.01, seed=3)
    kw.update(overrides)
    return make_workload("delete-churn", **kw)


def test_engine_matches_jax_engine_and_oracle():
    """tests/test_engine_api.py's delete-churn stream: every answer equals a
    sorted-dict oracle's, and the writes leave the same tables and the same
    ``dump_live`` as the JAX engine's (fed the same writes: reads change no
    table)."""
    wl = _workload()
    eng = make_engine("torch-nbtree", f=4, sigma=256, max_nodes=256,
                      device="cpu")
    ref = make_jax_engine("jax-nbtree", f=4, sigma=256, max_nodes=256)
    pre = wl.preload_batch()
    model = dict(zip(pre.keys.tolist(), pre.vals.tolist()))
    for e in (eng, ref):
        e.apply(pre)
        e.drain()
    writes = (int(OpKind.INSERT), int(OpKind.DELETE))
    for b in wl.batches():
        res = eng.apply(b)
        w = np.isin(b.kinds, writes)
        ref.apply(JaxOpBatch(b.kinds[w], b.keys[w], b.vals[w], b.his[w]))
        assert not res.range_truncated.any()
        for i in range(len(b)):
            kind, k = OpKind(int(b.kinds[i])), int(b.keys[i])
            if kind is OpKind.INSERT:
                model[k] = int(b.vals[i])
            elif kind is OpKind.DELETE:
                model.pop(k, None)
            elif kind is OpKind.QUERY:
                assert bool(res.found[i]) == (k in model)
                assert int(res.values[i]) == model.get(k, -1)
            else:
                ks = sorted(x for x in model if k <= x <= int(b.his[i]))
                assert res.range_hits[i][0].tolist() == ks
                assert res.range_hits[i][1].tolist() == [model[x] for x in ks]
        eng.maintain(2)
        ref.maintain(2)
        _assert_same(ref.idx, eng.idx, "batch", counters=False)
    eng.drain()
    ref.drain()
    tk, tv = eng.dump_live()
    jk, jv = ref.dump_live()
    assert tk.dtype == jk.dtype and tv.dtype == jv.dtype
    assert np.array_equal(tk, jk) and np.array_equal(tv, jv)
    assert tk.tolist() == sorted(model)
    s = eng.stats()
    assert s.total_pairs == len(model) and s.pending_debt == 0
    assert s.device_dispatches == eng.idx.dispatch_count > 0


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_generator_streams_match_jax(mix):
    kw = dict(key_space=1 << 16, n_ops=1024, batch_size=256, preload=300,
              seed=11)
    ours, theirs = make_workload(mix, **kw), make_jax_workload(mix, **kw)
    pairs = [(ours.preload_batch(), theirs.preload_batch()),
             *zip(ours.batches(), theirs.batches(), strict=True)]
    for a, b in pairs:
        for f in ("kinds", "keys", "vals", "his"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (mix, f)
            assert getattr(a, f).dtype == getattr(b, f).dtype


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        NBTreeIndex()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchNBTreeEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        NBTreeIndex(device="cuda")


def test_flush_unit_is_one_dispatch(monkeypatch):
    """A flush unit is one impl call through the funnel, as in JAX."""
    calls: list = []
    real = torch_nbtree._device_call

    def counting(fn, *args, **kwargs):
        calls.append(fn.__name__)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(torch_nbtree, "_device_call", counting)
    idx = NBTreeIndex(f=4, sigma=64, max_nodes=64, device="cpu")
    pool, flushes = _pool(7, 4096), 0
    for i in range(0, len(pool), 128):
        idx.insert_batch(pool[i:i + 128], np.arange(128, dtype=np.int32))
        while idx._pending:
            node = next((n for n in idx._pending if n.count > idx.sigma), None)
            internal = node is not None and not node.is_leaf
            calls.clear()
            idx.maintain(1)
            if internal:
                flushes += 1
                assert calls == ["_flush_impl"], calls
    assert flushes > 10


def test_driver_cli_on_cpu(tmp_path):
    out = tmp_path / "r.json"
    driver_main(["--mix", "delete-churn", "--ops", "256", "--batch", "64",
                 "--preload", "64", "--key-space", "4096", "--device", "cpu",
                 "--out", str(out)])
    rep = json.loads(out.read_text())
    assert rep["engine"] == "torch-nbtree" and rep["device"] == "cpu"
    assert sum(h["count"] for h in rep["per_kind"].values()) == 256
    assert rep["stats"]["pending_debt"] == 0


@pytest.mark.parametrize("flag", ["--list-mixes", "--list-engines"])
def test_driver_lists_match_jax(capsys, flag):
    """The listing flags print the JAX driver's lines: the mixes exactly,
    the engines with ``torch-nbtree`` in place of ``jax-nbtree``."""
    from repro.workloads.driver import main as jax_driver_main
    assert driver_main([flag]) is None
    ours = capsys.readouterr().out.splitlines()
    jax_driver_main([flag])
    theirs = capsys.readouterr().out.splitlines()
    if flag == "--list-engines":
        theirs = sorted(n.replace("jax-nbtree", "torch-nbtree")
                        for n in theirs)
        ours = sorted(ours)
        assert "torch-nbtree" in ours
    assert ours == theirs and len(ours) > 5


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    scanned = {p.relative_to(ROOT).as_posix() for p in files}
    assert {"src/repro_torch/models/moe.py",
            "src/repro_torch/models/mla.py", "src/repro_torch/models/ssm.py",
            "src/repro_torch/models/blockwise_attn.py",
            "src/repro_torch/optim/adamw.py",
            "src/repro_torch/optim/compression.py",
            "src/repro_torch/optim/schedules.py",
            "src/repro_torch/train/train_step.py",
            "src/repro_torch/train/trainer.py",
            "src/repro_torch/data/pipeline.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/distributed/sharding.py",
            "src/repro_torch/distributed/fault_tolerance.py",
            "src/repro_torch/configs/shapes.py",
            "src/repro_torch/roofline/hardware.py",
            "src/repro_torch/roofline/analysis.py"} <= scanned
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
