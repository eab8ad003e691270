"""The port's durability layer (``repro_torch.wal``, ``checkpoint``) vs the
JAX package's, on the CPU.

* The WAL cases of the JAX package's durability tests, on the port's log.
* One on-disk format: for the same commits the port's segment files equal
  the JAX package's byte for byte, and each package replays the other's
  directory; the same for engine snapshots and for a checkpoint of a
  nested dict with a bf16 leaf.
* The crash matrix: a kill at every crash point of the durable frontend,
  over the host ``nbtree`` tier and over ``torch-nbtree`` (plain versions
  on the CPU), recovers exactly the acked prefix; on ``nbtree`` the acked
  commits also equal the JAX package's.
* Restart after a crash and after a clean shutdown continues the LSN chain.
* The protocol repairs: ``note_applied``/``applied_lsn``,
  ``dump_live_range`` and ``count_live_range``.
* One large batch (a bulk load, a recovery's snapshot): the port's index
  makes room in a child before a flush would overfill it, where the JAX
  index asserts (elsewhere the parity tests of ``test_torch_nbtree.py``
  hold its tables to JAX's).
"""
import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.checkpoint.checkpointer import \
    EngineCheckpointer as JaxEngineCheckpointer
from repro.core.engine_api import OpBatch as JaxOpBatch
from repro.core.jax_nbtree import NBTreeIndex as JaxIndex
from repro.core.engine_api import make_engine as make_jax_engine
from repro.ingest import DurabilityConfig as JaxDurability
from repro.ingest import FrontendConfig as JaxFrontendConfig
from repro.ingest import IngestFrontend as JaxFrontend
from repro.ingest import PoissonArrivals as JaxPoisson
from repro.ingest import make_trace as make_jax_trace
from repro.wal import CrashPoint as JaxCrashPoint
from repro.wal import FaultInjector as JaxInjector
from repro.wal import SimulatedCrash as JaxCrash
from repro.wal import WriteAheadLog as JaxWAL
from repro.workloads import make_workload as make_jax_workload
from repro_torch.checkpoint import (CheckpointError, Checkpointer,
                                    EngineCheckpointer)
from repro_torch.core import torch_nbtree
from repro_torch.core.engine_api import OpBatch, OpKind, make_engine
from repro_torch.ingest import (DurabilityConfig, FrontendConfig,
                                IngestFrontend, PoissonArrivals, make_trace)
from repro_torch.wal import (CrashPoint, FaultInjector, SimulatedCrash,
                             WriteAheadLog, recover)
from repro_torch.workloads import make_workload

KEYS = np.uint64
VALS = np.int64


def _commit(i, n=8):
    """Synthetic commit #i: n inserts (and a delete) with key = i*100 + j."""
    keys = np.arange(i * 100, i * 100 + n, dtype=KEYS)
    kinds = np.full(n, int(OpKind.INSERT), np.int8)
    kinds[-1] = int(OpKind.DELETE)
    return kinds, keys, keys.astype(VALS)


# ------------------------------------------------------------------------ wal
def test_wal_roundtrip_rotation_and_reopen(tmp_path):
    wal = WriteAheadLog(str(tmp_path), segment_bytes=4096)
    for i in range(1, 31):
        lsn, nbytes = wal.append_commit(*_commit(i))
        assert lsn == i and nbytes == 20 + 4 + 8 * 17
    assert wal.last_lsn == 30 and wal.n_segments > 1
    assert wal.fsync_s.count == wal.syncs == 30
    recs = list(wal.replay())
    assert [r.lsn for r in recs] == list(range(1, 31))
    for got, want in zip((recs[6].kinds, recs[6].keys, recs[6].vals),
                         _commit(7)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert [r.lsn for r in wal.replay(after_lsn=25)] == [26, 27, 28, 29, 30]
    sub = list(wal.replay(key_lo=700, key_hi=703))
    assert [r.lsn for r in sub] == [7] and sub[0].keys.tolist() == [
        700, 701, 702, 703]
    wal.close()
    wal2 = WriteAheadLog(str(tmp_path), segment_bytes=4096)
    assert wal2.last_lsn == 30 and wal2.truncated_tail_bytes == 0
    assert wal2.append_commit(*_commit(31))[0] == 31
    wal2.close()


def test_wal_garbage_tail_truncated_on_open(tmp_path):
    wal = WriteAheadLog(str(tmp_path), segment_bytes=1 << 16)
    for i in range(1, 6):
        wal.append_commit(*_commit(i))
    wal.close()
    seg = sorted(os.listdir(tmp_path))[-1]
    with open(tmp_path / seg, "ab") as f:     # a torn, never-fsynced commit
        f.write(b"\x57\x41\x4c\x31 torn garbage bytes")
    wal2 = WriteAheadLog(str(tmp_path))
    assert wal2.last_lsn == 5 and wal2.truncated_tail_bytes > 0
    assert [r.lsn for r in wal2.replay()] == [1, 2, 3, 4, 5]
    wal2.close()
    assert WriteAheadLog(str(tmp_path)).truncated_tail_bytes == 0


def test_wal_corrupt_record_drops_suffix(tmp_path):
    wal = WriteAheadLog(str(tmp_path), segment_bytes=1 << 16)
    offsets = [0]
    for i in range(1, 6):
        offsets.append(offsets[-1] + wal.append_commit(*_commit(i))[1])
    wal.close()
    seg = sorted(os.listdir(tmp_path))[0]
    with open(tmp_path / seg, "r+b") as f:    # corrupt record 3's payload
        f.seek(offsets[2] + 20)
        b = f.read(1)
        f.seek(offsets[2] + 20)
        f.write(bytes([b[0] ^ 0xFF]))
    wal2 = WriteAheadLog(str(tmp_path))
    assert wal2.last_lsn == 2
    assert [r.lsn for r in wal2.replay()] == [1, 2]
    wal2.close()


def test_wal_truncate_upto_keeps_newest_segment(tmp_path):
    wal = WriteAheadLog(str(tmp_path), segment_bytes=4096)
    for i in range(1, 91):
        wal.append_commit(*_commit(i))
    nseg = wal.n_segments
    assert nseg > 2
    assert wal.truncate_upto(wal.last_lsn) == nseg - 1
    assert wal.n_segments == 1 and wal.stats()["gc_segments"] == nseg - 1
    wal.close()
    assert WriteAheadLog(str(tmp_path), segment_bytes=4096).last_lsn == 90


def test_wal_torn_append_via_injector(tmp_path):
    inj = FaultInjector(CrashPoint.AFTER_WAL_APPEND, at_occurrence=3)
    wal = WriteAheadLog(str(tmp_path), segment_bytes=1 << 16, injector=inj)
    wal.append_commit(*_commit(1))
    wal.append_commit(*_commit(2))
    with pytest.raises(SimulatedCrash):
        wal.append_commit(*_commit(3))        # written, torn, never fsynced
    assert inj.fired
    wal2 = WriteAheadLog(str(tmp_path))
    assert wal2.last_lsn == 2 and wal2.truncated_tail_bytes > 0
    wal2.close()


# ---------------------------------------------------------------- one format
def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert cmp.left_list == cmp.right_list, (cmp.left_only, cmp.right_only)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files,
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    for sub in cmp.common_dirs:
        _same_tree(os.path.join(a, sub), os.path.join(b, sub))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wal_segments_are_byte_equal_and_cross_replay(tmp_path, writer):
    ours = WriteAheadLog(str(tmp_path / "port"), segment_bytes=4096)
    theirs = JaxWAL(str(tmp_path / "jax"), segment_bytes=4096)
    for i in range(1, 41):
        assert ours.append_commit(*_commit(i)) == \
            theirs.append_commit(*_commit(i))
    ours.truncate_upto(12)
    theirs.truncate_upto(12)
    ours.close()
    theirs.close()
    _same_tree(tmp_path / "port", tmp_path / "jax")
    # each package reads the other's directory
    src = tmp_path / writer
    reader = (JaxWAL if writer == "port" else WriteAheadLog)(str(src))
    want = (WriteAheadLog if writer == "port" else JaxWAL)(str(src))
    got, exp = list(reader.replay(after_lsn=3)), list(want.replay(after_lsn=3))
    assert [r.lsn for r in got] == [r.lsn for r in exp] and got
    for a, b in zip(got, exp):
        for f in ("kinds", "keys", "vals"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
    assert reader.last_lsn == 40
    reader.close()
    want.close()


def test_engine_snapshots_are_byte_equal_and_cross_load(tmp_path):
    rng = np.random.default_rng(3)
    ours = EngineCheckpointer(str(tmp_path / "port"))
    theirs = JaxEngineCheckpointer(str(tmp_path / "jax"))
    for lsn in (5, 9):
        keys = np.sort(rng.choice(1 << 20, 300, replace=False)).astype(KEYS)
        vals = rng.integers(0, 2**31 - 1, 300).astype(VALS)
        ours.save_snapshot(lsn, keys, vals)
        theirs.save_snapshot(lsn, keys, vals)
    for step in ("step_5", "step_9"):
        _same_tree(tmp_path / "port" / step, tmp_path / "jax" / step)
    a = JaxEngineCheckpointer(str(tmp_path / "port")).load_latest_snapshot()
    b = EngineCheckpointer(str(tmp_path / "jax")).load_latest_snapshot()
    c = ours.load_latest_snapshot()
    assert a[0] == b[0] == c[0] == 9
    for x, y in ((a, c), (b, c)):
        assert np.array_equal(x[1], y[1]) and np.array_equal(x[2], y[2])
        assert x[1].dtype == KEYS and x[2].dtype == VALS
    with pytest.raises(CheckpointError, match="parallel"):
        ours.save_snapshot(10, keys, vals[:-1])


def _np_tree(seed):
    rng = np.random.default_rng(seed)
    return {"layer": {"w": rng.standard_normal((8, 16)).astype(np.float32),
                      "b": rng.standard_normal(16).astype(np.float32)},
            "p": (np.arange(32, dtype=np.float32) / 7)}


def test_checkpoint_with_bf16_leaf_crosses_packages(tmp_path):
    """A nested dict with a bf16 leaf: the port's files equal the JAX
    package's, and each package restores the other's, dtypes kept."""
    t = _np_tree(1)
    ours_tree = {"layer": {k: torch.from_numpy(v)
                           for k, v in t["layer"].items()},
                 "p": torch.from_numpy(t["p"]).to(torch.bfloat16)}
    jax_tree = {"layer": {k: jnp.asarray(v) for k, v in t["layer"].items()},
                "p": jnp.asarray(t["p"]).astype(jnp.bfloat16)}
    Checkpointer(str(tmp_path / "port")).save(4, ours_tree)
    JaxCheckpointer(str(tmp_path / "jax")).save(4, jax_tree)
    _same_tree(tmp_path / "port" / "step_4", tmp_path / "jax" / "step_4")
    got = Checkpointer(str(tmp_path / "jax")).restore(4, ours_tree)
    assert got["p"].dtype == torch.bfloat16
    assert torch.equal(got["p"], ours_tree["p"])
    assert torch.equal(got["layer"]["w"], ours_tree["layer"]["w"])
    back = JaxCheckpointer(str(tmp_path / "port")).restore(4, jax_tree)
    assert back["p"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["p"], np.float32),
                                  ours_tree["p"].float().numpy())
    np.testing.assert_array_equal(np.asarray(back["layer"]["b"]),
                                  t["layer"]["b"])


def test_checkpointer_restores_modules_lists_and_raises(tmp_path):
    lin = torch.nn.Linear(4, 3)
    tree = {"mod": [torch.arange(6.0), np.arange(3, dtype=np.int64)]}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, lin)
    ck.save(2, tree, blocking=False)
    assert ck.latest_step() == 2                  # readers join the writer
    sd = Checkpointer(str(tmp_path)).restore(1, torch.nn.Linear(4, 3))
    assert all(torch.equal(sd[k], v) for k, v in lin.state_dict().items())
    got = ck.restore(2, tree)
    assert isinstance(got["mod"], list)
    assert torch.equal(got["mod"][0], tree["mod"][0])
    assert got["mod"][1].dtype == np.int64
    with pytest.raises(CheckpointError, match="manifest missing"):
        ck.restore(99, tree)
    with pytest.raises(CheckpointError, match="shape mismatch"):
        ck.restore(2, {"mod": [torch.zeros(7), tree["mod"][1]]})
    os.unlink(tmp_path / "step_2" / "mod.0.npy")
    with pytest.raises(CheckpointError, match="leaf file missing"):
        ck.restore(2, tree)


@pytest.mark.parametrize("point,kept", [
    (CrashPoint.MID_CHECKPOINT, 1),             # unprovable tmp deleted
    (CrashPoint.BEFORE_CHECKPOINT_RENAME, 3),   # provable tmp rolled forward
])
def test_checkpointer_crash_protocol(tmp_path, point, kept):
    t1, t3 = _np_tree(1), _np_tree(3)
    Checkpointer(str(tmp_path)).save(1, t1)
    ck = Checkpointer(str(tmp_path), injector=FaultInjector(point))
    with pytest.raises(SimulatedCrash):
        ck.save(3, t3)
    assert os.path.isdir(tmp_path / ".tmp_step_3")
    ck2 = Checkpointer(str(tmp_path))
    assert not os.path.isdir(tmp_path / ".tmp_step_3")
    assert ck2.latest_step() == kept
    got = ck2.restore(kept, t1)
    np.testing.assert_array_equal(got["layer"]["w"],
                                  (t1 if kept == 1 else t3)["layer"]["w"])
    assert ck2.scrub()["clean"]


# --------------------------------------------------------------- crash matrix
_ENGINES = {
    "nbtree": lambda: make_engine("nbtree", f=3, sigma=64),
    "torch-nbtree": lambda: make_engine("torch-nbtree", f=3, sigma=64,
                                        max_nodes=64, device="cpu"),
}
_CFG = dict(max_queue=2048, commit_ops=32, linger_s=5e-4)
_WL = dict(key_space=1 << 14, preload=256, batch_size=128)


def _trace(n_ops=1200, seed=5, preload=256, jax=False):
    kw = _WL | dict(n_ops=n_ops, seed=seed, preload=preload)
    if jax:
        return make_jax_trace(make_jax_workload("delete-churn", **kw),
                              JaxPoisson(50_000.0))
    return make_trace(make_workload("delete-churn", **kw),
                      PoissonArrivals(50_000.0))


def _frontend(engine, directory, injector=None, ckpt_every=4):
    return IngestFrontend(
        engine, FrontendConfig(**_CFG),
        durability=DurabilityConfig(str(directory), segment_bytes=4096,
                                    checkpoint_every_commits=ckpt_every),
        injector=injector)


def _oracle(preload, acked):
    """Sorted-dict ground truth: the preload, then every acked commit in
    LSN order (an op is acked iff its commit's fsync returned)."""
    d = dict(zip(preload.keys.tolist(), preload.vals.tolist()))
    for _lsn, kinds, keys, vals in acked:
        for kk, k, v in zip(kinds.tolist(), keys.tolist(), vals.tolist()):
            if kk == int(OpKind.INSERT):
                d[k] = v
            else:
                d.pop(k, None)
    return sorted(d.items())


def _recovered(directory, name, preload, acked, last_lsn):
    rr = recover(str(directory), _ENGINES[name])
    rk, rv = rr.engine.dump_live()
    assert list(zip(rk.tolist(), rv.tolist())) == _oracle(preload, acked), \
        "lost, resurrected or stale keys after recovery"
    assert rr.last_lsn == last_lsn == rr.engine.stats().applied_lsn
    return rr


# occurrences as in the JAX package's matrix: WAL points fire per commit,
# checkpoint points per snapshot (1 = the preload's, 2 = the first periodic)
_MATRIX = [
    (CrashPoint.BEFORE_WAL_APPEND, 4),
    (CrashPoint.AFTER_WAL_APPEND, 4),      # torn tail: durable prefix only
    (CrashPoint.AFTER_WAL_FSYNC, 4),       # acked but never applied
    (CrashPoint.AFTER_APPLY, 4),
    (CrashPoint.MID_CASCADE, 3),           # index mid-restructure
    (CrashPoint.MID_CHECKPOINT, 2),        # leaves written, no manifest
    (CrashPoint.BEFORE_CHECKPOINT_RENAME, 2),
    (CrashPoint.AFTER_CHECKPOINT, 2),      # snapshot done, WAL not truncated
]


@pytest.mark.parametrize("name", sorted(_ENGINES))
@pytest.mark.parametrize("point,occurrence", _MATRIX,
                         ids=[p.value for p, _ in _MATRIX])
def test_crash_matrix_recovers_exact_acked_prefix(tmp_path, name, point,
                                                  occurrence):
    trace = _trace()
    inj = FaultInjector(point, at_occurrence=occurrence)
    fe = _frontend(_ENGINES[name](), tmp_path / "port", injector=inj)
    with pytest.raises(SimulatedCrash) as exc:
        fe.run(trace)
    assert inj.fired and exc.value.point is point
    if name == "nbtree":
        # the JAX package's frontend, killed at the same point, acked the
        # same commits and left the same log behind
        jinj = JaxInjector(JaxCrashPoint(point.value),
                           at_occurrence=occurrence)
        jfe = JaxFrontend(
            make_jax_engine("nbtree", f=3, sigma=64),
            JaxFrontendConfig(**_CFG),
            durability=JaxDurability(str(tmp_path / "jax"),
                                     segment_bytes=4096,
                                     checkpoint_every_commits=4),
            injector=jinj)
        with pytest.raises(JaxCrash):
            jfe.run(_trace(jax=True))
        assert [a[0] for a in fe.acked] == [a[0] for a in jfe.acked]
        for a, b in zip(fe.acked, jfe.acked):
            assert all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))
        _same_tree(tmp_path / "port" / "wal", tmp_path / "jax" / "wal")
    _recovered(tmp_path / "port", name, trace.preload, fe.acked,
               fe.last_acked_lsn)


@pytest.mark.parametrize("name", sorted(_ENGINES))
@pytest.mark.parametrize("crash", [True, False], ids=["crash", "clean"])
def test_restart_resumes_lsn_chain(tmp_path, name, crash):
    """Recover (after a kill, or after a clean run), serve a second trace
    through a fresh frontend on the same directory: the first resumed
    commit is ``last_lsn + 1``, the chain has no gap, and a final recovery
    equals the oracle of the preload and both acked prefixes."""
    trace1 = _trace(n_ops=1200 if crash else 500)
    inj = FaultInjector(CrashPoint.AFTER_WAL_FSYNC, at_occurrence=9) \
        if crash else None
    fe1 = _frontend(_ENGINES[name](), tmp_path, injector=inj)
    if crash:
        with pytest.raises(SimulatedCrash):
            fe1.run(trace1)
        assert len(fe1.acked) == 9
    else:
        fe1.run(trace1)
        assert fe1.acked
    rr = _recovered(tmp_path, name, trace1.preload, fe1.acked,
                    fe1.last_acked_lsn)
    fe2 = _frontend(rr.engine, tmp_path)
    assert fe2.last_acked_lsn == rr.last_lsn
    rep = fe2.run(_trace(n_ops=600, seed=9, preload=0))
    lsns = [a[0] for a in fe2.acked]
    assert lsns == list(range(rr.last_lsn + 1, rr.last_lsn + 1 + len(lsns)))
    assert rep["durability"]["last_acked_lsn"] == fe2.last_acked_lsn
    _recovered(tmp_path, name, trace1.preload, fe1.acked + fe2.acked,
               fe2.last_acked_lsn)


# ------------------------------------------------------------ protocol repairs
@pytest.mark.parametrize("name", sorted(_ENGINES))
def test_note_applied_monotone(name):
    eng = _ENGINES[name]()
    assert eng.applied_lsn == eng.stats().applied_lsn == 0
    eng.note_applied(7)
    eng.note_applied(3)          # a stale LSN never moves the watermark back
    assert eng.stats().applied_lsn == 7


def test_live_range_observers_match_jax_engine():
    """``dump_live_range``/``count_live_range`` on ``torch-nbtree`` equal
    ``jax-nbtree``'s after the same writes, and observe for free."""
    rng = np.random.default_rng(1)
    keys = (rng.choice(4095, size=256, replace=False) + 1).astype(KEYS)
    eng = make_engine("torch-nbtree", f=4, sigma=64, max_nodes=64,
                      device="cpu")
    ref = make_jax_engine("jax-nbtree", f=4, sigma=64, max_nodes=64)
    for e, Batch in ((eng, OpBatch), (ref, JaxOpBatch)):
        e.apply(Batch.inserts(keys, keys.astype(VALS)))
        e.apply(Batch.deletes(keys[:64]))
        e.drain()
    live = np.sort(keys[64:])
    for lo, hi in ((0, 2**64 - 1), (100, 900), (int(live[3]), int(live[3])),
                   (900, 100), (5000, 6000)):
        io = eng.io_time_s()
        a, b = eng.dump_live_range(lo, hi), ref.dump_live_range(lo, hi)
        assert eng.io_time_s() == io
        assert a[0].dtype == KEYS and a[1].dtype == VALS
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        want = live[(live >= lo) & (live <= hi)]
        assert np.array_equal(a[0], want) and np.array_equal(a[1], want)
        assert eng.count_live_range(lo, hi) == \
            ref.count_live_range(lo, hi) == len(want)


# ------------------------------------------------------------- one big batch
def _guard_reads(monkeypatch):
    reads = []
    real = torch_nbtree._flush_lens

    def counting(*a, **k):
        out = real(*a, **k)
        reads.append(out.tolist())
        return out

    monkeypatch.setattr(torch_nbtree, "_flush_lens", counting)
    return reads


def test_big_sorted_batch_overflows_jax_but_loads_in_the_port(monkeypatch):
    """4096 sorted keys in one batch at sigma 64: the JAX index overfills
    a child and asserts; the port makes room first and keeps every pair."""
    reads = _guard_reads(monkeypatch)
    keys = np.arange(1, 4097, dtype=np.uint32) * 5
    vals = np.arange(4096, dtype=np.int32)
    with pytest.raises(AssertionError, match="child run overflow"):
        j = JaxIndex(f=4, sigma=64, max_nodes=64)
        j.insert_batch(keys, vals)
        j.drain()
    eng = make_engine("torch-nbtree", f=4, sigma=64, max_nodes=64,
                      device="cpu")
    eng.apply(OpBatch.inserts(keys, vals))
    eng.drain()
    eng.idx.check_invariants()
    assert reads, "the guard never read: the case no longer covers it"
    dk, dv = eng.dump_live()
    assert np.array_equal(dk, keys.astype(KEYS))
    assert np.array_equal(dv, vals.astype(VALS))
    res = eng.apply(OpBatch.queries(keys[::97]))
    assert res.found.all() and np.array_equal(res.values, vals[::97])
