"""The port's replication layer (``repro_torch.replication``) vs the JAX
package's, on the CPU.

Replication runs on the sim clock only (the JAX package's replicas assert
it), so a replicated run is a pure function of (trace, config, chaos
schedule): the port's report equals the JAX package's field for field
under quorum and primary acks, through a primary crash, a latency spike
and a bit flip; every node's WAL directory is byte-equal to its JAX
twin's, and each package replays the other's.  The differential the layer
exists for holds on the port's own run: no acked write lost, none
resurrected.
"""
import json

import numpy as np
import pytest

from repro.core.engine_api import make_engine as make_jax_engine
from repro.ingest import FrontendConfig as JaxFrontendConfig
from repro.ingest import PoissonArrivals as JaxPoisson
from repro.ingest import make_trace as make_jax_trace
from repro.obs import ObsConfig as JaxObsConfig
from repro.replication import ReplicationConfig as JaxReplicationConfig
from repro.replication import run_replicated as jax_run_replicated
from repro.wal import FaultSchedule as JaxFaultSchedule
from repro.wal import WriteAheadLog as JaxWAL
from repro.workloads import make_workload as make_jax_workload
from repro_torch.core.engine_api import OpKind, make_engine
from repro_torch.ingest import FrontendConfig, PoissonArrivals, make_trace
from repro_torch.obs import ObsConfig
from repro_torch.replication import (ReplicaGroup, ReplicaNode,
                                     ReplicatedFrontend, ReplicationConfig,
                                     run_replicated)
from repro_torch.wal import FaultSchedule, WriteAheadLog
from repro_torch.workloads import make_workload
from repro_torch.workloads.driver import main as driver_main

#: a primary crash, a group-wide latency spike and a replica bit flip
CHAOS = ("crash@0.012:g1/primary;latency_spike@0.006:g0:6:0.004;"
         "bit_flip@0.018:g2/r0")
FRONTEND = dict(max_queue=4096, commit_ops=32, linger_s=2e-4)


def _trace(port: bool, n_ops=1500, seed=0, preload=512):
    wl = (make_workload if port else make_jax_workload)(
        "delete-churn", key_space=1 << 16, n_ops=n_ops, preload=preload,
        batch_size=128, seed=seed)
    return (make_trace if port else make_jax_trace)(
        wl, (PoissonArrivals if port else JaxPoisson)(60_000.0))


def _replicated(port, tier, ack, tmp_path):
    d = tmp_path / ("port" if port else "jax")
    kw = {"nbtree": dict(f=3, sigma=128), "lsm": dict(mem_pairs=128)}[tier]

    def factory():
        return (make_engine if port else make_jax_engine)(tier, **kw)

    rep_cfg = (ReplicationConfig if port else JaxReplicationConfig)(
        replicas=3, ack_mode=ack, heartbeat_timeout_s=0.003,
        segment_bytes=4096)
    chaos = (FaultSchedule if port else JaxFaultSchedule).parse(CHAOS)
    obs = (ObsConfig if port else JaxObsConfig)(window_s=0.005)
    out = (run_replicated if port else jax_run_replicated)(
        factory, _trace(port), str(d), groups=3, replication=rep_cfg,
        config=(FrontendConfig if port else JaxFrontendConfig)(**FRONTEND),
        chaos=chaos, obs=obs, window_s=0.005)
    return json.dumps(out, sort_keys=True, default=float), out, d


@pytest.mark.parametrize("tier", ["nbtree", "lsm"])
@pytest.mark.parametrize("ack", ["quorum", "primary"])
def test_replicated_report_under_chaos_equals_jax(tmp_path, ack, tier):
    ours, rep, d = _replicated(True, tier, ack, tmp_path)
    theirs, _, jd = _replicated(False, tier, ack, tmp_path)
    assert ours == theirs
    r = rep["replication"]
    assert [ev["outcome"] for ev in r["failovers"]] == ["promoted"]
    assert r["failovers"][0]["gid"] == 1 and r["failovers"][0]["rto_s"] > 0
    assert len(r["chaos"]["fired"]) == 3 and r["failed_groups"] == []
    assert r["availability"][1]["downtime_s"] > 0
    assert rep["n_done"] > 0 and r["acked_commits"] > 0
    # every node directory byte-equal to its twin's
    files = sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file())
    assert len(files) >= 9
    assert files == sorted(p.relative_to(jd) for p in jd.rglob("*")
                           if p.is_file())
    for rel in files:
        assert (d / rel).read_bytes() == (jd / rel).read_bytes(), rel


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_replica_logs_replay_across_packages(tmp_path, writer):
    """Each package replays the other's replica segment directories to the
    same records."""
    _, _, d = _replicated(writer == "port", "nbtree", "quorum", tmp_path)
    dirs = sorted({p.parent for p in d.rglob("wal_*.log")})
    assert len(dirs) >= 9
    n = 0
    for sub in dirs:
        ours, theirs = WriteAheadLog(str(sub)), JaxWAL(str(sub))
        a, b = list(ours.replay()), list(theirs.replay())
        assert [r.lsn for r in a] == [r.lsn for r in b]
        for x, y in zip(a, b):
            for f in ("kinds", "keys", "vals"):
                assert np.array_equal(getattr(x, f), getattr(y, f))
        assert ours.last_lsn == theirs.last_lsn
        n += len(a)
        ours.close()
        theirs.close()
    assert n > 0


def _differential(fe, trace):
    """(lost acked, resurrected, lost to failed groups) vs the acked
    prefix, from the surviving primaries."""
    oracle = dict(zip(trace.preload.keys.tolist(),
                      trace.preload.vals.tolist()))
    for _gid, _lsn, kinds, keys, vals in fe.acked:
        for kk, k, v in zip(kinds.tolist(), keys.tolist(), vals.tolist()):
            if kk == int(OpKind.INSERT):
                oracle[int(k)] = int(v)
            else:
                oracle.pop(int(k), None)
    failed = {g.gid for g in fe.groups if g.failed}
    live = {}
    for g in fe.groups:
        if g.gid not in failed:
            lk, lv = g.primary.engine.dump_live()
            live.update(zip(lk.tolist(), lv.tolist()))
    okeys = np.fromiter(oracle, np.uint64, len(oracle))
    gids = fe.partitioner.shard_of(okeys)
    lost_range = sum(int(g) in failed for g in gids)
    lost = sum(1 for k, g in zip(okeys.tolist(), gids)
               if int(g) not in failed and live.get(k) != oracle[k])
    return lost, sum(1 for k in live if k not in oracle), lost_range


@pytest.mark.parametrize("replicas,failed", [(2, []), (1, [1])])
def test_kill_primary_differential(tmp_path, replicas, failed):
    """R=2 survives a primary kill with nothing acked lost; R=1 loses the
    range for good and its survivors stay exact."""
    trace = _trace(True, n_ops=2000, seed=1)
    fe = ReplicatedFrontend(
        lambda: make_engine("nbtree", f=3, sigma=128), str(tmp_path),
        groups=3, replication=ReplicationConfig(
            replicas=replicas, heartbeat_timeout_s=0.003),
        config=FrontendConfig(**FRONTEND),
        chaos=FaultSchedule.parse("crash@0.01:g1/primary"), window_s=0.005)
    rep = fe.run(trace)["replication"]
    assert rep["failed_groups"] == failed
    lost, resurrected, lost_range = _differential(fe, trace)
    assert (lost, resurrected) == (0, 0)
    assert (lost_range > 0) == bool(failed)


def test_replicas_run_on_the_sim_clock_only(tmp_path):
    eng = make_engine("torch-nbtree", f=4, sigma=64, max_nodes=16,
                      device="cpu")
    with pytest.raises(AssertionError, match="sim clock only"):
        ReplicaNode("g0/n0", eng, str(tmp_path / "n0"))
    g = ReplicaGroup(0, str(tmp_path / "g"), lambda: make_engine("lsm"),
                     ReplicationConfig(replicas=3, ack_mode="quorum"))
    kinds = np.full(8, int(OpKind.INSERT), np.int8)
    keys = np.arange(8, dtype=np.uint64)
    lsn, s_quorum = g.commit(kinds, keys, keys.astype(np.int64))
    assert lsn == 1 and all(r.durable_lsn == 1 for r in g.replicas())
    with pytest.raises(SystemExit):
        driver_main(["--engines", "torch-nbtree", "--device", "cpu",
                     "--replicas", "2", "--arrival", "poisson"])


def test_driver_replicated_cli(tmp_path, capsys):
    out = tmp_path / "repl.json"
    driver_main(["--engines", "nbtree", "lsm", "--shards", "2",
                 "--replicas", "3", "--ack", "primary", "--arrival",
                 "poisson", "--rate", "40000", "--ops", "1024", "--batch",
                 "128", "--preload", "256", "--key-space", "65536",
                 "--chaos", "crash@0.008:g0/primary", "--out", str(out)])
    data = json.loads(out.read_text())
    assert [r["replication"]["n_groups"] for r in data["reports"]] == [2, 2]
    for rep in data["reports"]:
        r = rep["replication"]
        assert r["config"]["replicas"] == 3
        assert r["config"]["ack_mode"] == "primary"
        assert len(r["failovers"]) == 1 and r["failed_groups"] == []
        assert rep["n_done"] + rep["n_shed"] == 1024
    assert "failovers=1" in capsys.readouterr().out
