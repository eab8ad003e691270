"""The port's open-loop ingest layer (``repro_torch.ingest``) vs the JAX
package's, on the CPU.

* Arrival processes and traces equal the JAX package's bit for bit.
* On the host ``nbtree`` tier (a sim clock) ``run_open_loop``'s report is a
  pure function of (trace, config), so the port's must equal the JAX
  package's field for field: under Poisson and MMPP arrivals, with and
  without a WAL, with the obs layer on (and its trace file byte-equal).
* On the device tier the port's frontend over ``torch-nbtree`` (plain
  versions on the CPU) equals the JAX package's over ``jax-nbtree`` in
  every field but the wall-clock ones.
* The shed, group-commit and debt-bound cases of the JAX package's ingest
  tests, over the port; the driver's open-loop report and CLI.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.core.engine_api import make_engine as make_jax_engine
from repro.ingest import DiurnalArrivals as JaxDiurnal
from repro.ingest import DurabilityConfig as JaxDurability
from repro.ingest import FrontendConfig as JaxFrontendConfig
from repro.ingest import MMPPArrivals as JaxMMPP
from repro.ingest import PoissonArrivals as JaxPoisson
from repro.ingest import make_trace as make_jax_trace
from repro.ingest import multiplex as jax_multiplex
from repro.ingest import run_open_loop as jax_run_open_loop
from repro.ingest.slo import SLOTracker as JaxSLOTracker
from repro.ingest.slo import _tail_summary as jax_tail_summary
from repro.obs import ObsConfig as JaxObsConfig
from repro.wal import FaultSchedule as JaxFaultSchedule
from repro.workloads import make_workload as make_jax_workload
from repro_torch.core.engine_api import make_engine
from repro_torch.ingest import (DiurnalArrivals, DurabilityConfig,
                                FrontendConfig, IngestFrontend, MMPPArrivals,
                                PoissonArrivals, make_arrivals, make_trace,
                                multiplex, run_open_loop)
from repro_torch.ingest.slo import SLOTracker, _tail_summary
from repro_torch.obs import ObsConfig
from repro_torch.wal import FaultSchedule
from repro_torch.workloads import make_workload
from repro_torch.workloads.driver import main as driver_main
from repro_torch.workloads.driver import run_open_workload

PROCESSES = {
    "poisson": (lambda: PoissonArrivals(5000.0),
                lambda: JaxPoisson(5000.0)),
    "mmpp": (lambda: MMPPArrivals(20000.0, 100.0, mean_on_s=0.01,
                                  mean_off_s=0.03),
             lambda: JaxMMPP(20000.0, 100.0, mean_on_s=0.01,
                             mean_off_s=0.03)),
    "diurnal": (lambda: DiurnalArrivals(5000.0, amplitude=0.8,
                                        period_s=0.25),
                lambda: JaxDiurnal(5000.0, amplitude=0.8, period_s=0.25)),
}


def _wl(mix="insert-heavy", jax_pkg=False, **kw):
    kw = dict(key_space=1 << 16, n_ops=512, preload=256,
              batch_size=128) | kw
    return (make_jax_workload if jax_pkg else make_workload)(mix, **kw)


def _same_batch(a, b):
    for f in ("kinds", "keys", "vals", "his"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


# ------------------------------------------------------------------- arrivals
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("proc", sorted(PROCESSES))
def test_arrivals_and_traces_match_jax(proc, seed):
    ours, theirs = PROCESSES[proc][0](), PROCESSES[proc][1]()
    a = ours.times(np.random.default_rng(seed), 2000)
    b = theirs.times(np.random.default_rng(seed), 2000)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.all(np.diff(a) >= 0.0)
    assert ours.describe() == theirs.describe()
    ta = make_trace(_wl(seed=seed), ours, arrival_seed=seed + 1)
    tb = make_jax_trace(_wl(seed=seed, jax_pkg=True), theirs,
                        arrival_seed=seed + 1)
    assert np.array_equal(ta.t_arrive, tb.t_arrive)
    _same_batch(ta.ops, tb.ops)
    _same_batch(ta.preload, tb.preload)
    assert (ta.arrival, ta.seed, ta.duration_s) == \
        (tb.arrival, tb.seed, tb.duration_s)
    half = ta.duration_s / 2
    ha = make_trace(_wl(seed=seed), ours, duration_s=half,
                    arrival_seed=seed + 1)
    hb = make_jax_trace(_wl(seed=seed, jax_pkg=True), theirs,
                        duration_s=half, arrival_seed=seed + 1)
    assert 0 < len(ha) == len(hb) < 512
    assert np.array_equal(ha.t_arrive, hb.t_arrive)
    _same_batch(ha.ops, hb.ops)


def test_multiplex_and_factory_match_jax():
    ours = {s: make_trace(_wl(seed=s, n_ops=200), PoissonArrivals(1e4))
            for s in (2, 0, 1)}
    theirs = {s: make_jax_trace(_wl(seed=s, n_ops=200, jax_pkg=True),
                                JaxPoisson(1e4)) for s in (2, 0, 1)}
    for x, y in zip(multiplex(ours), jax_multiplex(theirs)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert [len(x) for x in multiplex({})] == [0, 0, 0]
    assert isinstance(make_arrivals("mmpp", 10.0), MMPPArrivals)
    with pytest.raises(KeyError):
        make_arrivals("no-such-process", 1.0)


def test_slo_accounting_matches_jax():
    rng = np.random.default_rng(2)
    samples = np.concatenate([rng.lognormal(-8, 1, 999), [1.0]])
    assert _tail_summary(samples) == jax_tail_summary(samples)
    assert _tail_summary(np.empty(0)) == jax_tail_summary(np.empty(0))
    reps = []
    for tr in (SLOTracker(stall_factor=4.0), JaxSLOTracker(stall_factor=4.0)):
        for i in range(20):
            tr.record_queue_depth(i)
            tr.record_commit(t_commit=float(i), kinds=["insert", "query"],
                             e2e_s=[1e-4, 2e-4], queue_delay_s=[0.0, 1e-5],
                             qdepth_after=i % 3, service_s=1e-4,
                             maintain_s=1e-5, debt=i % 2)
        tr.record_commit(t_commit=21.0, kinds=["insert"], e2e_s=[0.5],
                         queue_delay_s=[0.4], qdepth_after=37,
                         service_s=0.5, maintain_s=0.0, debt=3)
        tr.record_shed("query", 4)
        reps.append(tr.report(offered={"insert": 21, "query": 24},
                              t_end=22.0))
    assert reps[0] == reps[1]
    assert reps[0]["stalls"]["n_stall_commits"] == 1
    assert reps[0]["stalls"]["ops_queued_behind_stalls"] == 37


# ------------------------------------------------ sim tier: field for field
_CFG = dict(max_queue=1024, commit_ops=32, linger_s=5e-4)


def _sim_report(pkg, proc, durable, tmp_path):
    """One open-loop run on the host ``nbtree`` tier through ``pkg``'s
    modules, obs on; the report as canonical JSON and the trace's bytes."""
    port = pkg == "port"
    if proc == "poisson":
        process = (PoissonArrivals if port else JaxPoisson)(50_000.0)
    else:
        process = (MMPPArrivals if port else JaxMMPP)(
            200_000.0, 1000.0, mean_on_s=0.002, mean_off_s=0.006)
    trace = (make_trace if port else make_jax_trace)(
        _wl(mix="delete-churn", seed=4, n_ops=1200, jax_pkg=not port),
        process)
    engine = (make_engine if port else make_jax_engine)("nbtree", f=3,
                                                        sigma=128)
    durability = None
    if durable:
        durability = (DurabilityConfig if port else JaxDurability)(
            str(tmp_path / pkg), segment_bytes=4096,
            checkpoint_every_commits=8)
    trace_path = str(tmp_path / f"{pkg}.trace.json")
    obs = (ObsConfig if port else JaxObsConfig)(window_s=0.002,
                                               trace_path=trace_path)
    chaos = (FaultSchedule if port else JaxFaultSchedule).parse(
        "fsync_stall@0.004::0.001;latency_spike@0.006:wal:4:0.002;"
        "bit_flip@0.5:nowhere")
    rep = (run_open_loop if port else jax_run_open_loop)(
        engine, trace, config=(FrontendConfig if port else JaxFrontendConfig)(
            **_CFG), durability=durability, obs=obs, chaos=chaos)
    ol = rep["open_loop"]
    ol["obs"]["trace"]["path"] = "<path>"
    if durable:
        ol["durability"]["config"]["directory"] = "<dir>"
    with open(trace_path, "rb") as f:
        return json.dumps(rep, sort_keys=True), f.read(), rep


@pytest.mark.parametrize("durable", [False, True], ids=["no-wal", "wal"])
@pytest.mark.parametrize("proc", ["poisson", "mmpp"])
def test_sim_tier_report_equals_jax(tmp_path, proc, durable):
    ours, our_trace, rep = _sim_report("port", proc, durable, tmp_path)
    theirs, their_trace, _ = _sim_report("jax", proc, durable, tmp_path)
    assert ours == theirs
    assert our_trace == their_trace
    ol = rep["open_loop"]
    assert ol["service_model"] == "charged" and ol["n_done"] > 0
    assert ol["obs"]["n_active_windows"] > 0
    assert len(ol["chaos"]["fired"]) == 2 and ol["chaos"]["unrouted"]
    if durable:
        assert ol["durability"]["checkpoints"]["taken"] > 1
    if proc == "mmpp":
        assert ol["queue"]["max_depth"] > _CFG["commit_ops"]


# ---------------------------------------------------- device tier, CPU
#: fields measured on the wall clock: everything else must be equal
WALL_STATS = ("io_time_s", "maintain_wall_s", "maintain_unit_p50_s",
              "maintain_unit_p99_s", "maintain_unit_p100_s")


def _device_report(port: bool):
    trace = (make_trace if port else make_jax_trace)(
        _wl(n_ops=512, preload=128, batch_size=64, seed=5, jax_pkg=not port),
        (PoissonArrivals if port else JaxPoisson)(1e6))
    if port:
        eng = make_engine("torch-nbtree", f=4, sigma=64, max_nodes=64,
                          device="cpu")
    else:
        eng = make_jax_engine("jax-nbtree", f=4, sigma=64, max_nodes=64)
        real = eng.idx.query_batch

        def query_op_by_op(*a, **k):
            # same XLA ops without a compile per query shape
            with jax.disable_jit():
                return real(*a, **k)

        eng.idx.query_batch = query_op_by_op
    cfg = (FrontendConfig if port else JaxFrontendConfig)(commit_ops=64)
    rep = (run_open_loop if port else jax_run_open_loop)(eng, trace,
                                                         config=cfg)
    rep.pop("engine")
    for k in ("engine", *WALL_STATS):
        rep["stats"].pop(k)
    return rep


def test_device_tier_report_equals_jax_but_wall_clock():
    ours, theirs = _device_report(True), _device_report(False)
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs,
                                                          sort_keys=True)
    ol, st = ours["open_loop"], ours["stats"]
    assert ol["service_model"] == "virtual" and ol["n_done"] == 512
    assert st["clock"] == "wall" and st["maintain_units"] > 0
    assert st["n_queries"] > 0 and st["bloom_probes"] > 0
    assert st["device_dispatches"] > 0 and st["pending_debt"] == 0


# ---------------------------------------------------- frontend behaviour
_ENGINES = {
    "nbtree": lambda: make_engine("nbtree", f=3, sigma=128),
    "torch-nbtree": lambda: make_engine("torch-nbtree", f=3, sigma=128,
                                        max_nodes=64, device="cpu"),
}


@pytest.mark.parametrize("name", sorted(_ENGINES))
def test_admission_control_sheds_under_overload(name):
    cfg = FrontendConfig(max_queue=32, commit_ops=16, linger_s=1e-4)
    trace = make_trace(_wl(seed=6, n_ops=768), PoissonArrivals(2e7))
    eng = _ENGINES[name]()
    rep = IngestFrontend(eng, cfg).run(trace)
    assert rep["n_shed"] > 0
    assert rep["n_done"] + rep["n_shed"] == len(trace)
    assert rep["queue"]["max_depth"] <= cfg.max_queue
    st = eng.stats()
    applied = st.n_inserts + st.n_deletes + st.n_queries + st.n_ranges
    assert applied == rep["n_done"] + len(trace.preload), \
        "shed ops must never reach the engine"
    assert rep["shed_rate"] == pytest.approx(
        rep["n_shed"] / (rep["n_shed"] + rep["n_done"]))


@pytest.mark.parametrize("name", sorted(_ENGINES))
def test_group_commit_bounds(name):
    cfg = FrontendConfig(**_CFG)
    fast = IngestFrontend(_ENGINES[name](), cfg).run(
        make_trace(_wl(seed=3), PoissonArrivals(5e7)))
    assert 4 < fast["server"]["mean_commit_ops"] <= cfg.commit_ops
    slow = IngestFrontend(_ENGINES[name](), cfg).run(
        make_trace(_wl(seed=3), PoissonArrivals(100.0)))
    assert slow["server"]["mean_commit_ops"] < 2.0
    assert slow["server"]["utilization"] < 0.2


@pytest.mark.parametrize("name", sorted(_ENGINES))
def test_debt_bounded_at_saturation(name):
    """The deamortized bound survives overload (the JAX package's bound
    on ``nbtree``: debt <= one cascade; the device queue drains by one
    unit a commit)."""
    cfg = FrontendConfig(max_queue=256, commit_ops=32, linger_s=1e-4)
    rep = IngestFrontend(_ENGINES[name](), cfg).run(
        make_trace(_wl(seed=10, n_ops=1024), PoissonArrivals(2e8)))
    bound = 1 if name == "nbtree" else 2
    assert rep["stalls"]["debt_max"] <= bound
    assert rep["pending_debt_at_end"] <= bound


def test_frontend_config_validation():
    with pytest.raises(AssertionError):
        FrontendConfig(max_queue=8, commit_ops=16)
    with pytest.raises(AssertionError):
        FrontendConfig(linger_s=-1.0)
    with pytest.raises(AssertionError):
        DurabilityConfig("d", segment_bytes=100)


# --------------------------------------------------------------------- driver
def test_driver_open_loop_report_shape():
    from repro_torch.workloads.driver import SCHEMA_VERSION
    eng = make_engine("torch-nbtree", f=4, sigma=128, device="cpu")
    rep = run_open_workload(eng, _wl(seed=1), arrival="poisson",
                            rate=5000.0, maintain_budget=4)
    assert rep["schema_version"] == SCHEMA_VERSION
    assert rep["arrival"]["process"] == "poisson"
    assert rep["open_loop"]["n_done"] == 512
    assert rep["open_loop"]["config"]["maintain_budget"] == 4
    assert rep["workload"]["mix"] == {"insert": 0.95, "query": 0.05}
    assert rep["stats"]["engine"] == "torch-nbtree"
    json.dumps(rep)


def test_driver_open_loop_cli_on_cpu(tmp_path, capsys):
    out, tr = tmp_path / "ol.json", tmp_path / "trace.json"
    driver_main(["--mix", "insert-heavy", "--ops", "512", "--batch", "128",
                 "--preload", "256", "--key-space", "65536", "--device",
                 "cpu", "--arrival", "mmpp", "--rate", "40000",
                 "--metrics-window", "0.002", "--trace", str(tr),
                 "--chaos", "fsync_stall@0.001", "--out", str(out)])
    rep = json.loads(out.read_text())
    assert rep["device"] == "cpu" and rep["arrival"]["process"] == "mmpp"
    ol = rep["open_loop"]
    assert ol["n_done"] + ol["n_shed"] == 512
    assert ol["obs"]["trace"]["events"] > 0 and tr.exists()
    assert {"commit", "dispatch"} <= set(ol["obs"]["trace"]["categories"])
    assert ol["chaos"]["fired"][0]["kind"] == "fsync_stall"
    assert "virtual e2e insert" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        driver_main(["--device", "cpu", "--trace", str(tr)])
    assert exc.value.code == 2


def test_run_open_loop_report_sections_match_jax_shape():
    """The report's keys (every level) equal the JAX package's."""
    def keys(d, pre=""):
        out = set()
        for k, v in d.items():
            out.add(pre + k)
            if isinstance(v, dict) and k not in ("per_kind_e2e",):
                out |= keys(v, pre + k + ".")
        return out

    a = run_open_loop(make_engine("nbtree", f=3, sigma=128),
                      make_trace(_wl(seed=2), PoissonArrivals(1e4)))
    b = jax_run_open_loop(make_jax_engine("nbtree", f=3, sigma=128),
                          make_jax_trace(_wl(seed=2, jax_pkg=True),
                                         JaxPoisson(1e4)))
    assert keys(a) == keys(b)
    assert dataclasses.asdict(FrontendConfig()) == dataclasses.asdict(
        JaxFrontendConfig())
