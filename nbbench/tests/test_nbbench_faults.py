"""The check against what must fail it: the control (the reference with
16-bit values in the program's place) and faults planted under a whole run
of each cell, at a tiny size on the CPU."""
import json
from pathlib import Path

import numpy as np
import pytest

from nbbench.control import NarrowValueStore
from nbbench.harness import Run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
LATER = json.loads((Path(__file__).with_name("later_cells.json")).read_text())
WORKLOADS = BENCH["workloads"] + LATER["workloads"]
CELLS = [w["name"] for w in WORKLOADS]
CONFIGS = {w["name"]: w["config"] for w in WORKLOADS}
FILES = {c["name"]: c["file"] for c in BENCH["configs"]}


def _run(cell, tiny, root, cls=Run, **kw):
    cfg = json.loads((ROOT / FILES[CONFIGS[cell]]).read_text())
    config, mix = tiny(cell, cfg["engine_kwargs"])
    return cls(cell, 2**31 + 13, 0.1, False, root=root, device="cpu",
               config_overrides=config, mix_overrides=mix,
               log=lambda *a: None, **kw).run()


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, tiny, root_of):
    out = _run(cell, tiny, root_of(cell),
               engine_factory=lambda cfg, dev: NarrowValueStore())
    assert not out["correct"]
    assert max(c["value"] for c in out["checks"].values()) >= 3


class _Result:
    """The engine's result object, for the ops a fault left out."""

    def __init__(self, n):
        self.found = np.zeros(n, bool)
        self.values = np.full(n, -1, np.int64)
        self.range_hits = [(np.zeros(0, np.uint64), np.zeros(0, np.int64))] * n
        self.range_truncated = np.zeros(n, bool)


def _subset_apply(eng, keep):
    """``apply`` that serves only the ops ``keep(batch)`` selects."""
    plain = eng.apply

    def apply(batch):
        sel = np.flatnonzero(keep(batch))
        out = _Result(len(batch))
        if len(sel):
            sub = plain(type(batch)(batch.kinds[sel], batch.keys[sel],
                                    batch.vals[sel], batch.his[sel]))
            out.found[sel], out.values[sel] = sub.found, sub.values
            for j, i in enumerate(sel):
                out.range_hits[i] = sub.range_hits[j]
        return out
    eng.apply = apply


def _altered(monkeypatch):
    """Every answer and every merged value off by one where the kernels
    produce them."""
    from repro_torch.kernels import ops

    def bump(name, index):
        plain = getattr(ops, name)

        def fn(*a, **k):
            out = list(plain(*a, **k))
            out[index] = out[index] + 1
            return tuple(out)
        monkeypatch.setattr(ops, name, fn)

    bump("merge_sorted", 1)
    bump("merge_sorted_batch", 1)
    bump("sorted_search_rows", 1)
    bump("range_scan_rows", 1)


FAULTS = {
    # a step that leaves the state as it was: the window's writes dropped
    "state_unchanged": lambda eng, mp: _subset_apply(
        eng, lambda b: np.asarray(b.kinds) != 0),
    # half of each batch left out
    "half_batch": lambda eng, mp: _subset_apply(
        eng, lambda b: np.arange(len(b)) < len(b) // 2),
    # an answer altered where it is produced
    "answer_altered": lambda eng, mp: _altered(mp),
}
CAN_HAVE = [(c, f) for c in CELLS for f in FAULTS
            if not (f == "state_unchanged" and "ycsb-c" in c)]


@pytest.mark.parametrize("cell,fault", CAN_HAVE)
def test_a_planted_fault_is_not_correct(cell, fault, tiny, monkeypatch,
                                       root_of):
    class Faulty(Run):
        def window(self, eng):
            FAULTS[fault](eng, monkeypatch)
            return super().window(eng)

    out = _run(cell, tiny, root_of(cell), cls=Faulty)
    assert not out["correct"], (cell, fault, out["checks"])
