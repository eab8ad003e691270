"""Whole runs of every cell at a tiny size on the CPU: the program's answers
against the reference, the control and planted faults against the check,
a mix added by files alone, and the command's refusals."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from nbbench.harness import Run
from nbbench.reference import (LastWriterWins, scan_mismatches,
                               table_mismatches)

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
LATER = json.loads((Path(__file__).with_name("later_cells.json")).read_text())
#: the benchmark's entries and the read cells kept for later
ALL = {k: BENCH[k] + LATER.get(k, []) for k in ("workloads", "end_to_end",
                                                 "per_layer")}
CELLS = [w["name"] for w in ALL["workloads"]]
SECONDS = 0.1


def _run(cell, tiny, seed=2**31 + 11, trace=False, root=ROOT, cls=Run, **kw):
    cfg = json.loads((root / next(
        c["file"] for c in json.loads((root / "BENCHMARK.json").read_text())
        ["configs"] if c["name"] == _config_of(cell, root))).read_text())
    config, mix = tiny(cell, cfg["engine_kwargs"])
    return cls(cell, seed, SECONDS, trace, root=root, device="cpu",
               config_overrides=config, mix_overrides=mix,
               log=lambda *a: None, **kw).run()


def _config_of(cell, root=ROOT):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return next(w["config"] for w in bench["workloads"] if w["name"] == cell)


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_program_matches_the_reference(cell, trace, tiny, root_of):
    out = _run(cell, tiny, trace=trace, root=root_of(cell))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    want = {m["name"] for m in ALL["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])}
    on_device = {m["name"] for m in ALL["per_layer"]
                 if m["source"] == "device_trace"}
    got = set(out["metrics"])
    if not trace:
        assert got == want
    else:   # the CPU has no device trace; a short window may see no unit
        assert got <= want - on_device
        assert ("index.dispatches_per_kinsert" in got) == (
            "index.dispatches_per_kinsert" in want)


def test_a_mix_added_by_files_alone(tmp_path, tiny):
    """A throwaway read/update mix in a copy of the benchmark's files, found
    by the name its new cell gives: nothing else changes."""
    shutil.copytree(ROOT / "nbbench", tmp_path / "nbbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "nbbench" / "mixes" / "tmp-updates.json").write_text(
        json.dumps({"batch": 256, "ops": {"read": 0.5, "update": 0.5},
                    "preload": True, "zipfian_constant": 0.99}))
    served = [dict(m, workloads=["tmp-updates.nbtree"])
              for m in LATER["end_to_end"]]
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "tmp-updates.nbtree", "config": "ycsb-nbtree",
         "traffic": "tmp-updates", "chips": 1, "why": "a test"}],
        end_to_end=BENCH["end_to_end"] + served)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _run("tmp-updates.nbtree", tiny, root=tmp_path)
    assert out["correct"], out["checks"]
    assert {"served_ops_per_s", "setup_s"} <= set(out["metrics"])
    assert out["checks"]["read_mismatches"]["value"] == 0


def test_reference_resolves_by_time():
    ref = LastWriterWins()
    ref.write([5, 7, 5], [50, 70, 51], [0, 1, 4])
    found, vals = ref.read([5, 5, 7, 7, 9], [3, 9, 0, 2, 9])
    assert found.tolist() == [True, True, False, True, False]
    assert vals.tolist() == [50, 51, -1, 70, -1]
    keys, vals, counts = ref.scan([1, 6, 8], [9, 7, 8], [3, 9, 9])
    assert counts.tolist() == [2, 1, 0]
    assert keys.tolist() == [5, 7, 7] and vals.tolist() == [50, 70, 70]
    assert [a.tolist() for a in ref.table()] == [[5, 7], [51, 70]]


def test_mismatch_counts():
    assert table_mismatches([1, 2, 3], [1, 2, 3], [1, 2, 3], [1, 2, 4]) == 1
    assert table_mismatches([1, 2], [1, 2], [2, 3], [2, 3]) == 2
    assert scan_mismatches([1, 2, 3], [1, 2, 3], [2, 1],
                           [1, 2, 3], [1, 2, 3], [2, 1]) == 0
    assert scan_mismatches([1, 2, 3], [1, 2, 9], [2, 1],
                           [1, 2, 3], [1, 2, 3], [2, 1]) == 1
    assert scan_mismatches([1, 3], [1, 3], [1, 1],
                           [1, 2, 3], [1, 2, 3], [2, 1]) == 1


@pytest.mark.parametrize("where", ["checkout", "benchmark_files_only"])
def test_the_command_gives_no_result_here(where, tmp_path):
    """Without a card (and, copied alone, without the program) the command
    prints no result and exits with a code other than 0."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    cwd = ROOT
    if where == "benchmark_files_only":
        shutil.copytree(ROOT / "nbbench", tmp_path / "nbbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
        cwd = tmp_path
    proc = subprocess.run(
        [sys.executable, *BENCH["command"][1:], "--workload",
         BENCH["workloads"][0]["name"],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "no result" in proc.stderr


@pytest.mark.card
def test_each_cell_on_the_card_matches_the_reference(card, tiny, root_of):
    for cell in CELLS:
        root = root_of(cell)
        cfg = json.loads((root / "nbbench" / "configs"
                          / f"{_config_of(cell, root)}.json").read_text())
        config, mix = tiny(cell, cfg["engine_kwargs"])
        out = Run(cell, 3, 2.0, True, root=root, device="cuda",
                  config_overrides=config, mix_overrides=mix,
                  log=lambda *a: None).run()
        assert out["correct"], (cell, out["checks"])
        assert out["device"]["busy_s"] > 0
        assert out["metrics"]


def test_traced_window_wraps_the_kernels_in_its_second_half_only(
        tiny, monkeypatch):
    """The device's idle share and breakdown are read from the first half,
    where no wrapper launches kernels of its own; the roofline shares from
    the second, where every launch is counted."""
    from repro_torch.kernels import ops

    plain = ops.merge_sorted_batch
    calls, seen = [], {}

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    class Spy(Run):
        def window(self, eng):
            seen["w"] = super().window(eng)
            seen["wrapped_at_end"] = ops.merge_sorted_batch is not counted
            return seen["w"]

    monkeypatch.setattr(ops, "merge_sorted_batch", counted)

    cfg = json.loads((ROOT / "nbbench/configs/ycsb-nbtree.json").read_text())
    config, mix = tiny("ycsb-load.nbtree", cfg["engine_kwargs"])
    run = Spy("ycsb-load.nbtree", 5, 0.6, True, device="cpu",
              config_overrides=config, mix_overrides=mix,
              log=lambda *a: None)
    assert run.run()["correct"]
    w = seen["w"]
    assert w["t0"] < w["t_mid"] < w["t1"] and seen["wrapped_at_end"]
    counted_after_mid = len(run.work.records["merge_sorted_batch"])
    assert 0 < counted_after_mid < len(calls)
    assert ops.merge_sorted_batch is counted          # unwrapped after
