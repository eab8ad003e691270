"""Shared set-up of the benchmark's tests: import paths, the ``card`` marker,
and the tiny sizes at which a whole run fits a CPU test."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: the read cells' entries, left out of ``BENCHMARK.json`` until loading
#: their table fits a run (PERF.md section 7); their mixes, readers and
#: checks stay, and the tests run them from a throwaway copy that adds these
LATER = json.loads((Path(__file__).with_name("later_cells.json")).read_text())

#: each cell's configuration and mix cut to a size a CPU test holds: the
#: engines' shape (sigma 512, 64 node rows), 2^12 loaded records over 2^20
#: keys, small batches, one warm-up batch
TINY_ENGINE = {"f": 4, "sigma": 512, "max_nodes": 64, "max_results": 128}
TINY = {
    "ycsb-load.nbtree": {"batch": 512},
    "ordered-load.range4": {"batch": 512},
    "ycsb-c.nbtree": {"batch": 1024},
    "ycsb-e.nbtree": {"batch": 128},
}


def tiny_overrides(cell: str, engine_kwargs: dict) -> tuple:
    """``(config_overrides, mix_overrides)`` of ``cell`` at the tiny size."""
    kw = {**engine_kwargs, **TINY_ENGINE}
    config = {"recordcount": 1 << 12, "key_space": 1 << 20,
              "engine_kwargs": kw}
    mix = {"prefetch_batches": 8, "warmup_batches": 1, "preload_batch": 512,
           **TINY.get(cell, {})}
    return config, mix


@pytest.fixture
def tiny():
    """:func:`tiny_overrides`, for tests (a fixture: test modules do not
    import conftest)."""
    return tiny_overrides


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips where there is none")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided when the test
    runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def later_root(tmp_path_factory):
    """A copy of the benchmark's files whose ``BENCHMARK.json`` also holds
    the :data:`LATER` entries."""
    root = tmp_path_factory.mktemp("later")
    shutil.copytree(ROOT / "nbbench", root / "nbbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in LATER.items():
        bench[key] = bench[key] + entries
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def root_of(later_root):
    """The checkout a cell runs from: this one, or for a :data:`LATER` cell
    the copy that names it."""
    later = {w["name"] for w in LATER["workloads"]}
    return lambda cell: later_root if cell in later else ROOT
