"""Finds a cell's parts by the names ``BENCHMARK.json`` gives them.

A cell (an entry of ``workloads``) names a configuration, whose file the
``configs`` entry gives, and a traffic mix, ``nbbench/mixes/<traffic>.json``.
Every metric, end-to-end or per-layer, is read by its own reader,
``nbbench/metrics/<name>.py``, which defines ``read(obs)`` and returns a
number or None.  Adding a configuration, a mix or a metric is adding files
and entries: nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

#: the checkout's root: ``BENCHMARK.json`` and this package live there
ROOT = Path(__file__).resolve().parents[1]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}; known: "
                   f"{sorted(e['name'] for e in entries)}")


class Cell:
    """One cell of ``BENCHMARK.json`` with its configuration, mix and the
    metrics it reports."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")
        self.entry = _named(self.bench["workloads"], name, "workload")
        self.name = name
        self.config_entry = _named(self.bench["configs"],
                                   self.entry["config"], "configuration")
        self.config = load_json(self.root / self.config_entry["file"])
        self.mix = load_json(self.root / "nbbench" / "mixes"
                             / f"{self.entry['traffic']}.json")
        self.chips = int(self.entry["chips"])

    def metrics(self, trace: bool) -> list:
        """The end-to-end metrics this cell reports (``trace`` False) or its
        per-layer ones (True)."""
        e2e = [m for m in self.bench["end_to_end"]
               if self.name in m.get("workloads", [self.name])]
        if not trace:
            return e2e
        mine = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name])
                and ("workloads" in m or m["moves"] in mine)]

    def reader(self, metric: str):
        """The ``read(obs)`` function of ``nbbench/metrics/<metric>.py``."""
        path = self.root / "nbbench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "nbbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
