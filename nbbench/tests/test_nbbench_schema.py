"""``BENCHMARK.json`` against the benchmark's contract: keys, names, units,
bounds, files, and which metric each cell reports."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
LATER = json.loads((Path(__file__).with_name("later_cells.json")).read_text())
#: the benchmark with the read cells kept for later added: what a later
#: change that adds them would commit
ALL = {k: v + LATER.get(k, []) if isinstance(v, list) else v
       for k, v in BENCH.items()}

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd:
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_and_units(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = ({"workloads"} if section in ("end_to_end", "per_layer")
                 else set())
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_configs_cells_and_chips():
    cfgs = {c["name"]: c for c in BENCH["configs"]}
    assert 1 <= len(cfgs) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(cfgs)
    files = [c["file"] for c in cfgs.values()]
    assert len(files) == len(set(files))
    for c in cfgs.values():
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(body["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (ROOT / "nbbench" / "mixes" / f"{w['traffic']}.json").is_file()


def test_bounds_and_run_seconds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert e2e["setup_s"]["bound"] <= 0.25
    secs = BENCH["run_seconds"]
    assert isinstance(secs, int) and 1 <= secs <= 51
    # a full check of 24 cells fits the driver's 43,200 seconds
    assert (2 + 14 * 24) * (secs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _reports(cell: str, section: str, bench=BENCH) -> set:
    return {m["name"] for m in bench[section]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", [w["name"] for w in ALL["workloads"]])
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = _reports(cell, "end_to_end", ALL)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert _reports(cell, "per_layer", ALL)


def test_the_read_cells_kept_for_later_fit_the_schema():
    """Their entries, added to ``BENCHMARK.json``, pass the checks above:
    known configuration and mix, names, keys, one reader a metric, and
    ``moves`` a metric each of their cells reports."""
    names = {c["name"] for c in BENCH["configs"]}
    for w in LATER["workloads"]:
        assert w["config"] in names and w["chips"] == 1 and _line(w["why"])
        assert KEYS["workloads"] == set(w) and NAME.match(w["name"])
        assert (ROOT / "nbbench" / "mixes" / f"{w['traffic']}.json").is_file()
    for section in ("end_to_end", "per_layer"):
        for m in LATER[section]:
            assert KEYS[section] | {"workloads"} == set(m)
            assert (ROOT / "nbbench" / "metrics" / f"{m['name']}.py").is_file()
            for cell in m["workloads"]:
                if section == "per_layer":
                    assert m["moves"] in _reports(cell, "end_to_end", ALL)
    assert len({m["name"] for s in ("end_to_end", "per_layer")
                for m in ALL[s]}) == len(ALL["end_to_end"]) + len(
                    ALL["per_layer"])


def test_per_layer_moves_a_metric_each_of_its_cells_reports():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
        for cell in cells:
            assert m["moves"] in _reports(cell, "end_to_end"), (m["name"],
                                                                cell)
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["source"] == "device_trace"
    assert {"shard", "engine", "index", "kernels", "device"} <= set(layers)


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        path = ROOT / "nbbench" / "metrics" / f"{m['name']}.py"
        assert path.is_file(), m["name"]
