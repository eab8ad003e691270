"""The traffic generator: deterministic from the seed, and shaped as YCSB's
core workloads."""
import json
from pathlib import Path

import numpy as np
import pytest

from nbbench.traffic import (READ, SCAN, WRITE, KeyMap, Traffic,
                             per_batch_counts, zipf_ranks)

ROOT = Path(__file__).resolve().parents[2]
MIXES = sorted(p.stem for p in (ROOT / "nbbench" / "mixes").glob("*.json"))
CONFIG = {"recordcount": 1 << 12, "key_space": 1 << 20}


def _mix(name: str) -> dict:
    mix = json.loads((ROOT / "nbbench" / "mixes" / f"{name}.json").read_text())
    mix["batch"] = min(mix["batch"], 1024)
    return mix


def _same(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("kinds", "keys", "vals", "his"))


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_batches_other_seed_other_batches(mix):
    a = Traffic(CONFIG, _mix(mix), 2**31 + 7)
    b = Traffic(CONFIG, _mix(mix), 2**31 + 7)
    c = Traffic(CONFIG, _mix(mix), 5)
    for t in (70, 3, 0):                      # any order
        assert _same(a.batch(t), b.batch(t))
    assert not _same(a.batch(1), c.batch(1))
    pa, pb = list(a.preload_batches()), list(b.preload_batches())
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
               for x, y in zip(pa, pb))


def test_load_keys_distinct_and_in_the_key_space():
    tr = Traffic(CONFIG, _mix("ycsb-load"), 9)
    keys = np.concatenate([tr.batch(t).keys for t in range(40)])
    assert len(np.unique(keys)) == len(keys) == 40 * tr.batch_size
    assert keys.min() >= 1 and keys.max() <= CONFIG["key_space"]
    assert np.all(tr.batch(0).kinds == WRITE)
    assert not np.all(np.diff(keys.astype(np.int64)) > 0)     # hashed order


def test_ordered_keys_are_one_two_three():
    tr = Traffic(CONFIG, _mix("ordered-load"), 9)
    keys = np.concatenate([tr.batch(t).keys for t in range(3)])
    assert np.array_equal(keys, np.arange(1, len(keys) + 1))


def test_keymap_is_a_bijection():
    for ordered in (False, True):
        km = KeyMap(1 << 12, 123, ordered)
        keys = km(np.arange(1 << 12))
        assert np.array_equal(np.sort(keys), np.arange(1, (1 << 12) + 1))


def test_scans_cover_one_to_a_hundred_loaded_records():
    tr = Traffic(CONFIG, _mix("ycsb-e"), 4)
    loaded = tr.sorted_loaded_keys()
    assert len(loaded) == CONFIG["recordcount"]
    counts = []
    for t in range(8):
        b = tr.batch(t)
        s = b.kinds == SCAN
        assert set(np.unique(b.kinds)) == {WRITE, SCAN}
        n = (np.searchsorted(loaded, b.his[s], "right")
             - np.searchsorted(loaded, b.keys[s], "left"))
        counts.append(n)
        assert np.isin(b.keys[s], loaded).all()
        new = b.keys[b.kinds == WRITE]
        assert not np.isin(new, loaded).any()          # new records
    counts = np.concatenate(counts)
    assert counts.min() >= 1 and counts.max() <= 100
    assert counts.max() > 90 and counts.min() < 10


def test_reads_are_zipfian_over_loaded_records():
    tr = Traffic(CONFIG, _mix("ycsb-c"), 4)
    keys = np.concatenate([tr.batch(t).keys for t in range(4)])
    assert np.all(tr.batch(0).kinds == READ)
    assert np.isin(keys, tr.sorted_loaded_keys()).all()
    _, freq = np.unique(keys, return_counts=True)
    top = np.sort(freq)[::-1]
    assert top[0] > 20 * np.median(freq)           # a few records are hot
    again = Traffic(CONFIG, _mix("ycsb-c"), 4)
    assert np.array_equal(tr.batch(3).keys, again.batch(3).keys)
    assert not np.array_equal(tr.batch(0).keys, tr.batch(1).keys)


def test_zipf_ranks_and_op_counts():
    rng = np.random.default_rng(0)
    r = zipf_ranks(rng, 100_000, 1 << 20, 0.99)
    assert r.min() >= 0 and r.max() < 1 << 20
    assert (r == 0).mean() > 0.02
    assert per_batch_counts(1024, {"scan": 0.95, "insert": 0.05}) == {
        "insert": 51, "update": 0, "read": 0, "scan": 973}
    assert sum(per_batch_counts(7, {"read": 0.5, "update": 0.5}).values()) == 7
    with pytest.raises(ValueError):
        per_batch_counts(8, {"delete": 1.0})


def test_mix_that_reads_must_load():
    mix = dict(_mix("ycsb-c"), preload=False)
    with pytest.raises(ValueError):
        Traffic(CONFIG, mix, 1)
