"""The Bloom build and update kernels on the card, against their plain
versions bit for bit (OR is order-free, so no tolerance), and a fused and an
eager index on the card against the same op stream on the CPU.

Every test here needs a CUDA card and skips without one; the module imports
neither JAX nor the JAX package, so it runs on a machine with the card:
``python -m pytest -q tests/test_torch_bloom_card.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import torch_nbtree
from repro_torch.core.state import TABLES, export_state
from repro_torch.core.torch_nbtree import NBTreeIndex
from repro_torch.kernels import bloom_filter as bf
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (KEY_MAX32, bloom_build_ref,
                                     bloom_update_ref)

#: the cells' filter: run_cap 21,504 at f = 4, sigma = 4,096, 10 bits a key
NBITS = 217_088
#: (N,) and (R, N) key shapes: the insert's batch and the flush's rows
SHAPES = [(4096,), (21504,)] + [(r, n) for r in range(1, 6)
                                for n in (4096, 21504)]


def _keys(shape, seed: int, dev):
    """uint32 keys as int64 with what the write path feeds the build: a
    KEY_MAX tail, duplicates, keys 0 and 2^32 - 2, and (R >= 2) one row of
    KEY_MAX alone."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, KEY_MAX32, shape, dtype=np.int64)
    rows = keys.reshape(-1, shape[-1])
    n = shape[-1]
    rows[:, : n // 8] = rows[:, n // 8: 2 * (n // 8)]     # duplicates
    rows[:, 0], rows[:, 1] = 0, KEY_MAX32 - 1
    rows[:, -n // 5:] = KEY_MAX32                        # padding tail
    if rows.shape[0] >= 2:
        rows[1] = KEY_MAX32
    return torch.from_numpy(keys).to(dev)


def _old_words(shape, nbits: int, seed: int, dev):
    """An update's filter: dense random uint32 words (bit 31 included)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (*shape[:-1], nbits // 32), dtype=np.int64)
    return torch.from_numpy(words).to(dev)


#: the most words a filter row built in shared memory may have
#: (``BB_MAX_SMEM`` / 4 of ``csrc/bloom_filter.cu``); longer rows take the
#: device-memory body
SMEM_WORDS = 232_448 // 4


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("h", range(1, 7))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bloom_build_kernel_equals_plain(card, shape, h):
    keys = _keys(shape, 7 * h + len(shape), card)
    got = ops.bloom_build(keys, NBITS, h)
    torch.cuda.synchronize()
    assert got.shape == (*shape[:-1], NBITS // 32)
    assert torch.equal(got, bloom_build_ref(keys, NBITS, h))


@pytest.mark.card
@pytest.mark.parametrize("h", range(1, 7))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bloom_update_kernel_equals_plain(card, shape, h):
    keys = _keys(shape, 11 * h + len(shape), card)
    old = _old_words(shape, NBITS, h, card)
    if len(shape) == 2:                  # a filter the build made, too
        old[0] = bloom_build_ref(_keys(shape, 99, card)[0], NBITS, h)
    before = old.clone()
    got = ops.bloom_update(old, keys, NBITS, h)
    torch.cuda.synchronize()
    assert torch.equal(old, before)                    # a new tensor
    assert torch.equal(got, bloom_update_ref(old, keys, NBITS, h))


@pytest.mark.card
@pytest.mark.parametrize("h", [1, 3, 6])
@pytest.mark.parametrize("extra", [0, 1, 6_000], ids=["largest-shared",
                                                      "smallest-device",
                                                      "device"])
def test_bloom_rows_past_shared_memory_equal_plain(card, extra, h):
    """The row of the most words shared memory holds (above the 48 KB
    default, so the kernel's opt-in is exercised) and rows of more words,
    built in device memory: build and update."""
    nbits = 32 * (SMEM_WORDS + extra)
    keys = _keys((2, 4096), h + extra, card)
    assert torch.equal(ops.bloom_build(keys, nbits, h),
                       bloom_build_ref(keys, nbits, h))
    old = _old_words((2, 4096), nbits, h, card)
    assert torch.equal(ops.bloom_update(old, keys, nbits, h),
                       bloom_update_ref(old, keys, nbits, h))
    one = keys[0].contiguous()
    assert torch.equal(ops.bloom_build(one, nbits, h),
                       bloom_build_ref(one, nbits, h))


@pytest.mark.card
def test_bloom_build_small_filters_and_empty_runs(card):
    """nbits of one word and of 4,096; rows of no keys give zero words (the
    update its old words); no rows launch nothing."""
    keys = _keys((3, 500), 5, card)
    for nbits in (32, 4096):
        assert torch.equal(ops.bloom_build(keys, nbits, 3),
                           bloom_build_ref(keys, nbits, 3))
    empty = torch.empty((2, 0), dtype=torch.int64, device=card)
    assert not ops.bloom_build(empty, NBITS, 3).any()
    old = _old_words((2, 0), NBITS, 1, card)
    assert torch.equal(ops.bloom_update(old, empty, NBITS, 3), old)
    ops.reset_launch_counts()
    none = torch.empty((0, 4096), dtype=torch.int64, device=card)
    assert ops.bloom_build(none, NBITS, 3).shape == (0, NBITS // 32)
    assert ops.launch_counts()["bloom_build"] == 0


@pytest.mark.card
def test_bloom_build_wrappers_count_launches_and_refuse_strided(card):
    keys = _keys((5, 4096), 3, card)
    ops.reset_launch_counts()
    words = ops.bloom_build(keys, NBITS, 3)
    ops.bloom_update(words[2], keys[2], NBITS, 3)    # a table row, as insert
    counts = ops.launch_counts()
    assert (counts["bloom_build"], counts["bloom_update"]) == (1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        bf.bloom_build_cuda(keys[:, ::2], NBITS, 3)
    with pytest.raises(ValueError, match="contiguous"):
        bf.bloom_update_cuda(words[:, ::2], keys[:, :64].contiguous(),
                             NBITS // 2, 3)


def _stream(idx: NBTreeIndex, seed: int) -> dict:
    """Inserts, deletes and maintenance enough for leaf and internal flushes
    and splits at sigma 256; returns the oracle of live pairs."""
    rng = np.random.default_rng(seed)
    pool = (rng.choice(2**31 - 1, 12_000, replace=False) + 1).astype(np.uint32)
    oracle, cursor = {}, 0
    for _ in range(40):
        n = int(rng.choice((128, 256)))
        ks = pool[cursor: cursor + n]
        vs = (np.arange(n) + cursor).astype(np.int32)
        idx.insert_batch(ks, vs)
        oracle.update(zip(ks.tolist(), vs.tolist()))
        if rng.random() < 0.3:
            dk = pool[max(cursor - 64, 0): cursor]
            idx.delete_batch(dk)
            for k in dk.tolist():
                oracle.pop(k, None)
        idx.maintain(int(rng.integers(0, 4)))
        cursor += n
    idx.drain()
    return oracle


@pytest.mark.card
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_index_on_the_card_equals_the_cpu(card, fused, monkeypatch):
    """The same stream on the card and on the CPU ends with the seven tables
    equal; on the card every impl call that builds or updates a filter
    launched the kernel once, and reads through the filters answer as the
    oracle does."""
    calls: list = []
    real = torch_nbtree._device_call

    def counting(fn, *args, **kwargs):
        calls.append(getattr(fn, "__name__", ""))
        return real(fn, *args, **kwargs)

    cfg = dict(f=4, sigma=256, max_nodes=256, fused=fused)
    cpu = NBTreeIndex(device="cpu", **cfg)
    oracle = _stream(cpu, 3)
    monkeypatch.setattr(torch_nbtree, "_device_call", counting)
    ops.reset_launch_counts()
    dev = NBTreeIndex(device=card, **cfg)
    assert _stream(dev, 3) == oracle
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    monkeypatch.setattr(torch_nbtree, "_device_call", real)

    for name in TABLES:
        assert torch.equal(getattr(dev, name).cpu(), getattr(cpu, name)), name
    assert export_state(dev)[1] == export_state(cpu)[1]
    if fused:
        assert launches["bloom_build"] == (calls.count("_flush_impl")
                                           + calls.count("_split_impl")) > 0
        assert launches["bloom_update"] == calls.count("_insert_impl") > 0
    else:
        assert launches["bloom_build"] == calls.count("_build_bloom") > 0
        assert launches["bloom_update"] == 0
    assert dev.height > 1 and cpu.units_done > 0

    q = np.array(sorted(oracle)[::7] + [2**31 + 5, 4], np.uint32)
    found, vals = dev.query_batch(q)
    want = [oracle.get(int(k)) for k in q]
    assert found.cpu().tolist() == [w is not None for w in want]
    assert [int(v) for v, w in zip(vals.cpu(), want) if w is not None] == \
        [w for w in want if w is not None]
