"""Plain versions of the port's kernels vs the JAX package: the integer
kernels bit for bit, paged attention to the JAX kernel tests' tolerances.

The same numpy inputs (made from a seed) go through ``repro.kernels.ops``
(the Pallas kernels, in interpret mode on the CPU) or ``repro.kernels.ref``
and through ``repro_torch.kernels.ops`` on CPU tensors, which takes each
kernel's plain PyTorch version.  The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py`` and, the
Bloom build and update, by ``tests/test_torch_bloom_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.bloom_filter import bloom_build_cuda, bloom_update_cuda
from repro_torch.kernels.merge_sorted import merge_sorted_cuda
from repro_torch.kernels.paged_attention import (check_alignment,
                                                 paged_attention_cuda)

KEY_MAX = 0xFFFFFFFF


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _k(a):
    """uint32 keys -> the port's int64 representation."""
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def _v(a):
    return torch.from_numpy(np.asarray(a, np.int32))


def _np(x):
    return np.asarray(x).astype(np.int64)


def _same(jax_out, torch_out):
    assert np.array_equal(_np(jax_out), torch_out.numpy().astype(np.int64))


def _sorted_run(rng, n, dup=0.0):
    run = np.sort(rng.choice(2**31, n, replace=False)).astype(np.uint32)
    if dup and n > 1:          # duplicate keys, as runs keep stale copies
        i = rng.choice(n - 1, int(dup * n), replace=False)
        run[i + 1] = run[i]
        run = np.sort(run)
    return run


def _row(rng, n, cap):
    """A node-table row: n sorted keys, then KEY_MAX with stale values."""
    keys = np.full(cap, KEY_MAX, np.uint32)
    keys[:n] = _sorted_run(rng, n, dup=0.1)
    return keys, rng.integers(0, 2**31, cap).astype(np.int32)


# ------------------------------------------------------------------- merge
def _case(*values, mode=None, id=None):
    """A parametrised merge case; cases without a mode keep the ids of the
    plain value tuples."""
    return pytest.param(*values, mode, id=id or "-".join(map(str, values)))


def _a_run(rng, n, cap, mode):
    """n sorted keys and their values; in ``stale`` mode a row of ``cap``
    whose KEY_MAX tail carries nonzero values, as ``_window`` rows do."""
    if mode == "stale":
        return _row(rng, n, cap)
    return (_sorted_run(rng, n, dup=0.1),
            rng.integers(0, 2**31, n).astype(np.int32))


def _tie_across_1024(ak, bk):
    """One key over a[1000:1050] and b[990:1080] (b's first keys made a's),
    so its group crosses the 1024 boundary of a, of b and of the output."""
    n = len(ak)
    bk[:n] = ak
    bk[n:] = np.maximum(bk[n:], ak[-1])
    ak[1000:1050] = ak[1000]
    bk[990:1080] = ak[1000]


@pytest.mark.parametrize("n,m,cap,mode", [
    _case(1, 1, 1), _case(100, 57, 64), _case(1024, 700, 2048),
    _case(3000, 17, 17), _case(0, 300, 1024),
    _case(2100, 2100, 3100, mode="tie1024", id="ties-across-1024"),
    _case(1025, 1030, 1030, id="raw-just-above-1024"),
    _case(2049, 1100, 2049, mode="stale", id="stale-value-tails")])
def test_merge_matches_jax_with_padding(rng, n, m, cap, mode):
    """Whole padded output, KEY_MAX tail values included, equals Pallas."""
    ak, av = _a_run(rng, n, n + 500, mode)
    bk, bv = _row(rng, min(m, cap), cap)
    if mode == "tie1024":
        _tie_across_1024(ak, bk)
    elif n:                    # shared keys exercise the a-first tie-break
        bk[: min(m, cap) // 2] = np.sort(rng.choice(ak, min(m, cap) // 2))
        bk = np.sort(bk)
    jk, jv = jops.merge_sorted(jnp.asarray(ak), jnp.asarray(av),
                               jnp.asarray(bk), jnp.asarray(bv))
    tk, tv = tops.merge_sorted(_k(ak), _v(av), _k(bk), _v(bv))
    _same(jk, tk)
    _same(jv, tv)


def test_merge_tiebreak_a_first():
    tk, tv = tops.merge_sorted(_k([5, 10, 20]), _v([1, 2, 3]),
                               _k([10, 20, 30]), _v([-1, -2, -3]))
    assert tk[:6].tolist() == [5, 10, 10, 20, 20, 30]
    assert tv[:6].tolist() == [1, 2, -1, 3, -2, -3]


@pytest.mark.parametrize("R,n,m,mode", [
    _case(1, 64, 64), _case(3, 100, 1024), _case(4, 700, 1500),
    _case(5, 1025, 1100, id="R5-raw-just-above-1024"),
    _case(2, 2100, 3100, mode="tie1024", id="R2-ties-across-1024"),
    _case(5, 300, 1100, mode="stale", id="R5-stale-value-tails"),
    _case(3, 700, 1100, mode="b-empty", id="R3-all-KEY_MAX-b-runs")])
def test_merge_batch_matches_jax(rng, R, n, m, mode):
    rows = [_row(rng, 0 if mode == "b-empty" else m - 13 * r, m)
            for r in range(R)]
    if mode == "stale":        # a-rows of width n, n - 7r live
        ak, av = (np.stack(x) for x in zip(*[_row(rng, n - 7 * r, n)
                                             for r in range(R)]))
    else:
        ak = np.stack([_sorted_run(rng, n, dup=0.1) for _ in range(R)])
        av = rng.integers(0, 2**31, (R, n)).astype(np.int32)
    bk = np.stack([r[0] for r in rows])
    bv = np.stack([r[1] for r in rows])
    if mode == "tie1024":
        for r in range(R):
            _tie_across_1024(ak[r], bk[r])
    jk, jv = jops.merge_sorted_batch(jnp.asarray(ak), jnp.asarray(av),
                                     jnp.asarray(bk), jnp.asarray(bv))
    tk, tv = tops.merge_sorted_batch(_k(ak), _v(av), _k(bk), _v(bv))
    _same(jk, tk)
    _same(jv, tv)
    for r in range(R):         # row r == merge_sorted(a[r], b[r])
        sk, sv = tops.merge_sorted(_k(ak[r]), _v(av[r]), _k(bk[r]), _v(bv[r]))
        assert torch.equal(tk[r], sk) and torch.equal(tv[r], sv)


def test_merge_batch_empty_run_identity(rng):
    """An all-KEY_MAX a-run leaves b unchanged per row (untouched children)."""
    m = 512
    bk = np.stack([_sorted_run(rng, m) for _ in range(3)])
    bv = rng.integers(0, 2**31, (3, m)).astype(np.int32)
    ak = np.full((3, 128), KEY_MAX, np.uint32)
    tk, tv = tops.merge_sorted_batch(_k(ak), _v(np.zeros((3, 128))), _k(bk),
                                     _v(bv))
    assert np.array_equal(tk[:, :m].numpy(), bk.astype(np.int64))
    assert np.array_equal(tv[:, :m].numpy(), bv)


# ------------------------------------------------------------------ search
@pytest.mark.parametrize("n,q", [(16, 8), (1000, 300), (5000, 2048)])
def test_search_matches_jax(rng, n, q):
    run = _sorted_run(rng, n, dup=0.2)
    vals = np.arange(n, dtype=np.int32)
    queries = np.concatenate([
        rng.choice(run, q // 2),
        rng.integers(2**31, 2**32 - 2, q - q // 2 - 1).astype(np.uint32),
        np.array([KEY_MAX], np.uint32)])
    jf, jv, ji = jops.sorted_search(jnp.asarray(run), jnp.asarray(vals),
                                    jnp.asarray(queries))
    tf, tv, ti = tops.sorted_search(_k(run), _v(vals), _k(queries))
    for a, b in ((jf, tf), (jv, tv), (ji, ti)):
        _same(a, b)


def test_search_rows_matches_jax_per_row(rng):
    """Query t searches the first counts[t] keys of row rows[t]."""
    counts_row = np.array([0, 37, 511, 512], np.int32)
    R, cap, Q = len(counts_row), 512, 400
    tab = [_row(rng, int(c), cap) for c in counts_row]
    keys = np.stack([t[0] for t in tab])
    vals = np.stack([t[1] for t in tab])
    rows = rng.integers(0, R, Q).astype(np.int32)
    q = np.where(rng.random(Q) < 0.6,
                 keys[rows, rng.integers(0, cap, Q)] % np.uint32(2**31),
                 rng.integers(1, 2**31, Q)).astype(np.uint32)
    tf, tv, ti = tops.sorted_search_rows(_k(keys), _v(vals), _v(rows),
                                         _v(counts_row[rows]), _k(q))
    for r in range(R):
        sel = rows == r
        c = counts_row[r]      # a KEY_MAX sentinel keeps empty prefixes valid
        jf, jv, ji = jref.sorted_search_ref(
            jnp.asarray(np.append(keys[r, :c], np.uint32(KEY_MAX))),
            jnp.asarray(np.append(vals[r, :c], np.int32(0))),
            jnp.asarray(q[sel]))
        assert np.array_equal(np.asarray(jf), tf[torch.from_numpy(sel)].numpy())
        assert np.array_equal(np.asarray(jv), tv[torch.from_numpy(sel)].numpy())
        assert np.array_equal(np.asarray(ji), ti[torch.from_numpy(sel)].numpy())


# ------------------------------------------------------------------- bloom
def test_bloom_hash_matches_jax_above_2_63(rng):
    """Products of two uint32 values pass 2^63 in int64; the port keeps the
    low 32 bits without signed overflow."""
    keys = np.concatenate([np.array([0, 1, 0xFFFFFFFE, KEY_MAX, 0xFFFF0000,
                                     0x80000000], np.uint32),
                           rng.integers(0, 2**32, 500).astype(np.uint32)])
    assert int(keys[2]) * 0xD3A2646C > 2**63
    for nbits in (4096, 217088):
        _same(jref.bloom_hash_ref(jnp.asarray(keys), 6, nbits),
              tref.bloom_hash_ref(_k(keys), 6, nbits))


@pytest.mark.parametrize("n,nbits,h", [(100, 4096, 3), (4000, 40960, 3),
                                       (2000, 12288, 6)])
def test_bloom_build_update_probe_match_jax(rng, n, nbits, h):
    keys = rng.choice(2**31, n, replace=False).astype(np.uint32)
    keys[:: 7] = KEY_MAX                          # padding sets no bits
    words_j = jref.bloom_build_ref(jnp.asarray(keys), nbits, h)
    words_t = tops.bloom_build(_k(keys), nbits, h)
    _same(words_j, words_t)
    # update(build(S), B) == build(S ∪ B), bit for bit
    half = n // 2
    grown = tops.bloom_update(tops.bloom_build(_k(keys[:half]), nbits, h),
                              _k(keys[half:]), nbits, h)
    assert torch.equal(grown, words_t)
    _same(jref.bloom_update_ref(jref.bloom_build_ref(jnp.asarray(keys[:half]),
                                                     nbits, h),
                                jnp.asarray(keys[half:]), nbits, h), grown)
    # probe: the Pallas kernel (interpret) vs the plain version
    q = np.concatenate([keys[keys != KEY_MAX],
                        rng.integers(2**31, 2**32 - 1, 500).astype(np.uint32)])
    pj = jops.bloom_probe(words_j, jnp.asarray(q), nbits=nbits, h=h)
    pt = tops.bloom_probe(words_t, _k(q), nbits=nbits, h=h)
    _same(pj, pt)
    assert pt[: int((keys != KEY_MAX).sum())].all()   # no false negatives


def test_bloom_batched_build_equals_per_row(rng):
    keys = np.stack([_row(rng, 300, 512)[0] for _ in range(3)])
    batched = tops.bloom_build(_k(keys), 8192, 3)
    for r in range(3):
        _same(jref.bloom_build_ref(jnp.asarray(keys[r]), 8192, 3), batched[r])


def test_bloom_probe_rows_matches_jax_per_row(rng):
    nbits, h, R = 8192, 3, 4
    sets = [rng.choice(2**31, 600, replace=False).astype(np.uint32)
            for _ in range(R)]
    table = np.stack([np.asarray(jref.bloom_build_ref(jnp.asarray(s), nbits, h))
                      for s in sets])
    rows = rng.permutation(np.repeat(np.arange(R, dtype=np.int32), 250))
    q = np.where(rng.random(1000) < 0.5,
                 np.stack(sets)[rows, rng.integers(0, 600, 1000)],
                 rng.integers(0, 2**32, 1000)).astype(np.uint32)
    got = tops.bloom_probe_rows(_k(table), _v(rows), _k(q), nbits=nbits, h=h)
    for r in range(R):
        sel = rows == r
        want = jref.bloom_probe_ref(jnp.asarray(table[r]), jnp.asarray(q[sel]),
                                    nbits, h)
        assert np.array_equal(np.asarray(want), got[torch.from_numpy(sel)].numpy())


@pytest.mark.parametrize("nbits", [8192, 8177])
@pytest.mark.parametrize("h", [1, 2, 3, 4, 5, 6])
def test_bloom_probe_rows_matches_jax_per_row_hashes(rng, h, nbits):
    """Every hash count the kernel instantiates, and an nbits that is not a
    multiple of 32 (the filters are 256-word rows built at 8192 bits, one
    of them dense so that every h has hits); the one-filter form through
    the Pallas kernel in interpret mode."""
    R, Q = 3, 600
    sets = [rng.choice(2**31, 300, replace=False).astype(np.uint32)
            for _ in range(R)]
    table = np.stack([np.asarray(jref.bloom_build_ref(jnp.asarray(s), 8192, h))
                      for s in sets])
    table[2] = (rng.random((256, 32)) < 0.9).astype(np.uint32) @ (
        np.uint32(1) << np.arange(32, dtype=np.uint32))
    rows = rng.integers(0, R, Q).astype(np.int32)
    q = np.where(rng.random(Q) < 0.5, np.stack(sets)[rows, rng.integers(0, 300, Q)],
                 rng.integers(0, 2**32, Q)).astype(np.uint32)
    q[:3] = [0, KEY_MAX - 1, KEY_MAX]
    got = tops.bloom_probe_rows(_k(table), _v(rows), _k(q), nbits=nbits, h=h)
    want = np.stack([np.asarray(jref.bloom_probe_ref(jnp.asarray(table[r]),
                                                     jnp.asarray(q), nbits, h))
                     for r in range(R)])[rows, np.arange(Q)]
    assert np.array_equal(want, got.numpy())
    assert got[torch.from_numpy(rows == 2)].any()
    _same(jops.bloom_probe(jnp.asarray(table[2]), jnp.asarray(q), nbits=nbits,
                           h=h),
          tops.bloom_probe(_k(table[2]), _k(q), nbits=nbits, h=h))


# -------------------------------------------------------------- range scan
def _scan_both(run, vals, lo, hi, maxr):
    jk, jv, jc = jops.range_scan(jnp.asarray(run), jnp.asarray(vals),
                                 jnp.asarray(np.asarray(lo, np.uint32)),
                                 jnp.asarray(np.asarray(hi, np.uint32)),
                                 max_results=maxr)
    tk, tv, tc = tops.range_scan(_k(run), _v(vals), _k(lo), _k(hi),
                                 max_results=maxr)
    for a, b in ((jk, tk), (jv, tv), (jc, tc)):
        _same(a, b)
    return tk, tv, tc


@pytest.mark.parametrize("n,q,maxr", [(16, 8, 128), (1000, 64, 128),
                                      (5000, 300, 256)])
def test_range_scan_matches_jax(rng, n, q, maxr):
    run = _sorted_run(rng, n, dup=0.1)
    vals = np.arange(n, dtype=np.int32)
    lo = rng.integers(0, 2**31, q).astype(np.uint32)
    hi = (lo.astype(np.uint64) + rng.integers(0, 2**27, q)).clip(
        0, 2**32 - 2).astype(np.uint32)
    _scan_both(run, vals, lo, hi, maxr)


def test_range_scan_edge_cases():
    """Duplicates at the boundary, ranges below/above every key, inverted
    and point ranges, truncation count, and KEY_MAX padding in the run."""
    run = np.array([5, 7, 7, 7, 9, 9], np.uint32)
    k, v, c = _scan_both(run, np.arange(6, dtype=np.int32), [7, 7, 9], [7, 9, 9],
                         128)
    assert c.tolist() == [3, 5, 2]
    assert k[0, :3].tolist() == [7, 7, 7] and v[2, :2].tolist() == [4, 5]
    run = np.array([10, 20, 30, KEY_MAX, KEY_MAX], np.uint32)
    k, v, c = _scan_both(run, np.arange(5, dtype=np.int32),
                         [20, 21, 25, 0, 1000, 0], [20, 29, 15, 2**32 - 2, 2000, 5],
                         128)
    assert c.tolist() == [1, 0, 0, 3, 0, 0]
    assert (k[3, 3:] == KEY_MAX).all()
    k, v, c = _scan_both(np.arange(1, 1001, dtype=np.uint32),
                         np.arange(1000, dtype=np.int32), [1], [2000], 128)
    assert c[0] == 1000 and k[0].tolist() == list(range(1, 129))


def test_range_scan_rows_matches_jax_per_candidate(rng):
    """Candidate (b, m) scans the first counts[b, m] keys of row nodes[b, m]."""
    R, cap, B, M, scan_cap = 4, 512, 24, 4, 64
    counts_row = np.array([0, 3, 400, 512], np.int32)
    tab = [_row(rng, int(c), cap) for c in counts_row]
    keys = np.stack([t[0] for t in tab])
    vals = np.stack([t[1] for t in tab])
    nodes = rng.integers(0, R, (B, M)).astype(np.int32)
    lo = rng.integers(0, 2**31, B).astype(np.uint32)
    hi = (lo.astype(np.uint64) + rng.integers(0, 2**26, B)).astype(np.uint32)
    hi[:4] = lo[:4] - 1                                # inverted: empty
    tk, tv, tn = tops.range_scan_rows(_k(keys), _v(vals), _v(nodes),
                                      _v(counts_row[nodes]), _k(lo), _k(hi),
                                      scan_cap)
    for b in range(B):
        for m in range(M):
            r = nodes[b, m]
            c = counts_row[r]
            jk, jv, jc = jref.range_scan_ref(
                jnp.asarray(np.append(keys[r, :c], np.uint32(KEY_MAX))),
                jnp.asarray(np.append(vals[r, :c], np.int32(0))),
                jnp.asarray(lo[b: b + 1]), jnp.asarray(hi[b: b + 1]), scan_cap)
            _same(jk[0], tk[b, m])
            _same(jv[0], tv[b, m])
            assert int(np.asarray(jc)[0]) == int(tn[b, m])


#: row counts at the edges of the kernel's k-ary windows (4-32 lanes a
#: bound) and the extremes of a 96-slot row
_EDGE_COUNTS = [0, 1, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 95, 96]


@pytest.mark.parametrize("cap,hi_kind", [(3, "KEY_MAX"), (3, "KEY_MAX-1"),
                                         (130, "KEY_MAX"), (64, "KEY_MAX-1"),
                                         (7, "random")])
def test_range_scan_rows_edges_match_jax(rng, cap, hi_kind):
    """Counts at the k-ary window edges, cap not a multiple of 4, hi at
    KEY_MAX and KEY_MAX - 1, and -1-padded candidates passed as the range
    descent passes them (node clamped to 0, count 0)."""
    row_len, B, M = 96, 40, 4
    tab = [_row(rng, c, row_len) for c in _EDGE_COUNTS]
    keys = np.stack([t[0] for t in tab])
    vals = np.stack([t[1] for t in tab])
    counts_row = np.array(_EDGE_COUNTS, np.int32)
    nodes = rng.integers(0, len(tab), (B, M)).astype(np.int32)
    nodes[::3, M // 2:] = -1
    lo = np.where(rng.random(B) < 0.5, 0,
                  rng.integers(0, 2**31, B)).astype(np.uint32)
    hi = {"KEY_MAX": np.full(B, KEY_MAX, np.uint32),
          "KEY_MAX-1": np.full(B, KEY_MAX - 1, np.uint32),
          "random": (lo + rng.integers(0, 2**30, B)).astype(np.uint32)}[hi_kind]
    nid = np.maximum(nodes, 0)
    cnt = np.where(nodes >= 0, counts_row[nid], 0).astype(np.int32)
    tk, tv, tn = tops.range_scan_rows(_k(keys), _v(vals), _v(nid), _v(cnt),
                                      _k(lo), _k(hi), cap)
    assert tk.shape == (B, M, cap)
    # the reference over each row's live prefix, KEY_MAX after it (a padded
    # candidate: none live), every query at once
    ref = {}
    for r, c in {(0, 0), *((r, int(counts_row[r])) for r in range(len(tab)))}:
        run = np.full(row_len + 1, KEY_MAX, np.uint32)
        run[:c] = keys[r, :c]
        rv = np.zeros(row_len + 1, np.int32)
        rv[:c] = vals[r, :c]
        ref[r, c] = [np.asarray(x) for x in jref.range_scan_ref(
            jnp.asarray(run), jnp.asarray(rv), jnp.asarray(lo), jnp.asarray(hi),
            cap)]
    for b in range(B):
        for m in range(M):
            jk, jv, jc = ref[int(nid[b, m]), int(cnt[b, m])]
            _same(jk[b], tk[b, m])
            _same(jv[b], tv[b, m])
            assert int(jc[b]) == int(tn[b, m])
    assert (tn[torch.from_numpy(nodes < 0)] == 0).all()
    # the one-run form (Pallas, interpret mode) over a row and its padding
    r = int(np.argmax(counts_row == 33))
    _scan_both(keys[r], vals[r], lo, hi, cap)


@pytest.mark.parametrize("n", [1, 40, 1000])
def test_range_end_is_one_lower_bound(rng, n):
    """The identity the range kernel's one-run form relies on: over a run
    with KEY_MAX padding, min(ub(hi), n_live) == lb(min(hi, KEY_MAX - 1) +
    1), so the live prefix needs no search of its own."""
    for live in sorted({0, 1, n // 2, n}):
        run = np.full(n, KEY_MAX, np.uint32)
        run[:live] = np.sort(rng.integers(0, 50, live) * (2**26))
        hi = np.concatenate([rng.integers(0, 2**32, 64),
                             run[:live], run[:live] - 1,
                             [0, KEY_MAX - 1, KEY_MAX]]).astype(np.uint32)
        lo = np.zeros_like(hi)
        rk = _k(run)
        end = torch.searchsorted(rk, _k(hi).clamp(max=KEY_MAX - 1) + 1)
        _, _, count = tref.range_scan_ref(rk, _v(np.zeros(n)), _k(lo), _k(hi))
        want = torch.minimum(torch.searchsorted(rk, _k(hi), right=True),
                             (rk != KEY_MAX).sum())
        assert torch.equal(end, want)
        assert torch.equal(count, end.to(torch.int32))     # lo = 0: start 0


# --------------------------------------------------------- paged attention
def _paged_inputs(rng, B, KVH, G, D, S, MP, dtype=np.float32, lens=None):
    P = MP * 4
    q = rng.normal(size=(B, KVH, G, D)).astype(np.float32)
    kp = rng.normal(size=(KVH, P, S, D)).astype(np.float32)
    vp = rng.normal(size=(KVH, P, S, D)).astype(np.float32)
    bt = rng.integers(0, P, (B, MP)).astype(np.int32)
    if lens is None:
        lens = rng.integers(1, MP * S + 1, (B,))
    return q, kp, vp, bt, np.asarray(lens, np.int32)


def _paged_both(q, kp, vp, bt, lens, jdtype=jnp.float32,
                tdtype=torch.float32):
    """The Pallas kernel (interpret mode) and the port's plain version on
    the same inputs, both as fp32 numpy."""
    jout = jops.paged_attention(jnp.asarray(q, jdtype), jnp.asarray(kp, jdtype),
                                jnp.asarray(vp, jdtype), jnp.asarray(bt),
                                jnp.asarray(lens))
    tout = tops.paged_attention(*(torch.from_numpy(x).to(tdtype)
                                  for x in (q, kp, vp)),
                                torch.from_numpy(bt), torch.from_numpy(lens))
    assert tout.dtype == tdtype and tout.shape == q.shape
    return np.asarray(jout, np.float32), tout.float().numpy()


@pytest.mark.parametrize("B,KVH,G,D,S,MP", [
    (2, 1, 8, 128, 16, 4), (4, 2, 8, 128, 16, 6),
    (1, 4, 4, 64, 8, 3), (3, 2, 16, 256, 32, 2),
])
def test_paged_attention_matches_pallas(rng, B, KVH, G, D, S, MP):
    """tests/test_kernels.py's shapes, fp32, its tolerance."""
    j, t = _paged_both(*_paged_inputs(rng, B, KVH, G, D, S, MP))
    np.testing.assert_allclose(t, j, atol=3e-5, rtol=3e-5)


def test_paged_attention_bf16_matches_pallas(rng):
    j, t = _paged_both(*_paged_inputs(rng, 2, 2, 4, 128, 16, 4,
                                      lens=[64, 17]),
                       jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    np.testing.assert_allclose(t, j, atol=3e-2, rtol=3e-2)


def test_paged_attention_empty_sequence_is_mean_of_v(rng):
    """seq_len 0: the Pallas kernel's -1e30 mask is finite, so it averages
    V over all MP*S gathered slots (the ref gives NaN); the port agrees with
    the kernel, not the ref."""
    q, kp, vp, bt, lens = _paged_inputs(rng, 3, 2, 4, 64, 8, 3,
                                        lens=[0, 5, 24])
    j, t = _paged_both(q, kp, vp, bt, lens)
    np.testing.assert_allclose(t, j, atol=3e-5, rtol=3e-5)
    mean_v = vp[:, bt[0]].reshape(2, -1, 64).mean(axis=1)     # (KVH, D)
    np.testing.assert_allclose(t[0], np.broadcast_to(mean_v[:, None], t[0].shape),
                               atol=3e-5, rtol=3e-5)
    assert np.isnan(np.asarray(jref.paged_attention_ref(
        *(jnp.asarray(x) for x in (q, kp, vp, bt, lens)))[0])).all()


def test_paged_attention_one_page(rng):
    j, t = _paged_both(*_paged_inputs(rng, 4, 2, 2, 32, 8, 1, lens=[1, 3, 8, 9]))
    np.testing.assert_allclose(t, j, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("bad", [-1, 12])
def test_paged_attention_rejects_out_of_range_pages(rng, bad):
    q, kp, vp, bt, lens = (torch.from_numpy(x) for x in
                           _paged_inputs(rng, 2, 2, 4, 32, 8, 3))
    bt[1, 2] = bad                                         # P = 12
    with pytest.raises(IndexError, match="outside"):
        tops.paged_attention(q, kp, vp, bt, lens)
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_attention_cuda(q, kp, vp, bt, lens)


def _split_k_model(q, kp, vp, bt, lens, n_splits, ppc=2):
    """The CUDA kernel's algebra in plain PyTorch: split s of each (b, kv
    head) takes the pages [s*pps, (s+1)*pps), pps = ceil(MP / n_splits), in
    chunks of ppc pages with an fp32 online softmax, and leaves (m, l,
    acc); the combine weighs each split by e^(m_s - m*)."""
    B, KVH, G, D = q.shape
    S, MP = kp.shape[2], bt.shape[1]
    pps = -(-MP // n_splits)
    qf, kf, vf = q.float(), kp.float(), vp.float()
    out = torch.empty(B, KVH, G, D)
    for b in range(B):
        for h in range(KVH):
            parts = []
            for s in range(n_splits):
                m = torch.full((G, 1), -1e30)
                l = torch.zeros(G, 1)
                acc = torch.zeros(G, D)
                pages = range(s * pps, min(MP, (s + 1) * pps))
                for c in range(0, len(pages), ppc):
                    chunk = pages[c:c + ppc]
                    k = kf[h, bt[b, list(chunk)].long()].reshape(-1, D)
                    v = vf[h, bt[b, list(chunk)].long()].reshape(-1, D)
                    slot = chunk[0] * S + torch.arange(len(chunk) * S)
                    sc = (qf[b, h] @ k.T) * (1.0 / D ** 0.5)
                    sc = torch.where(slot < int(lens[b]), sc, -1e30)
                    m_new = torch.maximum(m, sc.max(dim=1, keepdim=True).values)
                    p = torch.exp(sc - m_new)
                    alpha = torch.exp(m - m_new)
                    l = alpha * l + p.sum(dim=1, keepdim=True)
                    acc = alpha * acc + p @ v
                    m = m_new
                parts.append((m, l, acc))
            m_star = torch.stack([m for m, _, _ in parts]).max(dim=0).values
            w = [torch.exp(m - m_star) for m, _, _ in parts]
            l_tot = sum(wi * l for wi, (_, l, _) in zip(w, parts))
            o = sum(wi * acc for wi, (_, _, acc) in zip(w, parts))
            out[b, h] = o / torch.where(l_tot == 0, 1.0, l_tot)
    return out.to(q.dtype)


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("n_splits", [1, 2, 3, "MP"])
def test_split_k_combine_matches_plain_and_pallas(rng, G, n_splits):
    """Split-K with MP = 5 pages (not a multiple of 2 or 3; 3 splits of 2
    leave the last split one page): sequence 0 is empty (the mean of V),
    sequence 1 ends in the first page, so every later split of it lies past
    seq_len and must weigh 0.  fp32 tolerance 3e-5, the JAX kernel tests':
    the combine re-associates the softmax sums, nothing else differs."""
    MP = 5
    n_splits = MP if n_splits == "MP" else n_splits
    q, kp, vp, bt, lens = _paged_inputs(rng, 3, 2, G, 32, 4, MP,
                                        lens=[0, 3, 17])
    j, t = _paged_both(q, kp, vp, bt, lens)
    model = _split_k_model(*(torch.from_numpy(x) for x in (q, kp, vp, bt, lens)),
                           n_splits).numpy()
    np.testing.assert_allclose(model, t, atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(model, j, atol=3e-5, rtol=3e-5)
    mean_v = vp[:, bt[0]].reshape(2, -1, 32).mean(axis=1)
    np.testing.assert_allclose(model[0], np.broadcast_to(mean_v[:, None],
                                                         model[0].shape),
                               atol=3e-5, rtol=3e-5)


def test_split_k_combine_bf16_pages(rng):
    """bf16 q and pages, 4 splits of 2 pages over MP = 7: the model computes
    in fp32 from the bf16 inputs as the kernel does; tolerance 3e-2, the
    bf16 rounding of the output."""
    q, kp, vp, bt, lens = _paged_inputs(rng, 2, 2, 4, 64, 8, 7,
                                        lens=[9, 56])
    j, t = _paged_both(q, kp, vp, bt, lens, jdtype=jnp.bfloat16,
                       tdtype=torch.bfloat16)
    args = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, kp, vp)]
    model = _split_k_model(*args, torch.from_numpy(bt), torch.from_numpy(lens),
                           4)
    assert model.dtype == torch.bfloat16
    np.testing.assert_allclose(model.float().numpy(), t, atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(model.float().numpy(), j, atol=3e-2, rtol=3e-2)


def test_paged_attention_rejects_misaligned_pages():
    """The kernel copies pages in 16-byte units: storage off a 16-byte
    boundary, or a page whose bytes are not a multiple of 16, raises before
    any launch (no narrower copy stands in)."""
    pages = torch.zeros(2, 3, 4, 8)                     # 128-byte pages
    check_alignment(pages, pages)
    check_alignment(torch.zeros(2, 3, 2, 4, 8)[1], pages)   # a layer slice
    shifted = torch.zeros(2 * 3 * 4 * 8 + 1)[1:].view(2, 3, 4, 8)
    with pytest.raises(ValueError, match="16-byte"):
        check_alignment(shifted, pages)
    with pytest.raises(ValueError, match="16-byte"):
        check_alignment(pages, shifted)
    odd = torch.zeros(2, 3, 1, 6, dtype=torch.bfloat16)  # 12-byte pages
    with pytest.raises(ValueError, match="16-byte"):
        check_alignment(odd, odd)


# -------------------------------------------------------- dispatch & build
def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrappers take CUDA tensors only: no quiet CPU path."""
    a = _k([1, 2, 3])
    with pytest.raises(ValueError, match="CUDA tensor"):
        merge_sorted_cuda(a, _v([0, 0, 0]), a, _v([0, 0, 0]))
    with pytest.raises(ValueError, match="device"):
        tops.merge_sorted(a.to("meta"), _v([0, 0, 0]), a, _v([0, 0, 0]))
    words = torch.zeros(128, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bloom_build_cuda(a, 4096, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bloom_update_cuda(words, a, 4096, 3)
    for call in (lambda: tops.bloom_build(a.to("meta"), 4096, 3),
                 lambda: tops.bloom_update(words.to("meta"), a, 4096, 3)):
        with pytest.raises(ValueError, match="device"):
            call()


_KEYS = torch.arange(8, dtype=torch.int64)
#: (label, keys, words (None: the build), nbits, h, error)
_BLOOM_REFUSALS = [
    ("keys-int32", _KEYS.int(), 128, 4096, 3, TypeError),
    ("rank-3", _KEYS.view(2, 2, 2), 128, 4096, 3, ValueError),
    ("rank-0", _KEYS[0], 128, 4096, 3, ValueError),
    ("nbits-4100", _KEYS, 128, 4100, 3, ValueError),      # nbits % 32 != 0
    ("nbits-0", _KEYS, 128, 0, 3, ValueError),
    ("h-0", _KEYS, 128, 4096, 0, ValueError),
    ("h-7", _KEYS, 128, 4096, 7, ValueError),
]
_BLOOM_REFUSALS = (
    [("build-" + c[0], c[1], None, *c[3:]) for c in _BLOOM_REFUSALS]
    + [("update-" + c[0], *c[1:]) for c in _BLOOM_REFUSALS]
    + [("update-words-int32", _KEYS, "int32", 4096, 3, TypeError),
       ("update-words-127", _KEYS, 127, 4096, 3, ValueError),
       ("update-words-rank-2", _KEYS, (1, 128), 4096, 3, ValueError)])


@pytest.mark.parametrize("keys,words,nbits,h,error",
                         [c[1:] for c in _BLOOM_REFUSALS],
                         ids=[c[0] for c in _BLOOM_REFUSALS])
def test_bloom_build_wrappers_refuse_bad_inputs(keys, words, nbits, h, error):
    """The build and update kernels' wrappers refuse, before any launch and
    so without a card, what the kernel does not take: a wrong dtype or rank,
    nbits not a multiple of 32 (or none), h outside 1..6, words that do not
    fit the keys."""
    if words is None:
        call = lambda: bloom_build_cuda(keys, nbits, h)  # noqa: E731
    else:
        w = (torch.zeros(128, dtype=torch.int32) if words == "int32"
             else torch.zeros(words, dtype=torch.int64))
        call = lambda: bloom_update_cuda(w, keys, nbits, h)  # noqa: E731
    with pytest.raises(error):
        call()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing toolkit is an error, never a silent fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "CUDA_ROOTS", ())
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert len(_build._digest()) == 16
