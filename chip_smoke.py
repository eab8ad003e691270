#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (the NB-tree device tier, durable and
multi-tenant ingest over it, and the paged-KV serving bridge) on one NVIDIA
card.

Run from the repository root (needs one CUDA card, the CUDA toolkit and no
network)::

    python3 chip_smoke.py

1. Builds the hand-written kernels (``src/repro_torch/kernels/csrc``) and
   holds every kernel against its plain PyTorch version on the card at the
   shapes of the path that runs it and on the edge cases of the kernel
   tests: the integer kernels bit for bit, ``paged_attention`` to the JAX
   kernel tests' tolerances (fp32 3e-5, bf16 3e-2).  Times each (CUDA
   graph replay between CUDA events), its plain version and, where one
   PyTorch call computes the same function, that call.  Every kernel
   also runs an edge sweep and is timed warm and cold (inputs out of L2)
   at its path's shapes; all but the merge are swept over the constants
   their sources fix (``SWEEPS``), each value built as a library of its
   own beside the build, and their ``nvcc -Xptxas -v`` reports are
   printed.  Phase 3 logs the shapes of the range launches it makes.
2. Drives the NB-tree path through the engine a user calls:
   ``TorchNBTreeEngine(f=4, sigma=4096)`` on ``cuda``; a YCSB load phase of
   ``preload = 2^24`` keys over ``key_space = 2^26``, the paper's
   ``insert-heavy`` mix (2^20 ops, batches of 4096), YCSB workload E's short
   scans (``ycsb-e``, zipfian, ~400-key spans, 2^14 ops, batches of 1024),
   then a ``drain``.
3. Holds every QUERY and RANGE answer and the final live table against a
   numpy last-writer-wins oracle of the same stream.
4. Serves qwen3-8b at full width and depth (bf16 weights drawn on the card
   from ``--seed``) through ``repro_torch.serve.engine.Engine``
   (max_batch 4, 1024 pages of 8 slots, fp32 pages): 8 requests of
   256-token prompts, 32 new tokens each.  Every layer's ``paged_attention``
   output on the first and last decode step of each batch is held against
   the plain version; every page must be reclaimed.  Prints prefill and
   decode-step times, tokens/s and the page index's share of each step.
5. Exactness at full width, depth cut to 4 layers, fp32: the engine's
   greedy tokens for 2 requests of 64-token prompts (8 new tokens) must
   equal the contiguous-cache ``decode_step``'s.
6. Durable open-loop ingest with a crash and a restart: ``torch-nbtree``
   at phase 2's shape under ``repro_torch.ingest.IngestFrontend`` with a
   WAL and LSN-keyed snapshots on local disk; a preload of 2^22 keys over
   2^24, then ``insert-heavy`` at 20,000 ops/s (Poisson, on the frontend's
   clock) killed right after the 2048th WAL fsync (acked, not applied).
   ``repro_torch.wal.recover`` must rebuild exactly the preload plus the
   acked commits (a numpy oracle); a fresh frontend on the recovered
   engine serves a second trace and must continue the LSN chain without a
   gap; a second recovery must equal the oracle of both acked prefixes.
   Prints the measured wall times (load, fsyncs, snapshots, maintenance
   units, recoveries) and the device's idle share over the second trace;
   the frontend's per-op latencies on this engine are a virtual service
   model and are printed under that name.
7. Sharded multi-tenant durable ingest, then a hot-shard split.
   7a: ``make_engine("sharded:torch-nbtree", shards=4, partition="range")``
   (f=4, sigma=4096, max_results 128, max_nodes 512 a shard) under
   ``repro_torch.tenancy.MultiTenantFrontend`` in fair mode with a WAL and
   snapshots every 1,024 commits; the four tenants of
   ``workloads/tenants.py::mixed_oltp(n_ops=2^16, base_rate=8000)`` (writer,
   reader, scanner, diurnal), each preloaded with 2^20 keys over a local
   space of 2^22 (one batch, range-partitioned by its sample), killed
   right after the 2048th fsync.  A snapshot of the scanner's namespace
   pinned past commit 1,024 must equal its oracle at its watermark; each
   tenant's ``recover_namespace``, into a fresh ensemble, must equal that
   tenant's preload plus its acked rows (numpy, decoded).  Prints preload
   inserts/s, commits/s, fsync p50/p99, per-tenant virtual e2e p99.9 and
   shed counts, impl calls per commit, each recovery's time and the
   device's idle share over commits 256..767.  7b: two range shards
   (``skew_factor=1.5``), a YCSB load of 2^20 keys over 2^22, then
   ``hotspot-shift`` in batches of 4096 with ``maintain(4)`` after each
   until 16 batches past the first split: every answer and the final table
   must equal a numpy oracle, and the split must read its shard
   (>= 2^18 pairs) out without a capped range scan.

Kernel launch counters are zeroed just before each path (2-3, 4, 6, 7)
and read just after; every kernel must have launched on its own path (the
four NB-tree kernels of the write side and the point reads on phase 6's
too, and those and ``range_scan_rows`` on phase 7's).  Prints a ``kernels`` JSON line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

PEAK_BYTES_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
PEAK_OPS_S = 67e12           # H100 SXM non-tensor fp32 rate (attention's fp32
                             # ops; it stands in for int ops too)
KEY_MAX = 0xFFFFFFFF
RUN_CAP, NW, H = 21504, 6784, 3      # f=4, sigma=4096 node-row shape
#: the path whose launches a kernel's row reports (the NB-tree path if absent)
KERNEL_PATH = {"paged_attention": "serve"}
#: kernels phase 6's durable ingest path must launch (its write side and
#: its point reads)
INGEST_KERNELS = ("merge_sorted", "merge_sorted_batch", "sorted_search_rows",
                  "bloom_probe_rows")
#: kernels phase 7's sharded multi-tenant path must launch (the write side,
#: the reader's point reads and the scanner's ranges)
TENANCY_KERNELS = INGEST_KERNELS + ("range_scan_rows",)


def log(*a):
    print(*a, flush=True)


def call_ms(fn, reps: int) -> float:
    """Mean time per call of ``fn`` as a caller sees it: CUDA events around
    ``reps`` back-to-back calls, so host launch overhead counts too."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(calls) -> float:
    """Mean device time of the calls in ``calls``: captured in this order in
    one CUDA graph and replayed between CUDA events, so no host time sits
    between them."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / len(calls)


def device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` called ``reps`` times on the same inputs
    (warm caches), timed by ``graph_ms``."""
    return graph_ms([fn] * reps)


def max_abs_err(got, want) -> int:
    """Largest elementwise difference of two output tuples; raises on any
    shape or dtype mismatch."""
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"output {tuple(g.shape)}/{g.dtype} vs "
                                 f"plain {tuple(w.shape)}/{w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def assert_exact(name, cuda_fn, plain_fn, *args, **kw):
    got, want = cuda_fn(*args, **kw), plain_fn(*args, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs err {err})")
    return err


def sorted_rows(g, R, n, hi, dev):
    return torch.sort(torch.randint(0, hi, (R, n), generator=g, device=dev),
                      dim=1).values


def table_rows(g, R, dev):
    """A node table: sorted keys (duplicates included) up to each row's
    count, KEY_MAX after it with stale values; counts 0 .. RUN_CAP."""
    keys = sorted_rows(g, R, RUN_CAP, 2**31, dev)
    keys[:, 1::7] = keys[:, 0::7][:, : keys[:, 1::7].shape[1]]   # duplicates
    keys = torch.sort(keys, dim=1).values
    counts = torch.randint(0, RUN_CAP + 1, (R,), generator=g, device=dev,
                           dtype=torch.int32)
    counts[:4] = torch.tensor([0, 1, RUN_CAP, RUN_CAP - 1], dtype=torch.int32)
    dead = torch.arange(RUN_CAP, device=dev)[None, :] >= counts[:, None]
    keys = torch.where(dead, KEY_MAX, keys)
    vals = torch.randint(0, 2**31 - 1, (R, RUN_CAP), generator=g, device=dev,
                         dtype=torch.int32)
    return keys, vals, counts


def search_len(cnt):
    """Keys a lower-bound search over cnt keys reads."""
    return torch.ceil(torch.log2(cnt.double() + 1)) + 1


COLD_BYTES = 64e6            # L2 is 50 MB: cold timings rotate through more
MERGE_T, MERGE_E, MERGE_W = 512, 4, 128   # MS_T, MS_E, MS_W of merge_sorted.cu


def merge_ops(out_n: int) -> float:
    """Integer ops of the merge kernel for out_n outputs (6 a compare-and-
    step): per tile 2 x 32 device-memory probes; per thread a binary search
    over the staged spans (at most T + 4W + 2 elements); per output one
    merge step."""
    tiles, threads = out_n / MERGE_T, out_n / MERGE_E
    search = np.ceil(np.log2(MERGE_T + 4 * MERGE_W + 2))
    return 6 * (tiles * 64 + threads * search + out_n)


PTXAS_SOURCES = ("merge_sorted.cu", "sorted_search.cu", "bloom_filter.cu",
                 "range_scan.cu", "paged_attention.cu")


def ptxas_report(source: str, out_dir: str) -> subprocess.Popen:
    """Start ``nvcc -Xptxas -v`` on one kernel source, with the build's
    flags, for its registers, shared memory and spills."""
    from repro_torch.kernels import _build

    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-c",
         str(_build.CSRC / source),
         "-o", str(Path(out_dir) / f"{Path(source).stem}_report.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def merge_rows(g, dev, R, raw, hi, live=None):
    """(R, raw) sorted int64 keys in [0, hi), KEY_MAX from each row's
    ``live`` count on (a stale tail, as node rows and ``_window`` rows
    carry), and nonzero int32 values everywhere, the tail included."""
    keys = sorted_rows(g, R, raw, hi, dev)
    if live is not None:
        dead = torch.arange(raw, device=dev)[None, :] >= torch.as_tensor(
            live, device=dev)[:, None]
        keys = torch.where(dead, KEY_MAX, keys)
    vals = torch.randint(1, 2**31 - 1, (R, raw), generator=g, device=dev,
                         dtype=torch.int32)
    return keys, vals


def flush_inputs(g, dev):
    """The flush fan-out's merge inputs: 4 pivot windows of 4096 (many
    duplicates, one all-KEY_MAX: an untouched child) into 4 node rows."""
    R, n = 4, 4096
    ak = sorted_rows(g, R, n, 2**20, dev)
    av = torch.randint(0, 2**31 - 1, (R, n), generator=g, device=dev,
                       dtype=torch.int32)
    bk, bv, _ = table_rows(g, R, dev)
    bk[1, : n] = ak[1]                                     # shared keys: a first
    bk = torch.sort(bk, dim=1).values
    ak[3] = KEY_MAX                                        # empty run identity
    return ak, av, bk, bv


def merge_edge_cases(g, dev):
    """(label, a_keys, a_vals, b_keys, b_vals), rows (R, a_raw) / (R, b_raw):
    the merge kernel's edge sweep."""
    cases = []
    # one key repeated over several whole tiles in both runs
    ak, av = merge_rows(g, dev, 2, 3000, 5)
    bk, bv = merge_rows(g, dev, 2, 5000, 5)
    ak[:, 200:2700], bk[:, 100:4100] = 3, 3
    cases.append(("one key over whole tiles", torch.sort(ak).values, av,
                  torch.sort(bk).values, bv))
    # tie groups across tile and 1024 boundaries of a, b and the output:
    # a = base[:2100], b = base, one key over a[1000:1050] and b[990:1080]
    # (output ~1990..2130), another over a[2040:2060] and b[2030:2090]
    base, bv = merge_rows(g, dev, 3, 3100, 2**20)
    _, av = merge_rows(g, dev, 3, 2100, 1)
    ak, bk = base[:, :2100].clone(), base.clone()
    for (lo, hi), (blo, bhi) in (((1000, 1050), (990, 1080)),
                                 ((2040, 2060), (2030, 2090))):
        ak[:, lo:hi] = base[:, lo:lo + 1]
        bk[:, blo:bhi] = base[:, lo:lo + 1]
    cases.append(("ties across 1024 boundaries", ak, av, bk, bv))
    # raw lengths off every tile and 1024 multiple; R = 1, 2, 3, 5
    for R, a_raw, b_raw in ((1, 1, 1537), (2, 1025, 1023), (3, 1025, 2049),
                            (5, 513, 3073), (5, 4097, 21505)):
        ak, av = merge_rows(g, dev, R, a_raw, 2**16)
        bk, bv = merge_rows(g, dev, R, b_raw, 2**16)
        cases.append((f"R={R} raw {a_raw}+{b_raw}", ak, av, bk, bv))
    # all-KEY_MAX a-run, all-KEY_MAX b-run, both (values stale and nonzero)
    for R, la, lb in ((3, 0, 1500), (2, 700, 0), (1, 0, 0)):
        ak, av = merge_rows(g, dev, R, 1300, 2**31, live=[la] * R)
        bk, bv = merge_rows(g, dev, R, 2500, 2**31, live=[lb] * R)
        cases.append((f"KEY_MAX runs, live {la}+{lb}", ak, av, bk, bv))
    # stale KEY_MAX tails in both runs, as _window and leaf rows carry them
    ak, av = merge_rows(g, dev, 5, 4096, 2**31, live=[0, 1, 1000, 2048, 4096])
    bk, bv = merge_rows(g, dev, 5, RUN_CAP, 2**31,
                        live=[RUN_CAP, 0, 20000, 1023, 1025])
    cases.append(("stale KEY_MAX tails", ak, av, bk, bv))
    # random shapes
    draw = lambda lo, hi: int(torch.randint(lo, hi, (1,), generator=g,
                                            device=dev))
    for c in range(50):
        R = (1, 2, 3, 5)[draw(0, 4)]
        a_raw, b_raw = draw(0, 6000), draw(1, 9000)
        hi = (1, 4, 1000, 2**32 - 1)[draw(0, 4)]
        la = [draw(0, a_raw + 1) if draw(0, 3) == 0 else a_raw for _ in range(R)]
        lb = [draw(0, b_raw + 1) if draw(0, 3) == 0 else b_raw for _ in range(R)]
        ak, av = merge_rows(g, dev, R, a_raw, hi, live=la)
        bk, bv = merge_rows(g, dev, R, b_raw, hi, live=lb)
        cases.append((f"random {c}: R={R} raw {a_raw}+{b_raw} keys < {hi}",
                      ak, av, bk, bv))
    return cases


def merge_edge_sweep(g, dev) -> int:
    """Both entry points on the edge cases, bit for bit against the plain
    version."""
    from repro_torch.kernels import merge_sorted as ms

    cases = merge_edge_cases(g, dev)
    err = n_checks = 0
    for label, ak, av, bk, bv in cases:
        err = max(err, assert_exact(f"merge_sorted_batch {label}",
                                    ms.merge_sorted_batch_cuda,
                                    ms.merge_sorted_plain, ak, av, bk, bv))
        n_checks += 1
        if ak.shape[0] == 1:
            err = max(err, assert_exact(f"merge_sorted {label}",
                                        ms.merge_sorted_cuda,
                                        ms.merge_sorted_plain,
                                        ak[0], av[0], bk[0], bv[0]))
            n_checks += 1
    log(f"  merge edge sweep: {len(cases)} cases, {n_checks} kernel calls "
        f"bit-exact vs plain")
    return err


def merge_timings(g, dev) -> None:
    """The merge kernel at both main-path shapes, warm (20 calls on one
    input set) and cold (one call on each of a rotation of input sets
    holding more than the L2 cache), and the launch floor: an empty kernel
    replayed the same way."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import merge_sorted as ms

    root = lambda ak, av, bk, bv: (ak[0].contiguous(), av[0].contiguous(),
                                   bk[2].contiguous(), bv[2].contiguous())
    shapes = {"merge_sorted_batch": (ms.merge_sorted_batch_cuda, lambda *t: t),
              "merge_sorted": (ms.merge_sorted_cuda, root)}
    for name, (fn, cut) in shapes.items():
        one = cut(*flush_inputs(g, dev))
        in_bytes = sum(t.nbytes for t in one)
        sets = [one] + [cut(*flush_inputs(g, dev))
                        for _ in range(int(COLD_BYTES // in_bytes))]
        warm = device_ms(lambda: fn(*one), 20)
        cold = graph_ms([lambda s=s: fn(*s) for s in sets])
        log(f"  {name}: warm {warm:.5f} ms, cold {cold:.5f} ms "
            f"({len(sets)} input sets, {len(sets) * in_bytes} input bytes)")
        del sets, one
    floor_warm = device_ms(lambda: _build.launch("empty_launch", dev), 20)
    floor = graph_ms([lambda: _build.launch("empty_launch", dev)] * 200)
    log(f"  launch floor (empty kernel in a CUDA graph): {floor_warm:.5f} ms "
        f"over 20 launches, {floor:.5f} ms over 200")
    torch.cuda.empty_cache()


SEARCH_W = (8, 16, 32)                        # SS_W values the sweep builds
BLOOM_THREADS = (64, 128, 256)                # BP_THREADS values
RANGE_W = (4, 8, 16)                          # RS_W values
RANGE_WARPS = (2, 4, 8)                       # RS_WARPS values
PA_SPLIT_CTAS = (32, 64, 128, 160, 256, 384)   # PA_SPLIT_CTAS values
#: the swept constant of each kernel source, and the key of its variants
SWEEPS = {"SS_W": ("sorted_search.cu", SEARCH_W, "search"),
          "BP_THREADS": ("bloom_filter.cu", BLOOM_THREADS, "bloom"),
          "RS_W": ("range_scan.cu", RANGE_W, "range lanes"),
          "RS_WARPS": ("range_scan.cu", RANGE_WARPS, "range warps"),
          "PA_SPLIT_CTAS": ("paged_attention.cu", PA_SPLIT_CTAS, "attention")}


def variant_builds(out_dir: str) -> list:
    """Start one ``nvcc`` for each swept value of a kernel's tile constant:
    the kernel's source and ``errors.cu`` with ``-D<constant>=<value>`` into
    a library of their own.  Returns (source, constant, value, path, proc)."""
    from repro_torch.kernels import _build

    jobs = [(source, macro, v) for macro, (source, values, _) in SWEEPS.items()
            for v in values]
    out = []
    for source, macro, value in jobs:
        so = Path(out_dir) / f"{Path(source).stem}_{macro}_{value}.so"
        out.append((source, macro, value, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-D{macro}={value}",
             "-shared", str(_build.CSRC / source),
             str(_build.CSRC / "errors.cu"), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return out


def load_variant(so: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = ctypes.CDLL(str(so))
    for name, args in _build.SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
    lib.repro_torch_error_string.argtypes = [ctypes.c_int]
    lib.repro_torch_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def kernel_library(lib):
    """The wrappers launch from ``lib`` (a swept variant) inside the block."""
    from repro_torch.kernels import _build

    real = _build.library
    _build.library = lambda: lib
    try:
        yield
    finally:
        _build.library = real


# ------------------------------------------------------------ search sweeps
def search_edge_cases(g, dev):
    """(label, table_keys, table_vals, rows, counts, q): the search kernel's
    edge sweep, on rows of RUN_CAP slots."""
    R = 8
    keys = sorted_rows(g, R, RUN_CAP, 2**31 - 200, dev) + 100   # keys >= 100
    keys[1] = 777                                # one key over the whole row
    keys[2, 1000:15000] = keys[2, 1000]          # one key over many windows
    keys[3, :] = torch.sort(keys[3] % 50).values # many short tie groups
    keys = torch.sort(keys, dim=1).values
    vals = torch.randint(0, 2**31 - 1, (R, RUN_CAP), generator=g, device=dev,
                         dtype=torch.int32)
    i32 = lambda x: torch.as_tensor(x, device=dev, dtype=torch.int32)
    i64 = lambda x: torch.as_tensor(x, device=dev, dtype=torch.int64)
    cases = []
    counts = sorted({0, 1, RUN_CAP - 1, RUN_CAP}
                    | {w + d for w in SEARCH_W for d in (-1, 0, 1)})
    for c in counts:        # every row, 4 queries each: the last live key,
        rows = torch.arange(R, device=dev,       # one below, one above, KEY_MAX
                            dtype=torch.int32).repeat_interleave(4)
        cnt = torch.full_like(rows, c)
        live = keys.clone()
        live[:, c:] = KEY_MAX                     # a stale KEY_MAX tail
        last = live[rows.long(), max(c - 1, 0)]
        kind = torch.arange(rows.numel(), device=dev) % 4
        q = torch.where(kind == 0, last, torch.where(
            kind == 1, last - 1, torch.where(kind == 2, last + 1, KEY_MAX)))
        cases.append((f"count {c}", live, vals, rows, cnt,
                      q.clamp(0, KEY_MAX).contiguous()))
    rows = i32([1, 1, 1, 2, 2, 2, 3, 3, 3, 0, 0, 0, 0])
    cnt = torch.full_like(rows, RUN_CAP)
    q = i64([777, 776, 778, int(keys[2, 1000]), int(keys[2, 1000]) - 1,
             int(keys[2, 1000]) + 1, 0, 25, 49, 0, 99,   # below every key
             2**31 + 5, KEY_MAX])                        # above every key
    cases.append(("duplicates over probe windows; below / above every key",
                  keys, vals, rows, cnt, q))
    for Q in (1, 37, 255, 257):                   # group counts off a CTA's
        rows = torch.randint(0, R, (Q,), generator=g, device=dev,
                             dtype=torch.int32)
        cnt = torch.randint(0, RUN_CAP + 1, (Q,), generator=g, device=dev,
                            dtype=torch.int32)
        pick = torch.minimum(torch.randint(0, RUN_CAP, (Q,), generator=g,
                                           device=dev), cnt.long().clamp(min=1) - 1)
        q = keys[rows.long(), pick]
        cases.append((f"Q = {Q}", keys, vals, rows, cnt, q))
    return cases


def search_edge_sweep(g, dev) -> tuple:
    """Both entry points on the edge cases, bit for bit against the plain
    version; the one-run form on prefixes of the rows (KEY_MAX tails
    included)."""
    from repro_torch.kernels import sorted_search as ss

    err = n_checks = 0
    for label, keys, vals, rows, cnt, q in search_edge_cases(g, dev):
        err = max(err, assert_exact(f"sorted_search_rows {label}",
                                    ss.sorted_search_rows_cuda,
                                    ss.sorted_search_rows_plain, keys, vals,
                                    rows, cnt, q))
        found, _, _ = ss.sorted_search_rows_cuda(keys, vals, rows, cnt, q)
        assert not found[q == KEY_MAX].any(), f"{label}: KEY_MAX matched"
        n_checks += 1
        r, n = int(rows[0]), int(cnt[0])
        run, rv = keys[r, : max(n, 1)].contiguous(), vals[r, : max(n, 1)].contiguous()
        err = max(err, assert_exact(f"sorted_search {label}",
                                    ss.sorted_search_cuda,
                                    ss.sorted_search_plain, run, rv, q))
        n_checks += 1
    return err, n_checks


def search_sets(g, dev, tkeys, tcounts, shape: str, n_sets: int) -> list:
    """Query sets (rows, counts, q) of one main-path shape:
    ``4096``: 4096 queries, one per row of the table, 40 % misses (the
    shape phase 1 has always timed); ``205``: a point-read batch of
    insert-heavy (5 % of
    4096) on random rows; ``144``: the page index's block-table read, 144
    queries on one row of 144 live keys.  Each set draws anew."""
    T = tkeys.shape[0]
    sets = []
    for _ in range(n_sets):
        if shape == "144":
            r = int(torch.randint(0, T, (1,), generator=g, device=dev))
            while int(tcounts[r]) < 144:
                r = (r + 1) % T
            rows = torch.full((144,), r, dtype=torch.int32, device=dev)
            cnt = torch.full_like(rows, 144)
            q = tkeys[r, torch.randperm(144, generator=g, device=dev)]
        else:
            Q = int(shape)
            rows = (torch.randperm(T, generator=g, device=dev)[:Q]
                    .to(torch.int32))
            cnt = tcounts[rows.long()]
            pick = torch.randint(0, RUN_CAP, (Q,), generator=g, device=dev)
            q = tkeys[rows.long(),
                      torch.minimum(pick, (cnt.long() - 1).clamp(min=0))]
            miss = torch.rand(Q, generator=g, device=dev) < 0.4
            q = torch.where(miss, torch.randint(0, 2**32 - 1, (Q,), generator=g,
                                                device=dev), q)
        sets.append((rows, cnt, q))
    return sets


def search_bound_ms(cnt) -> float:
    """Phase 1's bound of one search launch: 8 bytes per key a binary
    search reads, plus each query's inputs and outputs."""
    reads = search_len(cnt).sum().item()
    nbytes = 8 * reads + cnt.numel() * (4 + 8 + 4 + 4 + 1 + 4 + 4)
    return max(nbytes / PEAK_BYTES_S, reads * 6 / PEAK_OPS_S) * 1e3


def search_timings(g, dev, tkeys, tvals, tcounts, label: str) -> dict:
    """``sorted_search_rows`` at the three shapes, warm (20 calls on one
    set) and cold (one call on each of 64 sets: leaf probes of different
    rows, or different rows, each call), each set checked bit for bit."""
    from repro_torch.kernels import sorted_search as ss

    out = {}
    for shape in ("4096", "205", "144"):
        sets = search_sets(g, dev, tkeys, tcounts, shape, 64)
        for rows, cnt, q in sets[:4]:
            assert_exact(f"sorted_search_rows {label} Q={shape}",
                         ss.sorted_search_rows_cuda,
                         ss.sorted_search_rows_plain, tkeys, tvals, rows, cnt, q)
        rows, cnt, q = sets[0]
        warm = device_ms(lambda: ss.sorted_search_rows_cuda(
            tkeys, tvals, rows, cnt, q), 20)
        cold = graph_ms([lambda s=s: ss.sorted_search_rows_cuda(tkeys, tvals, *s)
                         for s in sets])
        out[shape] = (warm, cold, search_bound_ms(cnt))
        log(f"  sorted_search_rows {label} Q={shape}: warm {warm:.5f} ms, cold "
            f"{cold:.5f} ms, bound {out[shape][2]:.6f} ms")
    return out


# ------------------------------------------------------- bloom probe sweeps
PAGE_NW = 3584       # Bloom words of a page-index row (f=4, sigma=2048)
HASHES = (1, 2, 3, 4, 5, 6)


def pack_bits(bits):
    """(R, 32 * nw) 0/1 cells -> (R, nw) words, bit i % 32 of word i // 32."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (bits.view(bits.shape[0], -1, 32).long() << shifts).sum(-1)


def bloom_table(tkeys):
    """The node table's filters, built as the index builds them (chunks of
    128 rows); row 5 is emptied (an all-zero filter)."""
    from repro_torch.kernels import ops

    T = tkeys.shape[0]
    bloom = torch.empty((T, NW), dtype=torch.int64, device=tkeys.device)
    for i in range(0, T, 128):
        bloom[i:i + 128] = ops.bloom_build(tkeys[i:i + 128], NW * 32, H)
    bloom[5] = 0
    return bloom


def page_bloom_table(g, dev):
    """4096 page-index filter rows of random words: 117 MB, more than L2."""
    return torch.randint(0, KEY_MAX + 1, (4096, PAGE_NW), generator=g,
                         device=dev)


def bloom_edge_cases(g, dev):
    """(label, table, rows, q, nbits, h): the probe's edge sweep over 64
    filter rows of NW words: even rows built from 2000 keys, odd rows and the
    last one dense (90 % of bits set, so h = 6 probes hit), row 5 all zero.
    Every query set probes the last row and the empty one and holds keys 0,
    KEY_MAX - 1 and KEY_MAX, as far as Q allows."""
    from repro_torch.kernels import ops

    R = 64
    members = torch.randint(0, KEY_MAX, (R, 2000), generator=g, device=dev)
    table = ops.bloom_build(members, NW * 32, H)
    dense = pack_bits(torch.rand((R, NW * 32), generator=g, device=dev) < 0.9)
    table[1::2] = dense[1::2]
    table[R - 1] = dense[R - 1]
    table[5] = 0

    def queries(Q):
        rows = torch.randint(0, R, (Q,), generator=g, device=dev,
                             dtype=torch.int32)
        pick = torch.randint(0, 2000, (Q,), generator=g, device=dev)
        q = torch.where(torch.rand(Q, generator=g, device=dev) < 0.5,
                        members[rows.long(), pick],
                        torch.randint(0, KEY_MAX + 1, (Q,), generator=g,
                                      device=dev))
        rows[:2] = torch.tensor([R - 1, 5], dtype=torch.int32, device=dev)[:Q]
        q[:3] = torch.tensor([0, KEY_MAX - 1, KEY_MAX], device=dev)[:Q]
        return rows, q

    cases = []
    for h in HASHES:
        for nbits in (NW * 32, NW * 32 - 1, NW * 32 - 80, 1009):
            cases.append((f"h={h} nbits={nbits}", table, *queries(4096),
                          nbits, h))
    for Q in (1, 37, 255, 257):
        cases.append((f"Q = {Q}", table, *queries(Q), NW * 32, H))
    return cases


def bloom_edge_sweep(g, dev) -> tuple:
    """Both entry points on the edge cases, bit for bit against the plain
    version; the one-filter form on the last row, the empty row and a random
    one in turn."""
    from repro_torch.kernels import bloom_filter as bf

    err = n_checks = 0
    for i, (label, table, rows, q, nbits, h) in enumerate(
            bloom_edge_cases(g, dev)):
        err = max(err, assert_exact(f"bloom_probe_rows {label}",
                                    bf.bloom_probe_rows_cuda,
                                    bf.bloom_probe_rows_plain, table, rows, q,
                                    nbits=nbits, h=h))
        words = table[(table.shape[0] - 1, 5, int(rows[-1]))[i % 3]]
        err = max(err, assert_exact(f"bloom_probe {label}", bf.bloom_probe_cuda,
                                    bf.bloom_probe_plain, words, q,
                                    nbits=nbits, h=h))
        n_checks += 2
    return err, n_checks


def bloom_sets(g, dev, bloom, page_bloom, tkeys, tcounts, shape: str,
               n_sets: int) -> list:
    """Probe sets (table, rows, q) of one main-path shape, 40 % misses:
    ``4096``: 4096 queries, one per row of the 4096-row table (the shape
    phase 1 has always timed); ``205``: a point-read batch of insert-heavy
    over the descent's node rows, random rows of one 256-row slice of the
    table (the 16 slices of 14 MB in turn); ``144``: the page index's
    block-table read, 144 queries on one row of a table of page-index
    filters (PAGE_NW words), another row each set."""
    T = tkeys.shape[0]
    page_rows = torch.randperm(page_bloom.shape[0], generator=g, device=dev)
    sets = []
    for i in range(n_sets):
        if shape == "144":
            rows = torch.full((144,), int(page_rows[i]), dtype=torch.int32,
                              device=dev)
            q = torch.randint(0, KEY_MAX, (144,), generator=g, device=dev)
            sets.append((page_bloom, rows, q))
            continue
        if shape == "205":
            s = i % (T // 256)
            table = bloom[s * 256:(s + 1) * 256]
            rows = torch.randint(0, 256, (205,), generator=g, device=dev,
                                 dtype=torch.int32)
            key_rows = rows.long() + s * 256
        else:
            table = bloom
            rows = torch.randperm(T, generator=g, device=dev).to(torch.int32)
            key_rows = rows.long()
        Q = rows.numel()
        cnt = tcounts[key_rows].long()
        pick = torch.randint(0, RUN_CAP, (Q,), generator=g, device=dev)
        q = tkeys[key_rows, torch.minimum(pick, (cnt - 1).clamp(min=0))]
        miss = torch.rand(Q, generator=g, device=dev) < 0.4
        q = torch.where(miss, torch.randint(0, KEY_MAX, (Q,), generator=g,
                                            device=dev), q)
        sets.append((table, rows, q))
    return sets


def bloom_bound_ms(Q: int, h: int) -> float:
    """One probe launch: each query's row, key, output and h words moved
    once; ~12 integer ops a hash."""
    return max(Q * (h * 8 + 8 + 4 + 1) / PEAK_BYTES_S,
               Q * h * 12 / PEAK_OPS_S) * 1e3


def bloom_timings(g, dev, bloom, page_bloom, tkeys, tcounts,
                  label: str) -> dict:
    """``bloom_probe_rows`` at the three shapes, warm (20 calls on one set)
    and cold (one call on each of 64 sets, over tables of more than 64 MB),
    the first sets checked bit for bit."""
    from repro_torch.kernels import bloom_filter as bf

    def probe(table, rows, q):
        return bf.bloom_probe_rows_cuda(table, rows, q,
                                        nbits=table.shape[1] * 32, h=H)

    def plain(table, rows, q):
        return bf.bloom_probe_rows_plain(table, rows, q,
                                         nbits=table.shape[1] * 32, h=H)

    out = {}
    for shape in ("4096", "205", "144"):
        sets = bloom_sets(g, dev, bloom, page_bloom, tkeys, tcounts, shape, 64)
        for s in sets[:4]:
            assert_exact(f"bloom_probe_rows {label} Q={shape}", probe, plain,
                         *s)
        warm = device_ms(lambda: probe(*sets[0]), 20)
        cold = graph_ms([lambda s=s: probe(*s) for s in sets])
        out[shape] = (warm, cold, bloom_bound_ms(sets[0][1].numel(), H))
        log(f"  bloom_probe_rows {label} Q={shape}: warm {warm:.5f} ms, cold "
            f"{cold:.5f} ms, bound {out[shape][2]:.6f} ms")
    return out


# -------------------------------------------------------- range scan sweeps
#: the ycsb-e path's range launch (phase 3 logs the shapes it sees): 973
#: ranges padded to 1024 by repeating the last, 16 candidates with ~9 real
#: nodes, cap = the engine's max_results, 256 after its first doubling
YCSB_E_B, YCSB_E_PAD, YCSB_E_M, YCSB_E_CAP = 973, 1024, 16, 256
#: row counts of the range edge sweep: the edges of the k-ary search's last
#: window at every group width, and the extremes
RANGE_COUNTS = tuple(sorted({0, 1, RUN_CAP - 1, RUN_CAP}
                            | {w + d for w in (4, 8, 16, 32) for d in (-1, 0, 1)}))


def range_edge_table(g, dev):
    """Rows of RUN_CAP slots, one per count of RANGE_COUNTS, then a full
    row of distinct keys
    (spans of exactly cap) and a full row of 300 keys, each many times;
    KEY_MAX with stale values past each count."""
    R = len(RANGE_COUNTS) + 2
    keys = sorted_rows(g, R, RUN_CAP, 2**24, dev)
    keys[:, 1::7] = keys[:, 0::7][:, : keys[:, 1::7].shape[1]]   # duplicates
    keys[R - 2] = torch.randperm(2**24, generator=g, device=dev)[:RUN_CAP]
    keys[R - 1] = torch.randint(0, 300, (RUN_CAP,), generator=g, device=dev)
    keys = torch.sort(keys, dim=1).values
    counts = torch.tensor(RANGE_COUNTS + (RUN_CAP, RUN_CAP), device=dev,
                          dtype=torch.int32)
    keys = torch.where(torch.arange(RUN_CAP, device=dev)[None, :]
                       >= counts[:, None], KEY_MAX, keys)
    vals = torch.randint(0, 2**31 - 1, (R, RUN_CAP), generator=g, device=dev,
                         dtype=torch.int32)
    return keys, vals, counts


def range_edge_queries(g, dev, keys, counts, B, M, cap):
    """(nodes, counts, lo, hi, kind) for B queries of M candidates over the
    edge table, kind = b % 8: a random span; lo > hi; lo = hi on a key held
    many times; [0, KEY_MAX - 1]; [0, KEY_MAX]; exactly cap and cap + 1 keys
    of the distinct row (its candidate first); [random, KEY_MAX].  Every
    third query's second half of candidates is padding, node -1 clamped to
    0 with count 0, as the range descent passes it."""
    R = keys.shape[0]
    few, distinct = R - 1, R - 2
    nodes = torch.randint(0, R, (B, M), generator=g, device=dev)
    kind = torch.arange(B, device=dev) % 8
    nodes[kind == 2, 0] = few
    nodes[(kind == 5) | (kind == 6), 0] = distinct
    i = torch.randint(0, RUN_CAP - cap - 1, (B,), generator=g, device=dev)
    lo = torch.randint(0, 2**24, (B,), generator=g, device=dev)
    hi = lo + torch.randint(0, 2**20, (B,), generator=g, device=dev)
    lo = torch.where(kind == 1, lo + 1, lo)
    hi = torch.where(kind == 1, lo - 1, hi)
    dup = keys[few, 5000]
    lo = torch.where(kind == 2, dup, lo)
    hi = torch.where(kind == 2, dup, hi)
    lo = torch.where((kind == 3) | (kind == 4), 0, lo)
    hi = torch.where(kind == 3, KEY_MAX - 1, torch.where(kind >= 4, KEY_MAX, hi))
    lo = torch.where((kind == 5) | (kind == 6), keys[distinct, i], lo)
    hi = torch.where(kind == 5, keys[distinct, i + cap - 1],
                     torch.where(kind == 6, keys[distinct, i + cap], hi))
    pad = (torch.arange(B, device=dev) % 3 == 2)[:, None] & (
        torch.arange(M, device=dev) >= max(M // 2, 1))[None, :]
    nodes = torch.where(pad, 0, nodes)
    cnt = torch.where(pad, 0, counts[nodes])
    return (nodes.to(torch.int32), cnt.to(torch.int32), lo.contiguous(),
            hi.contiguous(), kind)


def range_edge_sweep(g, dev) -> tuple:
    """Both entry points on the edge cases, bit for bit against the plain
    version: caps 1, 3, 64, 128, 130, 256 over 64 x 4 candidates, and B x M
    = 1 and 37; the one-run form on two rows a case, every row once
    (KEY_MAX padding past its count), with the same queries."""
    from repro_torch.kernels import range_scan as rs

    keys, vals, counts = range_edge_table(g, dev)
    err = n_checks = 0
    shapes = [(64, 4, cap) for cap in (1, 3, 64, 128, 130, 256)]
    shapes += [(1, 1, 128), (37, 1, 130)]
    for c, (B, M, cap) in enumerate(shapes):
        nodes, cnt, lo, hi, kind = range_edge_queries(g, dev, keys, counts,
                                                      B, M, cap)
        label = f"B={B} M={M} cap={cap}"
        err = max(err, assert_exact(f"range_scan_rows {label}",
                                    rs.range_scan_rows_cuda,
                                    rs.range_scan_rows_plain, keys, vals,
                                    nodes, cnt, lo, hi, cap))
        _, _, n_match = rs.range_scan_rows_cuda(keys, vals, nodes, cnt, lo,
                                                hi, cap)
        assert (n_match[kind == 1] == 0).all(), f"{label}: lo > hi matched"
        assert (n_match[kind == 5, 0] == cap).all() and \
            (n_match[kind == 6, 0] == cap + 1).all(), \
            f"{label}: spans of cap and cap + 1 keys"
        for r in (c % keys.shape[0], (c + len(shapes)) % keys.shape[0]):
            err = max(err, assert_exact(f"range_scan {label} row {r}",
                                        rs.range_scan_cuda, rs.range_scan_plain,
                                        keys[r], vals[r], lo, hi,
                                        max_results=cap))
        n_checks += 3
    return err, n_checks


def range_sets(g, dev, tkeys, tcounts, shape: str, n_sets: int) -> list:
    """Candidate sets (nodes, counts, lo, hi, cap) of one shape over the
    4096-row table.  ``1024``: phase 1's B=1024, M=8, cap=128: random rows,
    spans up to 2^23 from the first candidate's middle key, the first 24
    queries inverted, on a duplicated boundary key and truncated.
    ``ycsb-e``: the ycsb-e path's launch, YCSB_E_B ranges padded to
    YCSB_E_PAD by repeating the last, YCSB_E_M candidates of which 6 to 12
    real nodes and the rest padding (count 0), spans up to 2^22 (a few dozen
    keys a node row), cap YCSB_E_CAP."""
    T = tkeys.shape[0]
    sets = []
    for _ in range(n_sets):
        if shape == "1024":
            B, M, cap, span_max = 1024, 8, 128, 2**23
        else:
            B, M, cap, span_max = YCSB_E_PAD, YCSB_E_M, YCSB_E_CAP, 2**22
        nodes = torch.randint(0, T, (B, M), generator=g, device=dev,
                              dtype=torch.int32)
        ncnt = tcounts[nodes.long()]
        if shape == "ycsb-e":
            real = torch.randint(6, 13, (B, 1), generator=g, device=dev)
            pad = torch.arange(M, device=dev)[None, :] >= real
            nodes = torch.where(pad, 0, nodes)
            ncnt = torch.where(pad, 0, ncnt)
        lo = tkeys[nodes[:, 0].long(), (ncnt[:, 0].long() // 2)].clamp(max=2**31)
        span = torch.randint(0, span_max, (B,), generator=g, device=dev)
        hi = (lo + span).clamp(max=KEY_MAX - 1)
        if shape == "1024":
            lo[:8] = lo[:8].clamp(min=1)
            hi[:8] = lo[:8] - 1                             # inverted: empty
            lo[8:16] = tkeys[nodes[8:16, 0].long(), 0]      # boundary dups
            hi[8:16] = lo[8:16]
            hi[16:24] = KEY_MAX - 1                         # truncation
            lo[16:24] = 0
        else:                                               # the padding
            last = YCSB_E_B - 1
            nodes[last:], ncnt[last:] = nodes[last], ncnt[last]
            lo[last:], hi[last:] = lo[last], hi[last]
        sets.append((nodes, ncnt, lo.contiguous(), hi.contiguous(), cap))
    return sets


def range_work(ncnt, n_match, cap: int) -> tuple:
    """(bytes, ops) of one range launch: 8 bytes per key the two bounds read
    as binary searches, each matched pair gathered once, the candidates'
    inputs, and every output slot written once."""
    B, M = ncnt.shape
    reads = 2 * search_len(ncnt).sum().item()
    gathered = n_match.clamp(max=cap).sum().item()
    nbytes = (8 * reads + 12 * gathered + B * M * (4 + 4 + 4) + B * 16
              + B * M * cap * 12)
    return nbytes, reads * 6 + B * M * cap * 3


def range_bound_ms(ncnt, n_match, cap: int) -> float:
    nbytes, nops = range_work(ncnt, n_match, cap)
    return max(nbytes / PEAK_BYTES_S, nops / PEAK_OPS_S) * 1e3


def range_timings(g, dev, tkeys, tvals, tcounts, label: str) -> dict:
    """``range_scan_rows`` at phase 1's shape and the ycsb-e path's, warm (20
    calls on one set) and cold (one call on each of 16 or 8 sets, other
    rows each, whose outputs alone pass 64 MB), the first sets checked bit
    for bit."""
    from repro_torch.kernels import range_scan as rs

    scan = lambda s: rs.range_scan_rows_cuda(tkeys, tvals, *s)
    out = {}
    for shape, n_sets in (("1024", 16), ("ycsb-e", 8)):
        sets = range_sets(g, dev, tkeys, tcounts, shape, n_sets)
        for s in sets[:2]:
            assert_exact(f"range_scan_rows {label} {shape}",
                         rs.range_scan_rows_cuda, rs.range_scan_rows_plain,
                         tkeys, tvals, *s)
        nodes, ncnt, _, _, cap = sets[0]
        n_match = scan(sets[0])[2]
        warm = device_ms(lambda: scan(sets[0]), 20)
        cold = graph_ms([lambda s=s: scan(s) for s in sets])
        out[shape] = (warm, cold, range_bound_ms(ncnt, n_match, cap))
        log(f"  range_scan_rows {label} {shape}: B={nodes.shape[0]} "
            f"M={nodes.shape[1]} cap={cap}: warm {warm:.5f} ms, cold {cold:.5f} ms, bound "
            f"{out[shape][2]:.6f} ms")
    return out


# --------------------------------------------------------- attention sweeps
def pa_inputs(g, dev, B, KVH, G, D, S, P, MP, qdt, kvdt, lens=None):
    randn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    if B * MP < P:                           # distinct pages, none the null one
        bt = (torch.randperm(P - 1, generator=g, device=dev)[: B * MP]
              + 1).reshape(B, MP)
    else:
        bt = torch.randint(0, P, (B, MP), generator=g, device=dev)
    if lens is None:
        lens = torch.randint(1, MP * S + 1, (B,), generator=g, device=dev)
    return (randn(B, KVH, G, D).to(qdt), randn(KVH, P, S, D).to(kvdt),
            randn(KVH, P, S, D).to(kvdt), bt.to(torch.int32),
            torch.as_tensor(lens, device=dev).to(torch.int32))


def pa_check(label, tol, args):
    from repro_torch.kernels import paged_attention as pa

    got = pa.paged_attention_cuda(*args)
    want = pa.paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == args[0].dtype
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol, msg=lambda m: f"{label}: {m}")
    return float((got.float() - want.float()).abs().max())


def pa_splits(B, KVH, MP) -> int:
    from repro_torch.kernels import _build

    return _build.library().paged_attention_splits(B, KVH, MP)


def pa_edge_sweep(g, dev) -> tuple:
    """The kernel tests' shapes and the split-K edges, fp32 within 3e-5 and
    bf16 within 3e-2 of the plain version; a misaligned slice and an
    out-of-range page id raise.  Returns (max err fp32, max err bf16, cases,
    the cases' (MP, splits))."""
    from repro_torch.kernels import paged_attention as pa

    f32, bf16 = torch.float32, torch.bfloat16
    err = {f32: 0.0, bf16: 0.0}
    splits = []
    cases = [(2, 1, 8, 128, 16, 4, None), (4, 2, 8, 128, 16, 6, None),
             (1, 4, 4, 64, 8, 3, None), (3, 2, 16, 256, 32, 2, None),
             (4, 2, 2, 32, 8, 1, None),                    # MP = 1
             (1, 1, 4, 128, 8, 3, [24]),                   # splits capped at MP
             (4, 8, 4, 128, 8, 7, [0, 1, 56, 9]),          # MP off the split
             (4, 8, 1, 128, 8, 36, [0, 1, 288, 100]),      # G = 1
             (4, 8, 8, 128, 8, 36, [288, 1, 0, 200]),      # G = 8
             (2, 4, 4, 128, 8, 13, [104, 3])]
    for B, KVH, G, D, S, MP, lens in cases:
        for qdt, kvdt in ((f32, f32), (bf16, bf16), (bf16, f32)):
            tol = 3e-5 if qdt == kvdt == f32 else 3e-2
            args = pa_inputs(g, dev, B, KVH, G, D, S, MP * 4 + 1, MP, qdt,
                             kvdt, lens=lens)
            e = pa_check(f"paged_attention {B, KVH, G, D, S, MP} {qdt}/{kvdt} "
                         f"lens {lens}", tol, args)
            err[f32 if tol == 3e-5 else bf16] = max(err[f32 if tol == 3e-5 else bf16], e)
        splits.append((MP, pa_splits(B, KVH, MP)))
    # seq_len 0: the mean of V over every gathered slot, whatever the split
    args0 = pa_inputs(g, dev, 3, 2, 4, 64, 8, 12, 3, f32, f32, lens=[0, 5, 24])
    err[f32] = max(err[f32], pa_check("paged_attention seq_len 0", 3e-5, args0))
    mean_v = args0[2][:, args0[3][0].long()].reshape(2, -1, 64).mean(dim=1)
    got0 = pa.paged_attention_cuda(*args0)[0]
    torch.testing.assert_close(got0, mean_v[:, None].expand_as(got0),
                               atol=3e-5, rtol=3e-5)
    bad = args0[3].clone()
    bad[1, 2] = 12
    try:
        pa.paged_attention_cuda(*args0[:3], bad, args0[4])
        raise AssertionError("an out-of-range page id must raise")
    except IndexError:
        pass
    n = args0[1].numel()
    flat = torch.empty(n + 4, device=dev)[1:n + 1].view(args0[1].shape)
    try:
        pa.paged_attention_cuda(args0[0], flat, args0[2], *args0[3:])
        raise AssertionError("a misaligned page slice must raise")
    except ValueError:
        pass
    return err[f32], err[bf16], len(cases) * 3 + 1, splits


SERVE_PA = dict(B=4, KVH=8, G=4, D=128, S=8, MP=36)


def pa_serving_sets(g, dev, layers: int = 8) -> list:
    """Inputs at the serving shapes (bf16 q over fp32 pages), one set per
    layer of an (L, KVH, P, S, D) cache of P = 160 pages: 8 layers hold
    84 MB of pages, more than L2, and each call reads a layer's slice as
    the decoder does, with one block table for every layer (its range
    check then runs once, outside the CUDA graph)."""
    c = SERVE_PA
    P = c["B"] * c["MP"] + 16
    shape = (layers, c["KVH"], P, c["S"], c["D"])
    kc = torch.randn(shape, generator=g, device=dev)
    vc = torch.randn(shape, generator=g, device=dev)
    q, _, _, bt, lens = pa_inputs(g, dev, c["B"], c["KVH"], c["G"], c["D"],
                                  c["S"], P, c["MP"], torch.bfloat16,
                                  torch.float32)
    return [(q, kc[layer], vc[layer], bt, lens) for layer in range(layers)]


def pa_timings(sets, label: str) -> tuple:
    """``paged_attention`` at the serving shapes: every set checked against
    the plain version (bf16 3e-2), then warm (20 calls on one set), cold
    (one call on each layer's set) and per call as the decoder makes it
    (200 calls from Python between CUDA events)."""
    from repro_torch.kernels import paged_attention as pa

    for i, args in enumerate(sets):
        pa_check(f"paged_attention {label} layer {i}", 3e-2, args)
    warm = device_ms(lambda: pa.paged_attention_cuda(*sets[0]), 20)
    cold = graph_ms([lambda s=s: pa.paged_attention_cuda(*s) for s in sets] * 3)
    per_call = call_ms(lambda: pa.paged_attention_cuda(*sets[0]), 200)
    log(f"  paged_attention {label}: warm {warm:.5f} ms, cold {cold:.5f} ms, "
        f"per call from Python {per_call:.5f} ms")
    return warm, cold


def path_shape_timings(dev) -> None:
    """``sorted_search_rows``, ``bloom_probe_rows``, ``range_scan_rows`` and
    ``paged_attention`` timed warm and cold at their path's shapes, through
    whatever ``repro_torch`` is importable: run against a checkout of an
    earlier commit (its ``src`` first on ``sys.path``), it times that
    commit's kernels at the same shapes, in the same call as this one's."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    tkeys, tvals, tcounts = table_rows(g, 4096, dev)
    search_timings(g, dev, tkeys, tvals, tcounts, "(this package)")
    bloom_timings(g, dev, bloom_table(tkeys), page_bloom_table(g, dev), tkeys,
                  tcounts, "(this package)")
    range_timings(g, dev, tkeys, tvals, tcounts, "(this package)")
    del tkeys, tvals
    torch.cuda.empty_cache()
    pa_timings(pa_serving_sets(g, dev), "(this package)")
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 1
def phase_kernels(dev, variants: dict) -> dict:
    """Every kernel against its plain version; ``variants`` maps each kind
    of ``SWEEPS`` to {swept value: library}."""
    from repro_torch.kernels import bloom_filter as bf
    from repro_torch.kernels import merge_sorted as ms
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import range_scan as rs
    from repro_torch.kernels import sorted_search as ss

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows = {}

    def record(name, source, replaces, err, cuda_fn, plain_fn, lib_fn,
               nbytes, nops, reps=20):
        ms_k = device_ms(cuda_fn, reps)
        ms_p = device_ms(plain_fn, reps)
        ms_l = device_ms(lib_fn, reps) if lib_fn else None
        ms_call = call_ms(cuda_fn, reps)
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_OPS_S * 1e3
        rows[name] = {"name": name, "route": "cuda",
                      "source": f"src/repro_torch/kernels/csrc/{source}",
                      "replaces": replaces, "launches": 0,
                      "max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                      "library_ms": ms_l}
        log(f"  {name}: max abs err {err} vs plain; kernel {ms_k:.4f} ms "
            f"(per call from Python {ms_call:.4f} ms), plain {ms_p:.4f} ms, library "
            f"{'n/a' if ms_l is None else f'{ms_l:.4f} ms'}, bound "
            f"{rows[name]['bound_ms']:.4f} ms ({rows[name]['bound_by']})")

    # ---- merge: flush fan-out (4 x (4096 + 21504)) and root merge --------
    R, n = 4, 4096
    ak, av, bk, bv = flush_inputs(g, dev)
    err = assert_exact("merge_sorted_batch", ms.merge_sorted_batch_cuda,
                       ms.merge_sorted_plain, ak, av, bk, bv)
    tk, _ = ms.merge_sorted_batch_cuda(ak, av, bk, bv)
    assert torch.equal(tk[3, :RUN_CAP], bk[3]), "empty a-run must leave b as is"
    out_n = R * (n + RUN_CAP)
    cat_k = torch.cat([ak, bk], dim=1)
    err = max(err, merge_edge_sweep(g, dev))
    record("merge_sorted_batch", "merge_sorted.cu",
           "src/repro/kernels/merge_sorted.py:177", err,
           lambda: ms.merge_sorted_batch_cuda(ak, av, bk, bv),
           lambda: ms.merge_sorted_plain(ak, av, bk, bv),
           lambda: torch.sort(cat_k, dim=1, stable=True),
           nbytes=12 * (R * n + R * RUN_CAP + out_n), nops=merge_ops(out_n))
    a1, v1 = ak[0].contiguous(), av[0].contiguous()
    b1, w1 = bk[2].contiguous(), bv[2].contiguous()
    err = assert_exact("merge_sorted", ms.merge_sorted_cuda,
                       ms.merge_sorted_plain, a1, v1, b1, w1)
    edge = [[torch.tensor(x, dtype=torch.int64 if i % 2 == 0 else torch.int32,
                          device=dev) for i, x in enumerate(case)]
            for case in (([5, 10, 20], [1, 2, 3], [10, 20, 30], [-1, -2, -3]),
                         ([7] * 5, [1] * 5, [7] * 3, [2] * 3),
                         ([KEY_MAX] * 3, [0] * 3, [1, 2, KEY_MAX], [4, 5, 6]))]
    for t in edge:               # tie-break, one-key runs, empty a-run
        err = max(err, assert_exact("merge_sorted edge", ms.merge_sorted_cuda,
                                    ms.merge_sorted_plain, *t))
    _, tv = ms.merge_sorted_cuda(*edge[0])
    assert tv[:6].tolist() == [1, 2, -1, 3, -2, -3], "a-first tie-break"
    cat1 = torch.cat([a1, b1])
    record("merge_sorted", "merge_sorted.cu",
           "src/repro/kernels/merge_sorted.py:122", err,
           lambda: ms.merge_sorted_cuda(a1, v1, b1, w1),
           lambda: ms.merge_sorted_plain(a1, v1, b1, w1),
           lambda: torch.sort(cat1, stable=True),
           nbytes=12 * 2 * (n + RUN_CAP), nops=merge_ops(n + RUN_CAP))
    del ak, av, bk, bv, cat_k
    merge_timings(g, dev)

    # ---- descent: 4096-row table, 4096 queries ---------------------------
    T = 4096
    tkeys, tvals, tcounts = table_rows(g, T, dev)
    bloom = bloom_table(tkeys)                             # row 5 empty
    rows_q = torch.randperm(T, generator=g, device=dev).to(torch.int32)
    cnt_q = tcounts[rows_q.long()]
    pick = torch.randint(0, RUN_CAP, (T,), generator=g, device=dev)
    q = tkeys[rows_q.long(), torch.minimum(pick, (cnt_q.long() - 1).clamp(min=0))]
    miss = torch.rand(T, generator=g, device=dev) < 0.4
    q = torch.where(miss, torch.randint(0, 2**32 - 1, (T,), generator=g,
                                        device=dev), q)
    q[:3] = KEY_MAX                                         # KEY_MAX queries
    err = assert_exact("sorted_search_rows", ss.sorted_search_rows_cuda,
                       ss.sorted_search_rows_plain, tkeys, tvals, rows_q,
                       cnt_q, q)
    found, _, _ = ss.sorted_search_rows_cuda(tkeys, tvals, rows_q, cnt_q, q)
    assert not found[:3].any(), "KEY_MAX queries never match"
    e, n_checks = search_edge_sweep(g, dev)
    err = max(err, e)
    log(f"  search edge sweep: {n_checks} kernel calls bit-exact vs plain "
        f"(counts 0, 1, W-1, W, W+1 for W in {SEARCH_W}, RUN_CAP - 1, RUN_CAP; "
        f"duplicate runs; queries below / above every key, = the last live "
        f"key, KEY_MAX; Q = 1, 37, 255, 257)")
    search_timings(g, dev, tkeys, tvals, tcounts, "(this build)")
    for w, lib in variants["search"].items():
        with kernel_library(lib):
            e, _ = search_edge_sweep(g, dev)
            err = max(err, e)
            search_timings(g, dev, tkeys, tvals, tcounts, f"SS_W={w}")
    q_by_row = torch.empty_like(q)
    q_by_row[rows_q.long()] = q
    q_by_row = q_by_row.clamp(max=KEY_MAX - 1)[:, None].contiguous()
    reads = search_len(cnt_q).sum().item()
    record("sorted_search_rows", "sorted_search.cu",
           "src/repro/kernels/sorted_search.py:83", err,
           lambda: ss.sorted_search_rows_cuda(tkeys, tvals, rows_q, cnt_q, q),
           lambda: ss.sorted_search_rows_plain(tkeys, tvals, rows_q, cnt_q, q),
           lambda: torch.searchsorted(tkeys, q_by_row),
           nbytes=8 * reads + T * (4 + 8 + 4 + 4 + 1 + 4 + 4),
           nops=reads * 6)

    err = assert_exact("bloom_probe_rows", bf.bloom_probe_rows_cuda,
                       bf.bloom_probe_rows_plain, bloom, rows_q, q,
                       nbits=NW * 32, h=H)
    e, n_checks = bloom_edge_sweep(g, dev)
    err = max(err, e)
    log(f"  bloom edge sweep: {n_checks} kernel calls bit-exact vs plain "
        f"(h = 1..6 x nbits {NW * 32}, {NW * 32 - 1}, {NW * 32 - 80}, 1009; "
        f"built, dense, all-zero and last rows; keys 0, KEY_MAX - 1, KEY_MAX; "
        f"Q = 1, 37, 255, 257, 4096)")
    page_bloom = page_bloom_table(g, dev)
    bloom_timings(g, dev, bloom, page_bloom, tkeys, tcounts, "(this build)")
    for t, lib in variants["bloom"].items():
        with kernel_library(lib):
            e, _ = bloom_edge_sweep(g, dev)
            err = max(err, e)
            bloom_timings(g, dev, bloom, page_bloom, tkeys, tcounts,
                          f"BP_THREADS={t}")
    del page_bloom
    record("bloom_probe_rows", "bloom_filter.cu",
           "src/repro/kernels/bloom_filter.py:64", err,
           lambda: bf.bloom_probe_rows_cuda(bloom, rows_q, q, nbits=NW * 32, h=H),
           lambda: bf.bloom_probe_rows_plain(bloom, rows_q, q, nbits=NW * 32, h=H),
           None, nbytes=T * (H * 8 + 8 + 4 + 1), nops=T * H * 12)

    nodes, ncnt, lo, hi, cap = range_sets(g, dev, tkeys, tcounts, "1024", 1)[0]
    err = assert_exact("range_scan_rows", rs.range_scan_rows_cuda,
                       rs.range_scan_rows_plain, tkeys, tvals, nodes, ncnt,
                       lo, hi, cap)
    _, _, n_match = rs.range_scan_rows_cuda(tkeys, tvals, nodes, ncnt, lo, hi, cap)
    assert (n_match[:8] == 0).all() and (n_match[16:24] > cap).any()
    e, n_checks = range_edge_sweep(g, dev)
    err = max(err, e)
    log(f"  range edge sweep: {n_checks} kernel calls bit-exact vs plain "
        f"(counts {RANGE_COUNTS}; lo > hi; lo = hi on a duplicated key; "
        f"[0, KEY_MAX - 1], [0, KEY_MAX]; spans of cap and cap + 1; cap 1, 3, "
        f"64, 128, 130, 256; B x M = 1, 37, 256; padded candidates; the "
        f"one-run form over KEY_MAX padding)")
    range_timings(g, dev, tkeys, tvals, tcounts, "(this build)")
    for kind, macro in (("range lanes", "RS_W"), ("range warps", "RS_WARPS")):
        for w, lib in variants[kind].items():
            with kernel_library(lib):
                e, _ = range_edge_sweep(g, dev)
                err = max(err, e)
                range_timings(g, dev, tkeys, tvals, tcounts, f"{macro}={w}")
    nbytes, nops = range_work(ncnt, n_match, cap)
    record("range_scan_rows", "range_scan.cu",
           "src/repro/kernels/range_scan.py:116", err,
           lambda: rs.range_scan_rows_cuda(tkeys, tvals, nodes, ncnt, lo, hi, cap),
           lambda: rs.range_scan_rows_plain(tkeys, tvals, nodes, ncnt, lo, hi, cap),
           None, nbytes=nbytes, nops=nops)

    # ---- the one-run entry points (Pallas contracts; off the main path) --
    run, rv, rc = tkeys[2], tvals[2], int(tcounts[2])
    assert_exact("sorted_search", ss.sorted_search_cuda, ss.sorted_search_plain,
                 run, rv, q)
    assert_exact("bloom_probe", bf.bloom_probe_cuda, bf.bloom_probe_plain,
                 bloom[7].contiguous(), q, nbits=NW * 32, h=H)
    assert_exact("range_scan", rs.range_scan_cuda, rs.range_scan_plain,
                 run, rv, lo.contiguous(), hi.contiguous(), max_results=cap)
    log(f"  one-run forms sorted_search, bloom_probe, range_scan: exact "
        f"(run of {rc} keys, {T} queries)")
    del tkeys, tvals, bloom
    torch.cuda.empty_cache()

    # ---- paged attention: the serving path's decode shapes ----------------
    f32, bf16 = torch.float32, torch.bfloat16
    e32, e16, n_cases, splits = pa_edge_sweep(g, dev)
    assert any(mp % -(-mp // ns) for mp, ns in splits), \
        "no edge case has MP off a whole number of splits"
    log(f"  paged_attention edge sweep ({n_cases} calls: the kernel tests' "
        f"shapes; MP = 1; splits capped at MP; MP off the split; seq_lens 0, "
        f"1, MP*S; G = 1, 8; fp32, bf16 and bf16-over-fp32; (MP, splits) "
        f"{splits}; a misaligned slice and an out-of-range id raise): max abs "
        f"err fp32 {e32:.3g}, bf16 {e16:.3g}")
    B, KVH, G, D, S, P, MP = 4, 8, 4, 128, 8, 1024, 36
    args32 = pa_inputs(g, dev, B, KVH, G, D, S, P, MP, f32, f32)
    err32 = pa_check("paged_attention fp32 serving shapes", 3e-5, args32)
    args = (args32[0].to(bf16),) + args32[1:]           # the served types
    err = pa_check("paged_attention bf16-over-fp32 serving shapes", 3e-2, args)
    log(f"  paged_attention at the serving shapes B={B} KVH={KVH} G={G} D={D} "
        f"S={S} P={P} MP={MP}: fp32 max abs err {err32:.3g}, bf16 q over "
        f"fp32 pages {err:.3g}")
    q, kp, vp, bt, lens = args
    flat = bt.reshape(-1)
    mask = (torch.arange(MP * S, device=dev) < lens[:, None])[:, None, None, :]

    def library():
        k = kp.index_select(1, flat).view(KVH, B, MP * S, D).transpose(0, 1)
        v = vp.index_select(1, flat).view(KVH, B, MP * S, D).transpose(0, 1)
        return torch.nn.functional.scaled_dot_product_attention(
            q.float(), k, v, attn_mask=mask).to(q.dtype)

    torch.testing.assert_close(library().float(),
                               pa.paged_attention_plain(*args).float(),
                               atol=3e-2, rtol=3e-2)
    kv_elems = B * KVH * MP * S * D
    record("paged_attention", "paged_attention.cu",
           "src/repro/kernels/paged_attention.py:95", err,
           lambda: pa.paged_attention_cuda(*args),
           lambda: pa.paged_attention_plain(*args), library,
           nbytes=kv_elems * (4 + 4) + 2 * q.numel() * 2 + bt.numel() * 4 + B * 4,
           nops=4 * B * KVH * G * MP * S * D + 5 * B * KVH * G * MP * S)
    sets = pa_serving_sets(g, dev)
    pa_timings(sets, f"(this build, {pa_splits(B, KVH, MP)} splits)")
    for c, lib in variants["attention"].items():
        with kernel_library(lib):
            e32, e16, _, _ = pa_edge_sweep(g, dev)
            pa_timings(sets, f"PA_SPLIT_CTAS={c} ({pa_splits(B, KVH, MP)} "
                             f"splits; edge sweep fp32 {e32:.3g}, bf16 "
                             f"{e16:.3g})")
    del sets
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------ phase 2
class Oracle:
    """Last-writer-wins key/value map of the stream, as sorted numpy arrays
    (independent of the port: plain numpy search and insertion)."""

    def __init__(self, keys, vals):
        order = np.argsort(keys)
        self.keys = np.asarray(keys, np.uint64)[order]
        self.vals = np.asarray(vals, np.int64)[order]

    def write(self, keys, vals):
        uk, first = np.unique(keys[::-1], return_index=True)   # last write wins
        uv = vals[::-1][first]
        pos = np.searchsorted(self.keys, uk)
        hit = pos < len(self.keys)
        hit[hit] = self.keys[pos[hit]] == uk[hit]
        self.vals[pos[hit]] = uv[hit]
        self.keys = np.insert(self.keys, pos[~hit], uk[~hit])
        self.vals = np.insert(self.vals, pos[~hit], uv[~hit])

    def delete(self, keys):
        pos = np.searchsorted(self.keys, keys)
        ok = pos < len(self.keys)
        ok[ok] = self.keys[pos[ok]] == keys[ok]
        keep = np.ones(len(self.keys), bool)
        keep[pos[ok]] = False
        self.keys, self.vals = self.keys[keep], self.vals[keep]

    def check(self, batch, res, OpKind):
        """Apply a kind-grouped batch; assert the engine's visible answers."""
        kinds = batch.kinds
        assert np.all(np.diff(kinds) >= 0), "batch must be grouped by kind"
        m = kinds == int(OpKind.INSERT)
        self.write(batch.keys[m], batch.vals[m])
        m = kinds == int(OpKind.DELETE)
        self.delete(batch.keys[m])
        m = np.flatnonzero(kinds == int(OpKind.QUERY))
        if len(m):
            q = batch.keys[m]
            pos = np.searchsorted(self.keys, q).clip(max=len(self.keys) - 1)
            hit = self.keys[pos] == q
            assert np.array_equal(res.found[m], hit), "QUERY presence"
            assert np.array_equal(res.values[m], np.where(hit, self.vals[pos], -1)), \
                "QUERY value"
        m = np.flatnonzero(kinds == int(OpKind.RANGE))
        if len(m):
            a = np.searchsorted(self.keys, batch.keys[m], "left")
            b = np.searchsorted(self.keys, batch.his[m], "right")
            assert not res.range_truncated[m].any()
            for i, lo_i, hi_i in zip(m, a, b):
                rk, rv = res.range_hits[i]
                assert np.array_equal(rk, self.keys[lo_i:hi_i]), f"RANGE keys {i}"
                assert np.array_equal(rv, self.vals[lo_i:hi_i]), f"RANGE vals {i}"
        return len(m)


class _DispatchTally:
    """Tracer stand-in: the index then keeps per-impl dispatch counts."""

    def complete(self, *args, **kwargs):
        pass

    def instant(self, *args, **kwargs):
        pass


def busy_share(prof, wall_s: float):
    """Device busy share of a profiled window and its top kernels, or None
    when the profiler saw no device time.  Sums the device events' times
    straight from the trace (what ``key_averages`` sums as self device
    time) without parsing it into a tree of function events, which takes
    tens of seconds over a window of many thousand launches."""
    by_name = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[e.name()] += e.duration_ns()
    busy_ns = sum(by_name.values())
    if not busy_ns:
        return None, []
    return busy_ns / 1e9 / wall_s, [(k[:60], v / busy_ns)
                                    for k, v in by_name.most_common(6)]


def run_mix(engine, workload, oracle, OpKind, label):
    """Serve ``workload`` batch by batch (apply, then maintain(1)), checking
    every answer; up to 8 batches from the middle of the stream run under
    torch.profiler for the device busy share."""
    from torch.profiler import ProfilerActivity, profile

    spec = workload.spec
    n_batches = -(-spec.n_ops // spec.batch_size)
    window = range(n_batches // 2, min(n_batches, n_batches // 2 + 8))
    t_serve = t_window = 0.0
    per_kind = {k: [0, 0.0] for k in OpKind}
    n_ops = n_ranges = 0
    prof = profile(activities=[ProfilerActivity.CUDA])
    for b, batch in enumerate(workload.batches()):
        if b == window.start:
            torch.cuda.synchronize()
            prof.start()
        t0 = time.perf_counter()
        res = engine.apply(batch)
        engine.maintain(1)
        if b in window:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        t_serve += dt
        if b in window:
            t_window += dt
        if b == window.stop - 1:
            prof.stop()
        for k in OpKind:
            lat = res.latencies(k)
            per_kind[k][0] += len(lat)
            per_kind[k][1] += float(lat.sum())
        n_ranges += oracle.check(batch, res, OpKind)
        n_ops += len(batch)
    rates = {k.name.lower(): c / s for k, (c, s) in per_kind.items() if c}
    log(f"  {label}: {n_ops} ops in {t_serve:.3f} s served "
        f"({n_ops / t_serve:.1f} ops/s incl. maintain(1) per batch); "
        "service rates " + ", ".join(f"{k} {v:.1f} ops/s"
                                     for k, v in rates.items())
        + f"; every answer == oracle")
    share, top = busy_share(prof, t_window)
    log(f"  {label} profiled batches {window.start}..{window.stop - 1}: "
        + ("device busy share not measured (profiler saw no device time)"
           if share is None else
           f"device busy {share:.4f} of {t_window:.4f} s wall (idle "
           f"{1 - share:.4f}); top kernels by device time: "
           + "; ".join(f"{k} {f:.3f}" for k, f in top)))
    return rates, n_ops / t_serve


def phase_main_path(dev, args) -> dict:
    from repro_torch.core.engine_api import OpBatch, OpKind, TorchNBTreeEngine
    from repro_torch.core.splitmix import splitmix64
    from repro_torch.kernels import ops
    from repro_torch.workloads import make_workload

    key_space = 1 << 26
    if args.preload < 1 << 24:
        log(f"  CUT: preload {args.preload} keys instead of 2^24")
    engine = TorchNBTreeEngine(f=4, sigma=4096, max_nodes=4096,
                               max_results=128, device=dev)
    idx = engine.idx
    assert (idx.run_cap, idx.nbits) == (RUN_CAP, NW * 32)
    idx.attach_tracer(_DispatchTally())
    flushes = [0, 0]                       # flush units, their dispatches
    plain_flush = idx._flush

    def counted_flush(node):
        d0 = idx.dispatch_count
        plain_flush(node)
        flushes[0] += 1
        flushes[1] += idx.dispatch_count - d0

    idx._flush = counted_flush
    ops.reset_launch_counts()

    # ---- YCSB load phase, in the generator's (hashed) insertion order -----
    wl = make_workload("insert-heavy", preload=args.preload,
                       key_space=key_space, n_ops=args.insert_ops,
                       batch_size=4096, seed=0)
    pre = wl.preload_batch()
    oracle = Oracle(pre.keys, pre.vals)
    # YCSB inserts its load in hashed order: key i is splitmix64(i) % space
    raw = splitmix64(np.arange(args.preload, dtype=np.uint64)) % np.uint64(key_space)
    _, first = np.unique(raw, return_index=True)
    order = np.argsort(first)
    t0 = time.perf_counter()
    for i in range(0, len(pre), 4096):
        sl = order[i:i + 4096]
        engine.apply(OpBatch.inserts(pre.keys[sl], pre.vals[sl]))
        engine.maintain(1)
    engine.drain()
    t_load = time.perf_counter() - t0
    log(f"  load: {len(pre)} distinct keys in {t_load:.3f} s "
        f"({len(pre) / t_load:.1f} inserts/s incl. drain); height "
        f"{idx.height}, {idx._next_id} node ids, node tables "
        f"{idx.table_bytes()} bytes on the card ({idx.max_nodes} rows)")

    ins_rates, ins_tput = run_mix(engine, wl, oracle, OpKind, "insert-heavy")
    wl_e = make_workload("ycsb-e", preload=args.preload, key_space=key_space,
                         n_ops=args.range_ops, batch_size=1024, seed=1,
                         range_selectivity=400 / key_space)
    # the shapes of the range launches, for phase 1's ycsb-e timing
    shapes, live = collections.Counter(), []
    real_range = ops.range_scan_rows

    def logged_range(table_keys, table_vals, nodes, counts, lo, hi, cap):
        shapes[(*nodes.shape, cap)] += 1
        live.append((counts > 0).sum(dim=1).float().mean())    # no sync
        return real_range(table_keys, table_vals, nodes, counts, lo, hi, cap)

    ops.range_scan_rows = logged_range
    try:
        rng_rates, rng_tput = run_mix(engine, wl_e, oracle, OpKind, "ycsb-e")
    finally:
        ops.range_scan_rows = real_range
    log("  ycsb-e range_scan_rows launches by (B, M, cap): "
        + ", ".join(f"{k}: {v}" for k, v in sorted(shapes.items()))
        + f"; candidates with keys per query, mean "
        f"{float(torch.stack(live).mean()):.3f}")
    engine.drain()
    torch.cuda.synchronize()
    launches = ops.launch_counts()

    keys, vals = engine.dump_live()
    assert np.array_equal(keys, oracle.keys) and np.array_equal(vals, oracle.vals), \
        "final live table != oracle"
    st = engine.stats()
    ds = idx.dispatch_stats
    log(f"  final live table == oracle ({len(keys)} pairs); height "
        f"{st.height}; node tables {idx.table_bytes()} bytes "
        f"({idx.max_nodes} rows x {idx.run_cap} slots)")
    log(f"  insert {ins_rates['insert']:.1f} ops/s, query "
        f"{ins_rates['query']:.1f} ops/s, range {rng_rates['range']:.1f} ops/s "
        f"(service rates); insert-heavy {ins_tput:.1f} ops/s, ycsb-e "
        f"{rng_tput:.1f} ops/s (served)")
    log(f"  maintain units {st.maintain_units}: p50 "
        f"{st.maintain_unit_p50_s * 1e3:.3f} ms, p99 "
        f"{st.maintain_unit_p99_s * 1e3:.3f} ms, p100 "
        f"{st.maintain_unit_p100_s * 1e3:.3f} ms; {flushes[0]} flush units, "
        f"{flushes[1] / max(flushes[0], 1):.3f} dispatches per flush unit; "
        f"impl calls "
        + json.dumps({k: v["count"] for k, v in sorted(ds.items())}))
    log(f"  Bloom: {st.bloom_probes} probes, {st.bloom_negative_skips} "
        f"negative skips, {st.bloom_false_positives} false positives")
    return launches


# ------------------------------------------------------------------ phase 4
def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def phase_serve(dev, args, cfg=None) -> dict:
    """qwen3-8b at full width through the serving engine; returns the kernel
    launches of this path.  ``cfg`` replaces the config only to rehearse
    the phase on the CPU at a reduced size."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import registry
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import INDEX_PARTS, Engine, Request

    if cfg is None:
        cfg = registry.get_config("qwen3-8b")
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.resolved_head_dim, cfg.d_ff, cfg.vocab, cfg.qk_norm,
                cfg.rope_base, cfg.dtype) == (36, 4096, 32, 8, 128, 12288,
                                              151936, True, 1e6, "bfloat16")
    n_req, prompt_len, n_new, max_batch = 8, 256, 32, 4
    n_pages, page_size = 1024, 8
    t0 = time.perf_counter()
    model = init_params(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    w_bytes = sum(p.nbytes for p in model.parameters())
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads x "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}; {w_bytes} weight bytes drawn on the card from seed "
        f"{args.seed} in {time.perf_counter() - t0:.3f} s")
    eng = Engine(cfg, model, max_batch=max_batch, n_pages=n_pages,
                 page_size=page_size)
    page_bytes = eng.cache.k_pages.nbytes + eng.cache.v_pages.nbytes
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(1, cfg.vocab, prompt_len).tolist()
               for _ in range(n_req)]
    steps = n_new - 1                      # decode steps per batch
    n_batches = -(-n_req // max_batch)
    L = cfg.n_layers

    def traffic(first_rid):
        return [Request(first_rid + i, prompt, max_new_tokens=n_new)
                for i, prompt in enumerate(prompts)]

    # Run A, measured: launch counters and host clocks only.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = eng.run(traffic(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()

    n_tok = sum(len(r.out) for r in reqs)
    assert all(r.done and len(r.out) == n_new for r in reqs)
    assert len(eng.cache.free) == n_pages - 1, "every page must be reclaimed"
    assert launches["paged_attention"] == L * steps * n_batches
    st, pf = eng.step_s, eng.prefill_s
    log(f"  served {n_req} requests ({n_batches} batches of {max_batch}, "
        f"{prompt_len}-token prompts, {n_new} new tokens each): {n_tok} "
        f"tokens in {wall:.3f} s = {n_tok / wall:.1f} tokens/s; prefill "
        f"{np.mean(pf) * 1e3:.3f} ms per batch ({', '.join(f'{x * 1e3:.3f}' for x in pf)}); "
        f"decode step p50 {pct(st, 50) * 1e3:.3f} ms, p99 "
        f"{pct(st, 99) * 1e3:.3f} ms, max {max(st) * 1e3:.3f} ms over "
        f"{len(st)} steps ({max_batch / np.median(st):.1f} tokens/s in decode)")
    idx = eng.decoder.index_s
    share = sum(np.asarray(idx[k]) for k in INDEX_PARTS) / np.asarray(st)
    log("  page-index host time per decode step: "
        + ", ".join(f"{k} {np.mean(idx[k]) * 1e3:.4f} ms" for k in INDEX_PARTS)
        + f"; share of the step: mean {share.mean():.4f}, p50 "
        f"{pct(share, 50):.4f}, max {share.max():.4f}")
    ix = eng.cache.index
    log(f"  page index: height {ix.height}, units done {ix.units_done}, "
        f"{ix.dispatch_count} impl calls; free pages after completion "
        f"{len(eng.cache.free)} of {n_pages} (page 0 is the null page); "
        f"fp32 pages {page_bytes} bytes; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    log("  launches on the serving path: " + json.dumps(launches))

    # Run B, the same traffic again: every layer's kernel output on the
    # first and last decode step of each batch is held against the plain
    # version (which launches no kernel).
    real_attn = ops.paged_attention
    seen = {"calls": 0, "checked": 0, "err": 0.0}

    def checked_attention(q, kp, vp, bt, lens):
        out = real_attn(q, kp, vp, bt, lens)
        if (seen["calls"] // L) % steps in (0, steps - 1):
            want = pa.paged_attention_plain(q, kp, vp, bt, lens)
            torch.testing.assert_close(out.float(), want.float(), atol=3e-2,
                                       rtol=3e-2)
            seen["err"] = max(seen["err"],
                              float((out.float() - want.float()).abs().max()))
            seen["checked"] += 1
        seen["calls"] += 1
        return out

    ops.paged_attention = checked_attention
    try:
        again = eng.run(traffic(n_req))
    finally:
        ops.paged_attention = real_attn
    assert seen["checked"] == 2 * L * n_batches
    assert len(eng.cache.free) == n_pages - 1
    log(f"  run B: paged_attention vs plain on the first and last decode "
        f"step of each batch: {seen['checked']} calls, max abs err "
        f"{seen['err']:.3g} (bf16 tol 3e-2); same tokens as run A: "
        f"{[r.out for r in again] == [r.out for r in reqs]}")

    # Run C, one more batch with decode steps 2..9 under torch.profiler:
    # the device's busy share of a decode step.
    real_decode, calls, wall_p = eng.decoder.decode, [0], [0.0]
    window = range(2, 10)
    prof = profile(activities=[ProfilerActivity.CUDA])

    def profiled_decode(*a, **kw):
        step = calls[0]
        calls[0] += 1
        if step not in window:
            return real_decode(*a, **kw)
        torch.cuda.synchronize()
        if step == window.start:
            prof.start()
        t = time.perf_counter()
        out = real_decode(*a, **kw)
        torch.cuda.synchronize()
        wall_p[0] += time.perf_counter() - t
        if step == window.stop - 1:
            prof.stop()
        return out

    eng.decoder.decode = profiled_decode
    eng.run([Request(n_req + i, rng.integers(1, cfg.vocab, prompt_len).tolist(),
                     max_new_tokens=window.stop + 1) for i in range(max_batch)])
    assert len(eng.cache.free) == n_pages - 1
    busy, top = busy_share(prof, wall_p[0])
    log(f"  profiled decode steps {window.start}..{window.stop - 1} of an "
        f"extra batch: "
        + ("device busy share not measured (profiler saw no device time)"
           if busy is None else
           f"device busy {busy:.4f} of {wall_p[0]:.4f} s wall (idle "
           f"{1 - busy:.4f}); top kernels by device time: "
           + "; ".join(f"{k} {f:.3f}" for k, f in top)))
    del eng, model
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------ phase 5
def phase_exact(dev, args) -> None:
    """Full width, depth cut to 4 layers, fp32: the engine's greedy tokens
    equal the contiguous-cache decode's."""
    from repro_torch.models import registry
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Engine, Request

    depth, n_req, prompt_len, n_new = 4, 2, 64, 8
    full = registry.get_config("qwen3-8b")
    cfg = dataclasses.replace(full, n_layers=depth,
                              segments=(("dense", depth),), dtype="float32")
    log(f"  CUT: depth {depth} of {full.n_layers} layers (full width, fp32); "
        f"{n_req} requests of {prompt_len}-token prompts, {n_new} new tokens")
    model = init_params(cfg, seed=args.seed, device=dev)
    prompts = np.random.default_rng(args.seed + 1).integers(
        1, cfg.vocab, (n_req, prompt_len))
    eng = Engine(cfg, model, max_batch=4, n_pages=1024, page_size=8)
    reqs = eng.run([Request(i, prompts[i].tolist(), max_new_tokens=n_new)
                    for i in range(n_req)])
    assert len(eng.cache.free) == 1023

    cache = model.init_cache(n_req, prompt_len + n_new)
    toks = torch.as_tensor(prompts, device=dev)
    for i in range(prompt_len):
        logits, cache = model.decode_step(toks[:, i], cache, i)
    ref = [logits.argmax(-1)]
    for s in range(n_new - 1):
        logits, cache = model.decode_step(ref[-1], cache, prompt_len + s)
        ref.append(logits.argmax(-1))
    ref = torch.stack(ref, 1).tolist()
    diff = float((eng.decoder.last_logits - logits).abs().max())
    log(f"  engine tokens == contiguous decode tokens: "
        f"{[r.out for r in reqs] == ref}; last step's max abs logit "
        f"difference {diff:.3g}")
    assert [r.out for r in reqs] == ref, ([r.out for r in reqs], ref)
    del eng, model, cache
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 6
def ingest_oracle(preload, acked):
    """Live table after ``preload`` and the acked commits in LSN order:
    numpy last-writer-wins (the last op on a key decides; a delete
    removes it), independent of the port."""
    from repro_torch.core.engine_api import OpKind

    if not acked:
        return preload.keys, preload.vals
    kinds = np.concatenate([a[1] for a in acked])
    keys = np.concatenate([a[2] for a in acked])
    vals = np.concatenate([a[3] for a in acked])
    uk, first = np.unique(keys[::-1], return_index=True)
    last_kind, last_val = kinds[::-1][first], vals[::-1][first]
    keep = ~np.isin(preload.keys, uk)
    ins = last_kind == int(OpKind.INSERT)
    out_k = np.concatenate([preload.keys[keep], uk[ins]])
    out_v = np.concatenate([preload.vals[keep], last_val[ins]])
    order = np.argsort(out_k, kind="stable")
    return out_k[order], out_v[order]


def phase_ingest(dev) -> dict:
    """Phase 6 (see the module docstring); returns the launch counts of
    the phase's drive, recoveries included."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine_api import make_engine
    from repro_torch.ingest import (DurabilityConfig, FrontendConfig,
                                    IngestFrontend, PoissonArrivals,
                                    make_trace)
    from repro_torch.kernels import ops
    from repro_torch.wal import (CrashPoint, FaultInjector, SimulatedCrash,
                                 recover)
    from repro_torch.workloads import make_workload

    preload, key_space, crash_at, rate = 1 << 22, 1 << 24, 2048, 20_000.0
    marks = {}

    def engine():
        eng = make_engine("torch-nbtree", f=4, sigma=4096, max_nodes=2048,
                          max_results=128, device=dev)
        real_drain = eng.drain

        def timed_drain():          # recover() drains once, after the snapshot
            real_drain()
            marks.setdefault(id(eng), time.perf_counter())

        eng.drain = timed_drain
        marks["made"] = time.perf_counter()
        return eng

    def recovered(label, acked):
        marks.clear()
        rr = recover(root, engine)
        torch.cuda.synchronize()
        snap_s = marks.get(id(rr.engine), marks["made"]) - marks["made"]
        replay_s = rr.recover_wall_s - snap_s
        n = rr.snapshot_pairs               # the engine's pad rule (apply)
        padded = 1 << max(0, n - 1).bit_length()
        padded = padded if padded - n < rr.engine.idx.sigma else n
        log(f"  {label}: recover_wall_s {rr.recover_wall_s:.3f} (snapshot "
            f"load + drain {snap_s:.3f} s: {rr.snapshot_pairs} pairs @ lsn "
            f"{rr.snapshot_lsn}, applied as one batch of {padded} inserts; "
            f"WAL replay {replay_s:.3f} s: "
            f"{rr.replayed_commits} commits, {rr.replayed_ops} ops, "
            f"{rr.replayed_ops / max(replay_s, 1e-9):.1f} ops/s); "
            f"{(rr.snapshot_pairs + rr.replayed_ops) / rr.recover_wall_s:.1f}"
            " ops/s recovered")
        keys, vals = rr.engine.dump_live()
        want_k, want_v = ingest_oracle(trace1.preload, acked)
        assert np.array_equal(keys, want_k) and np.array_equal(vals, want_v), \
            f"{label}: recovered table != oracle"
        st = rr.engine.stats()
        assert rr.last_lsn == st.applied_lsn == acked[-1][0], \
            (rr.last_lsn, st.applied_lsn, acked[-1][0])
        log(f"  {label}: recovered table == oracle ({len(keys)} pairs); "
            f"last_lsn == applied_lsn == last acked lsn {rr.last_lsn}")
        return rr

    def served(label, fe, t_wall, n_ops):
        rep_st = fe.engine.stats()
        fs = fe.wal.fsync_s
        n = len(fe.acked)
        log(f"  {label}: {n} durable commits ({n_ops} ops arrived) in "
            f"{t_wall:.3f} s of serving ({n / t_wall:.1f} commits/s wall); "
            f"fsync p50 / p99 {fs.quantile(0.5) * 1e3:.3f} / "
            f"{fs.quantile(0.99) * 1e3:.3f} ms, p100 "
            f"{fs.max * 1e3:.3f} ms ({fs.count} fsyncs); snapshots "
            + ", ".join(f"{s:.3f}" for s in fe.checkpoint_wall_s)
            + f" s; maintain units {rep_st.maintain_units}: p50 / p99 / p100 "
            f"{rep_st.maintain_unit_p50_s * 1e3:.3f} / "
            f"{rep_st.maintain_unit_p99_s * 1e3:.3f} / "
            f"{rep_st.maintain_unit_p100_s * 1e3:.3f} ms")

    cfg = FrontendConfig()                  # commit_ops 64, max_queue 4096
    wl1 = make_workload("insert-heavy", preload=preload,
                        key_space=key_space, n_ops=1 << 18, batch_size=4096,
                        seed=2)
    trace1 = make_trace(wl1, PoissonArrivals(rate))
    wl2 = make_workload("insert-heavy", preload=0, key_space=key_space,
                        n_ops=1 << 16, batch_size=4096, seed=3)
    trace2 = make_trace(wl2, PoissonArrivals(rate))
    root = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    durability = DurabilityConfig(root, checkpoint_every_commits=1024)
    try:
        ops.reset_launch_counts()
        # ---- trace 1, killed after the 2048th fsync (acked, not applied) --
        inj = FaultInjector(CrashPoint.AFTER_WAL_FSYNC, at_occurrence=crash_at)
        fe1 = IngestFrontend(engine(), cfg, durability=durability,
                             injector=inj)
        t0 = time.perf_counter()
        try:
            fe1.run(trace1)
        except SimulatedCrash:
            pass
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        assert inj.fired and len(fe1.acked) == crash_at, len(fe1.acked)
        log(f"  preload: {len(trace1.preload)} distinct keys in "
            f"{fe1.preload_wall_s:.3f} s "
            f"({len(trace1.preload) / fe1.preload_wall_s:.1f} inserts/s, one "
            f"batch + drain); its snapshot {fe1.checkpoint_wall_s[0]:.3f} s")
        served("trace 1 (killed)", fe1,
               t_run - fe1.preload_wall_s - fe1.checkpoint_wall_s[0],
               len(trace1))
        acked1 = fe1.acked
        del fe1, inj
        torch.cuda.empty_cache()

        rr1 = recovered("recovery 1", acked1)
        # ---- restart: a fresh frontend on the recovered engine ------------
        fe2 = IngestFrontend(rr1.engine, cfg, durability=durability)
        assert fe2.last_acked_lsn == rr1.last_lsn
        # the profiled window: commits 256..767 (one maintain call a commit)
        prof = profile(activities=[ProfilerActivity.CUDA])
        window, calls = [0.0, 0.0], [0]
        real_maintain = fe2.engine.maintain

        def windowed_maintain(budget=1):
            if calls[0] in (256, 768):
                torch.cuda.synchronize()
                window[calls[0] == 768] = time.perf_counter()
                (prof.start if calls[0] == 256 else prof.stop)()
            calls[0] += 1
            return real_maintain(budget)

        fe2.engine.maintain = windowed_maintain
        d0 = fe2.engine.idx.dispatch_count
        t0 = time.perf_counter()
        rep2 = fe2.run(trace2)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        del fe2.engine.maintain
        per_commit = ((fe2.engine.idx.dispatch_count - d0)
                      / rep2["server"]["n_commits"])
        assert calls[0] > 768, calls
        lsns = [a[0] for a in fe2.acked]
        assert lsns[0] == rr1.last_lsn + 1 and lsns == list(
            range(lsns[0], lsns[0] + len(lsns))), "LSN chain broken"
        served("trace 2 (after the restart)", fe2, t_run, len(trace2))
        e2e = rep2["per_kind_e2e"]["insert"]
        log(f"  trace 2: LSNs {lsns[0]}..{lsns[-1]} continue the chain "
            f"(last before the restart {rr1.last_lsn}); impl calls per "
            f"commit {per_commit:.3f} (apply + maintain(1)); shed "
            f"{rep2['n_shed']}; virtual service model (not "
            f"measured): insert e2e p50 {e2e['p50_s'] * 1e3:.3f} ms, p99.9 "
            f"{e2e['p999_s'] * 1e3:.3f} ms")
        t_window = window[1] - window[0]
        share, top = busy_share(prof, t_window)
        log("  trace 2 profiled commits 256..767: "
            + ("device busy share not measured (profiler saw no device time)"
               if share is None else
               f"device busy {share:.4f} of {t_window:.3f} s wall (idle "
               f"{1 - share:.4f}); top kernels by device time: "
               + "; ".join(f"{k} {f:.3f}" for k, f in top)))
        acked = acked1 + fe2.acked
        keys, vals = fe2.engine.dump_live()
        want_k, want_v = ingest_oracle(trace1.preload, acked)
        assert np.array_equal(keys, want_k) and np.array_equal(vals, want_v), \
            "served engine != oracle"
        del fe2, rr1
        torch.cuda.empty_cache()
        rr2 = recovered("recovery 2", acked)
        del rr2
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------ phase 7
#: phase 7a: four tenants of ``mixed_oltp`` at 2^16 ops (the scanner 2^15),
#: each preloaded with 2^20 keys over a local space of 2^22, killed after
#: the 2048th fsync; a scanner snapshot is pinned past commit 1024
TENANCY = dict(n_ops=1 << 16, base_rate=8000.0, preload=1 << 20,
               key_space=1 << 22, crash_at=2048, pin_after=1024,
               window=(256, 768))
#: phase 7b: a hotspot-shift stream over two range shards, served until
#: ``after`` batches past the first split (the window sweeps the key space
#: over n_ops, so shard 0 runs hot for the first half)
SPLIT = dict(preload=1 << 20, key_space=1 << 22, n_ops=3 << 18,
             batch=4096, after=16, min_extract=1 << 18)


def sharded_engine(dev, shards: int, **kw):
    from repro_torch.core.engine_api import make_engine

    return make_engine("sharded:torch-nbtree", shards=shards, f=4,
                       sigma=4096, max_results=128, max_nodes=512,
                       device=dev, **kw)


def impl_calls(eng) -> int:
    """Impl calls (``dispatch_count``) of every shard of ``eng``, the
    shards retired by splits included."""
    return sum(e.idx.dispatch_count for e in eng.shard_engines) \
        + eng._retired[9]


def tenant_oracle(ns, tid, preload, acked):
    """Tenant ``tid``'s live table in its local keys: its preload, then its
    rows of the acked commits in LSN order (numpy, ``ingest_oracle``)."""
    lo, hi = ns.tenant_interval(tid)
    mine = []
    for lsn, kinds, keys, vals in acked:
        m = (keys >= lo) & (keys <= hi)
        if m.any():
            mine.append((lsn, kinds[m], keys[m], vals[m]))
    keys, vals = ingest_oracle(ns.encode_batch(tid, preload), mine)
    return ns.decode(keys)[1], vals


def phase_tenancy_ingest(dev) -> None:
    """Phase 7a (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.ingest import DurabilityConfig, FrontendConfig
    from repro_torch.tenancy import (MultiTenantFrontend, NamespaceMap,
                                     recover_namespace)
    from repro_torch.wal import CrashPoint, FaultInjector, SimulatedCrash
    from repro_torch.workloads.tenants import build_streams, mixed_oltp

    cfg = TENANCY
    ns = NamespaceMap()
    streams = [dataclasses.replace(s, preload=cfg["preload"],
                                   key_space=cfg["key_space"])
               for s in mixed_oltp(n_ops=cfg["n_ops"],
                                   base_rate=cfg["base_rate"])]
    tenants, traces = build_streams(streams, seed=0)
    names = {t.tenant_id: t.label for t in tenants}
    scanner = next(t.tenant_id for t in tenants if t.label == "scanner")
    n_pre = sum(len(tr.preload) for tr in traces.values())
    t_mark = [time.perf_counter()]

    def mark(label):            # wall seconds of each step of 7a
        now = time.perf_counter()
        log(f"  7a step: {label} {now - t_mark[0]:.3f} s")
        t_mark[0] = now

    root = tempfile.mkdtemp(prefix="chip_smoke_tenancy_")
    try:
        eng = sharded_engine(dev, 4, partition="range")
        inj = FaultInjector(CrashPoint.AFTER_WAL_FSYNC,
                            at_occurrence=cfg["crash_at"])
        fe = MultiTenantFrontend(
            eng, tenants, FrontendConfig(),
            durability=DurabilityConfig(root, checkpoint_every_commits=1024),
            injector=inj, namespace=ns, fair=True)
        # after the preload: impl calls of apply and of maintain, commits,
        # and the profiled window of commits (one maintain a commit)
        w0, w1 = cfg["window"]
        calls = {"apply": 0, "maintain": 0, "commits": 0}
        prof = profile(activities=[ProfilerActivity.CUDA])
        window = [0.0, 0.0]
        real_apply, real_maintain = eng.apply, eng.maintain

        def counted_apply(batch):
            if fe.preload_wall_s and not calls["commits"]:
                eng.attach_tracer(_DispatchTally())    # per-impl wall times
            d0 = impl_calls(eng)
            res = real_apply(batch)
            if fe.preload_wall_s:
                calls["apply"] += impl_calls(eng) - d0
                calls["commits"] += 1
            return res

        def counted_maintain(budget=1):
            if not fe.preload_wall_s:
                return real_maintain(budget)
            c = calls["commits"]
            if c in (w0, w1) and not window[c == w1]:
                torch.cuda.synchronize()
                window[c == w1] = time.perf_counter()
                (prof.start if c == w0 else prof.stop)()
            d0 = impl_calls(eng)
            debt = real_maintain(budget)
            calls["maintain"] += impl_calls(eng) - d0
            return debt

        eng.apply, eng.maintain = counted_apply, counted_maintain
        pinned, seen = [], [0]

        def on_commit(front, _t):
            seen[0] += 1
            if seen[0] == cfg["pin_after"] + 1:
                pinned.append(front.pin_snapshot(tenant_id=scanner))

        t0 = time.perf_counter()
        try:
            fe.run(traces, on_commit=on_commit)
        except SimulatedCrash:
            pass
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        mark("streams built, preload, serving until the kill")
        del eng.apply, eng.maintain
        assert inj.fired and len(fe.acked) == cfg["crash_at"], len(fe.acked)
        assert eng.partitioner.n_shards == 4, eng.partitioner.n_shards
        t_serve = t_run - fe.preload_wall_s - fe.checkpoint_wall_s[0]
        log(f"  7a preload: {n_pre} keys of 4 tenants in "
            f"{fe.preload_wall_s:.3f} s ({n_pre / fe.preload_wall_s:.1f} "
            f"inserts/s, one batch over 4 range shards + drain; pivots "
            f"{eng.partitioner.pivots.tolist()}); its snapshot "
            f"{fe.checkpoint_wall_s[0]:.3f} s")
        fs = fe.wal.fsync_s
        log(f"  7a applied {calls['commits']} commits ({len(fe.acked)} "
            f"fsynced) in {t_serve:.3f} s ({calls['commits'] / t_serve:.1f} "
            f"commits/s wall), killed after fsync {cfg['crash_at']} (acked, "
            f"not applied); fsync p50 / p99 "
            f"{fs.quantile(0.5) * 1e3:.3f} / {fs.quantile(0.99) * 1e3:.3f} ms"
            f", p100 {fs.max * 1e3:.3f} ms; snapshots "
            + ", ".join(f"{x:.3f}" for x in fe.checkpoint_wall_s) + " s")
        log("  7a node tables at the kill: " + ", ".join(
            f"{e.idx.table_bytes()} B ({e.idx.max_nodes} rows, "
            f"{e.idx._next_id} node ids)" for e in eng.shard_engines)
            + f"; {sum(e.idx.table_bytes() for e in eng.shard_engines)} B "
            "in all")
        log(f"  7a impl calls per commit: "
            f"{(calls['apply'] + calls['maintain']) / calls['commits']:.3f} "
            f"(apply {calls['apply'] / calls['commits']:.3f}, maintain(1) "
            f"{calls['maintain'] / calls['commits']:.3f}); "
            f"{eng.n_splits} splits")
        per_impl = collections.defaultdict(lambda: [0, 0.0])
        for e in eng.shard_engines:
            for k, v in e.idx.dispatch_stats.items():
                per_impl[k][0] += v["count"]
                per_impl[k][1] += v["wall_s"]
        log("  7a host time of impl calls while serving: " + "; ".join(
            f"{k} {n / calls['commits']:.3f} a commit, {w / n * 1e3:.3f} ms "
            f"a call, {w / t_serve:.3f} of serving wall"
            for k, (n, w) in sorted(per_impl.items(), key=lambda x: -x[1][1])))
        for tid in sorted(fe.trackers):
            rep = fe.trackers[tid].report(offered={}, t_end=1.0)
            tails = ", ".join(f"{k} {v['p999_s'] * 1e3:.3f} ms"
                              for k, v in rep["per_kind_e2e"].items())
            log(f"  7a tenant {tid} ({names[tid]}): {rep['n_done']} ops "
                f"served, shed {rep['n_shed']}; virtual service model (not "
                f"measured): e2e p99.9 {tails}")
        assert window[1] > window[0] > 0, "the profiled window never closed"
        mark("reports")
        share, top = busy_share(prof, window[1] - window[0])
        mark("profile read")
        log(f"  7a profiled commits {w0}..{w1 - 1}: "
            + ("device busy share not measured (profiler saw no device "
               "time)" if share is None else
               f"device busy {share:.4f} of {window[1] - window[0]:.3f} s "
               f"wall (idle {1 - share:.4f}); top kernels by device time: "
               + "; ".join(f"{k} {f:.3f}" for k, f in top)))

        # ---- the scanner's snapshot, pinned past commit pin_after --------
        assert len(pinned) == 1, "no snapshot was pinned"
        snap = pinned[0]
        upto = [a for a in fe.acked if a[0] <= snap.watermark_lsn]
        want_k, want_v = tenant_oracle(ns, scanner, traces[scanner].preload,
                                       upto)
        got_k = ns.decode(snap.keys)[1]
        assert np.array_equal(got_k, want_k) and \
            np.array_equal(snap.vals, want_v), "scanner snapshot != oracle"
        log(f"  7a scanner snapshot at lsn {snap.watermark_lsn}: "
            f"{len(snap)} pairs == its oracle at that lsn")
        mark("snapshot check")
        acked = fe.acked
        del fe, eng, inj, pinned, snap
        torch.cuda.empty_cache()

        # ---- each tenant's namespace, recovered into a fresh ensemble ----
        for tid in sorted(traces):
            rr = recover_namespace(root, lambda: sharded_engine(dev, 4),
                                   tid, namespace=ns)
            torch.cuda.synchronize()
            keys, vals = rr.engine.dump_live()
            want_k, want_v = tenant_oracle(ns, tid, traces[tid].preload,
                                           acked)
            tids, local = ns.decode(keys)
            assert (tids == tid).all() and np.array_equal(local, want_k) \
                and np.array_equal(vals, want_v), \
                f"tenant {tid}: recovered namespace != oracle"
            assert rr.last_lsn == acked[-1][0], (rr.last_lsn, acked[-1][0])
            log(f"  7a recover_namespace({tid}, {names[tid]}): "
                f"{rr.recover_wall_s:.3f} s ({rr.snapshot_pairs} snapshot "
                f"pairs @ lsn {rr.snapshot_lsn}, {rr.replayed_commits} "
                f"commits / {rr.replayed_ops} ops replayed) == oracle "
                f"({len(keys)} pairs)")
            del rr
            torch.cuda.empty_cache()
            mark(f"recovery of tenant {tid} and its check")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def phase_hot_split(dev) -> None:
    """Phase 7b (see the module docstring)."""
    from repro_torch.core.engine_api import OpKind
    from repro_torch.kernels import ops
    from repro_torch.workloads import make_workload

    cfg = SPLIT
    wl = make_workload("hotspot-shift", preload=cfg["preload"],
                       key_space=cfg["key_space"], n_ops=cfg["n_ops"],
                       batch_size=cfg["batch"], seed=5)
    eng = sharded_engine(dev, 2, skew_factor=1.5, min_split_pairs=96)
    splits = []
    real_split = eng._split_shard

    def logged_split(sid):
        before = ops.launch_counts()["range_scan_rows"]
        t0 = time.perf_counter()
        ok = real_split(sid)
        torch.cuda.synchronize()
        if ok:      # the two halves' counts: the pairs the split read out
            splits.append((sid, eng._approx_live[sid]
                           + eng._approx_live[sid + 1],
                           time.perf_counter() - t0,
                           ops.launch_counts()["range_scan_rows"] - before))
        return ok

    eng._split_shard = logged_split
    pre = wl.preload_batch()
    oracle = Oracle(pre.keys, pre.vals)
    t0 = time.perf_counter()
    eng.apply(pre)
    eng.drain()
    t_load = time.perf_counter() - t0
    n_ops = n_ranges = 0
    left = None
    t0 = time.perf_counter()
    for batch in wl.batches():
        res = eng.apply(batch)
        eng.maintain(4)
        n_ranges += oracle.check(batch, res, OpKind)
        n_ops += len(batch)
        if eng.n_splits and left is None:
            left = cfg["after"]
        if left is not None:
            left -= 1
            if left < 0:
                break
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    eng.drain()
    keys, vals = eng.dump_live()
    assert np.array_equal(keys, oracle.keys) and \
        np.array_equal(vals, oracle.vals), "7b: final live table != oracle"
    assert eng.n_splits >= 1 and splits, "7b: no hot-shard split"
    sid, pairs, dt, ranges = splits[0]
    assert pairs >= cfg["min_extract"], f"7b: split read only {pairs} pairs"
    assert all(s[3] == 0 for s in splits), "7b: a split ran a range scan"
    log(f"  7b preload {len(pre)} keys over 2 range shards in {t_load:.3f} s; "
        f"{n_ops} hotspot-shift ops of {cfg['n_ops']} ({n_ranges} ranges; "
        f"stopped {cfg['after']} batches after the first split) in "
        f"{t_serve:.3f} s "
        f"({n_ops / t_serve:.1f} ops/s incl. maintain(4) a batch), every "
        f"answer == oracle, final live table == oracle ({len(keys)} pairs)")
    log(f"  7b {eng.n_splits} splits: "
        + "; ".join(f"shard {s} read out {p} pairs uncapped in {d:.3f} s "
                    f"({r} range launches)" for s, p, d, r in splits)
        + f"; pivots {eng.partitioner.pivots.tolist()}; shard max_results "
        f"{[e._max_results for e in eng.shard_engines]}; node tables "
        f"{[e.idx.table_bytes() for e in eng.shard_engines]} B")
    del eng
    torch.cuda.empty_cache()


def phase_tenancy(dev) -> dict:
    """Phase 7: 7a then 7b; returns the launch counts of both."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    phase_tenancy_ingest(dev)
    t1 = time.perf_counter()
    phase_hot_split(dev)
    torch.cuda.synchronize()
    log(f"  7a took {t1 - t0:.1f} s, 7b {time.perf_counter() - t1:.1f} s")
    return ops.launch_counts()


def build_kernels(tmp: str) -> dict:
    """Build the kernel library and, beside it, the ptxas reports and the
    swept variants (all ``nvcc`` processes started together); print the
    reports.  Returns {kind: {swept value: lib}} for the kinds of
    ``SWEEPS``."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    reports = {src: ptxas_report(src, tmp) for src in PTXAS_SOURCES}
    builds = variant_builds(tmp)
    variants = {kind: {} for _, _, kind in SWEEPS.values()}
    try:
        lib = _build.build()
        _build.library()
        for src, proc in reports.items():
            out, _ = proc.communicate(timeout=600)
            if proc.returncode:
                raise RuntimeError(f"nvcc -Xptxas -v {src} failed:\n{out}")
            reports[src] = out
        for src, macro, value, so, proc in builds:
            out, _ = proc.communicate(timeout=600)
            if proc.returncode:
                raise RuntimeError(f"nvcc -D{macro}={value} {src} failed:\n{out}")
            variants[SWEEPS[macro][2]][value] = load_variant(so)
    finally:                   # no compiler outlives a failed build
        for proc in [*reports.values(), *(b[-1] for b in builds)]:
            if isinstance(proc, subprocess.Popen) and proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib} (and "
        f"{len(builds)} swept variants)")
    for src, out in reports.items():
        log(f"{src}, nvcc -Xptxas -v: " + "; ".join(
            " ".join(line.split()) for line in out.splitlines()
            if "registers" in line or "spill" in line
            or "Compiling entry" in line))
    return variants


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preload", type=int, default=1 << 24)
    ap.add_argument("--insert-ops", type=int, default=1 << 20)
    ap.add_argument("--range-ops", type=int, default=1 << 14)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the served model's weights and prompts")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    # fp32 matmuls and convolutions in full fp32 (phase 5 compares tokens)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    tmp = tempfile.TemporaryDirectory()
    variants = build_kernels(tmp.name)

    log("phase 1: kernels vs their plain versions on the card")
    try:
        rows = phase_kernels(dev, variants)
    finally:
        tmp.cleanup()
    log("phase 2+3: NB-tree path through TorchNBTreeEngine, checked by an oracle")
    paths = {"nbtree": phase_main_path(dev, args)}
    log("launches on the NB-tree path: " + json.dumps(paths["nbtree"]))
    log("phase 4: qwen3-8b served at full width through the paged-KV engine")
    paths["serve"] = phase_serve(dev, args)
    log("phase 5: engine vs contiguous decode, exact tokens")
    phase_exact(dev, args)
    log("phase 6: durable open-loop ingest over torch-nbtree, crash and "
        "restart")
    t6 = time.perf_counter()
    paths["ingest"] = phase_ingest(dev)
    log(f"launches on the ingest path: {json.dumps(paths['ingest'])}; "
        f"phase 6 took {time.perf_counter() - t6:.1f} s")
    torch.cuda.empty_cache()
    log("phase 7: sharded multi-tenant durable ingest over "
        "sharded:torch-nbtree, crash and per-tenant recovery; a hot-shard "
        "split")
    t7 = time.perf_counter()
    paths["tenancy"] = phase_tenancy(dev)
    log(f"launches on the tenancy path: {json.dumps(paths['tenancy'])}; "
        f"phase 7 took {time.perf_counter() - t7:.1f} s")
    for name_k, row in rows.items():
        path = KERNEL_PATH.get(name_k, "nbtree")
        row["launches"] = paths[path][name_k]
        row["launches_by_path"] = {p: c[name_k] for p, c in paths.items()
                                   if c.get(name_k)}
        if not row["launches"]:
            raise AssertionError(f"{name_k} never launched on the {path} path")
    for path, names in (("ingest", INGEST_KERNELS),
                        ("tenancy", TENANCY_KERNELS)):
        for name_k in names:
            if not paths[path][name_k]:
                raise AssertionError(
                    f"{name_k} never launched on the {path} path")
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s, every phase "
        "passed")
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
