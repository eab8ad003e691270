#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (the NB-tree device tier, durable and
multi-tenant ingest over it, the paged-KV serving bridge, every arch of
the model code, training and its sharded step, split over "model") on
one NVIDIA card.

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
   printed.  The Bloom build and update (no TPU kernel: the write path's
   filters) are held at a flush's shape (5 runs of 21,504 keys) and an
   insert's (4,096 keys onto one filter) and on an edge sweep, and the
   device-memory body they take past shared memory is timed at the same
   shapes (``-DBB_MAX_SMEM=0``).  Phase 3 logs the shapes of the range
   launches it makes.
2. Drives the NB-tree path through the engine a user calls:
   ``TorchNBTreeEngine(f=4, sigma=4096)`` on ``cuda``; a YCSB load phase of
   ``preload = 2^24`` keys over ``key_space = 2^26``, the paper's
   ``insert-heavy`` mix (2^20 ops, batches of 4096), YCSB workload E's short
   scans (``ycsb-e``, zipfian, ~400-key spans, 2^14 ops, batches of 1024),
   then a ``drain``.
3. Holds every QUERY and RANGE answer and the final live table against a
   numpy last-writer-wins oracle of the same stream.
3b. (Runs after phase 3.)  The eager write path, the JAX package's
   pre-fusion baseline, beside the fused one: two ``TorchNBTreeEngine``s
   of phase 2's shape (``fused=True`` and ``fused=False``, ``EAGER``) fed
   one stream, 2^20 keys (cut from 2^22 for time; it prints the cut)
   drawn from 2^26 in YCSB's hashed order in batches of 4,096, a delete
   batch of 256 inserted keys after every 8th,
   ``maintain(1)`` after each batch, then a ``drain``.  The seven tables,
   the host tree and ``_next_id`` must be equal bit for bit, both
   ``dump_live`` must equal a numpy oracle, and 4,096 point queries and
   256 ranges must give equal answers, equal to the oracle's.  Prints, per
   path, the reference ingest benchmark's fields
   (``benchmarks/bench_ingest_device.py``): insert ops/s, dispatches per
   insert batch and per maintain unit, maintain-unit p50/p99/p100
   (each unit synchronised), and its kernel launches.
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
8. (Runs after phase 5.)  The attention-backbone archs, each model freed
   before the next is drawn on the card from ``--seed``.  8a: gemma-2b
   and 8b: starcoder2-3b at full width and depth (bf16) through the paged
   engine with phase 4's traffic and checks; ``paged_attention`` meets two new shapes there (KVH 1, G 8,
   D 256 and KVH 2, G 12, D 128).  8c: deepseek-moe-16b and 8d:
   minicpm3-4b at full width and depth, 8e: mixtral-8x22b at full width
   with its depth cut to 4 of 56, each through ``serve/steps.py``'s
   prefill and decode steps over the contiguous cache (the reference
   serves MoE and MLA stacks only there): 2 batches of 4 requests of
   256-token prompts, 32 new tokens each, then 8 profiled decode steps;
   prints prefill ms, step p50/p99, tokens/s, peak memory, the share of
   (token, k) slots the MoE capacity drops at decode and the device's
   idle share.  8f, fp32: gemma-2b (depth 4) engine tokens == contiguous
   decode tokens; deepseek-moe-16b (1 dense + 1 moe layer) and
   minicpm3-4b (4 layers) at full width, prefill-built cache tokens ==
   stepwise cache tokens for 8 steps; the mixtral config reduced with
   window 16, a 160-token prompt's ring decoded 40 steps past its
   rollover == a full-length cache (the MoE cases at capacity factor 8.0).
9. (Runs after phase 8.)  The remaining archs at full width and depth
   (bf16), each freed before the next is drawn.  9a: qwen2-vl-2b (dense,
   M-RoPE; text positions make it RoPE) through the paged engine with
   phase 4's traffic and checks; ``paged_attention`` at KVH 2, G 6, D 128.
   9b: xlstm-1.3b (42 mLSTM, 6 sLSTM) and 9c: hymba-1.5b (hybrid blocks,
   1,536-token prompts, so the prefill attends blockwise and the
   ``hybrid`` rings of 1,152 slots roll over) through ``serve/steps.py``
   as 8c-8e, printing also the decode state's bytes a sequence.  9d:
   hubert-xlarge through ``make_encode_step`` on 4 clips of 1,500 frame
   embeddings (bidirectional blockwise attention); prints encode ms,
   frames/s, peak memory and the idle share; logits must be finite.  9e,
   fp32: qwen2-vl-2b (depth 4) engine tokens == contiguous decode tokens,
   M-RoPE with three equal rows == RoPE bit for bit, a 16x16 patch grid
   with distinct (t, h, w) rows finite; xlstm-1.3b (depth 8) and
   hymba-1.5b (depth 3) prefill-built state tokens == stepwise tokens for
   8 steps, logits within 2e-3; that hymba with window 16, a ring past
   its rollover == a full-length cache; ``blockwise_sdpa`` == the naive
   attention within 3e-5 at 9c's and 9d's prefill shapes, with int8 K/V
   too; the int8 KV cache (qwen2-vl-2b, depth 4): stored values within
   scale / 2 of the K/V they store, and the reference's accuracy bounds
   against the model-dtype cache over 16 steps.
10. (Runs after phase 9.)  Training on the card; no kernel of phase 1 is
   on this path (training reaches no Pallas kernel's counterpart), and
   10a's launch counts must all be 0.  10a: gemma-2b at full width and
   depth (2,506,172,416 parameters, bf16, remat "layer") through the
   train CLI (``repro_torch.launch.train.main``), 4 steps of 4 x 1,024
   tokens from the data pipeline; every loss and grad norm must be
   finite; prints step time p50, tokens/s, the share of the card's dense
   bf16 peak (``card_rates``) that 6 * params * tokens a step makes,
   and peak device memory.  10b: the same model on one batch repeated 6
   times at a constant rate: the last loss must be below the first; the
   last 4 steps are profiled (the device's busy share), and one more
   step is split into its gradient and its AdamW update.  10c: two steps
   of qwen3-8b and deepseek-moe-16b reduced in fp32 (TF32 off) on the
   card and on the CPU from the same weights: the first step's gradients
   within a fixed 2e-5 (``GRAD_ATOL``); params, ``m`` and ``v`` within
   max(2e-5, twice the CPU fp32 run's distance from a float64 run).  10d: a reduced qwen3-8b trains 4 steps saving at step 2; a new
   ``Trainer`` restores step 2 and runs 2 more: params, ``m`` and ``v``
   must equal the uninterrupted run's bit for bit.  The compressed
   cross-pod all-reduce needs two ranks, NCCL one card a rank: the CPU
   tests run it over ``gloo``.
11. (Runs after phase 10.)  The sharded train step and the production-
   mesh machinery; no kernel of phase 1 is on this path, and 11a's launch
   counts must all be 0.  11a: gemma-2b at full width, depth cut to 4
   layers (bf16, remat "layer"), 2 steps of 4 x 1,024 tokens through the
   sharded step (``distributed/sharding.py``: DTensor params, ``m`` and
   ``v``, each layer's weights gathered to full) over a one-rank NCCL
   mesh (pod, data, model) = (1, 1, 1), and 2 through the replicated
   step from the same weights and batch: params, ``m`` and ``v`` must be
   equal bit for bit (a world of one rank reduces nothing); prints both
   step times and the peak memory.  11b: the sharded state saved after
   step 1 is restored by ``elastic_resize`` onto a (data, model) = (1, 1)
   mesh and takes one step: bit for bit equal to 11a's step 2.  11c:
   ``repro_torch.launch.dryrun`` over all 40 cells x {single, multi} on
   meta: the statuses of ``shapes.all_cells``, every ``run`` cell ``ok``;
   prints each cell's per-rank GB, whether it fits in 80 GB and the three
   roofline terms; the prefill and decode cells count the sharded
   serving steps' plan (``dryrun.SERVING_PLAN``, run in phase 13).  11d:
   ``roofline.analysis.measured_kernel_table`` over the totals of phase
   2's ``dispatch`` spans; prints each impl's calls and host time only
   (the spans time the host's enqueue, so they bound no device rate).  Sharded steps
   over two or more ranks need a card a rank: the CPU tests run them over
   ``gloo`` (``tests/test_torch_distributed.py``).
12. (Runs after phase 11.)  The sharded step split over ``"model"``
   (tensor and expert parallelism: heads, hidden units, experts, vocab);
   no kernel of phase 1 is on this path, and every rank's launch counts
   must be 0.  NCCL takes one rank a card, so two ranks run on the one
   card in two spawned processes over a ``gloo`` group (``tcp://
   127.0.0.1``), mesh (data, model) = (1, 2); their collectives of CUDA
   tensors go through host copies (stated in the phase's output), the
   compute stays on the card.  12a: gemma-2b at full width, depth cut to
   4 of 18 layers; 12b: deepseek-moe-16b at full width, depth cut to 3 of
   28 (1 dense + 2 MoE); both bf16, remat "layer", 2 steps of 4 x 1,024
   random tokens; 12d: xlstm-1.3b cut to 8 of 48 layers (7 mLSTMs split
   by heads, an sLSTM by channels) and hymba-1.5b cut to 4 of 32 (its
   Mamba cells split by channels; its 25 heads do not divide 2), the same
   but 4 x 64 tokens: losses finite and equal on both ranks; prints each
   rank's step times, peak device memory, parameters held, and the bytes
   it moved by collective and axis (``sharding.wire_counts``), which
   must match the plan's count, and the weights gathered along "model",
   which must be the plan's exceptions (gemma's one KV head, hymba's
   ``w_in`` and attention), beside the card's name and power limit (two
   ranks share the card's SMs: the times are recorded, not compared as a
   speed).  12c: each arch at 2 layers (xlstm-1.3b's an mLSTM and an
   sLSTM) in fp32 (TF32
   off), one step of 2 x 256 tokens split over the two ranks against the
   one-rank replicated step that each rank runs beside on the same
   weights and batch: the loss within 1e-4, every gradient (from AdamW's
   first ``m`` and ``v``) within 10c's fixed ``GRAD_ATOL``, every weight
   within 2 x LR (each rank holds its own shards against the same pieces
   of the replicated state).
13. (Runs after phase 12.)  Sharded serving: ``serve/steps.py``'s
   prefill and greedy decode steps on a model placed by ``shard_model``,
   two spawned ranks on the one card over ``gloo`` as in phase 12, mesh
   (data, model) = (1, 2); no kernel of phase 1 is on this path, and every
   rank's launch counts must be 0.  13a: qwen3-8b at full width and depth
   (bf16; the ranks build their shards in turn, so the card never holds
   two full copies); 13b: deepseek-moe-16b at full width, depth cut to 3
   of 28 (expert-parallel, 32 of 64 experts a rank); 13d: xlstm-1.3b and
   hymba-1.5b at full width and depth, their recurrent states split over
   the ranks; each a prefill of 4 x 256 random tokens and 32 greedy
   steps (hymba 8: each of its steps gathers 524 MB along "model"
   through host copies): tokens equal on both ranks, the last logits (4,
   1, V) whole on
   each; prints the prefill ms, the decode step p50/p99, each rank's peak
   memory and parameters held, and the bytes it moved by collective and
   axis in the prefill and a decode step, which must equal
   ``analysis.plan_collective_bytes`` (gathered along "model" only the
   plan's exceptions: hymba's ``w_in`` and attention).  13c (fp32, TF32
   off; ``SERVE_EXACT``): each
   rank runs the one-rank steps beside on the same weights; the greedy
   tokens must be equal, the last logits within 1e-4 and the MoE's routed
   and dropped slots equal: qwen3-8b at 2 layers on (1, 2); deepseek-
   moe-16b at 2 layers on (1, 2), expert-parallel decode, and on (2, 1),
   4 rows, where the reference's dispatch falls back to one group (the
   rows gathered over data); hymba-1.5b at 2 layers on (2, 1), one row,
   16 steps from an empty cache of 24 slots split over data, 12 a rank,
   so that both ranks write slots and add to the softmax merge; xlstm-
   1.3b (an mLSTM and an sLSTM) and hymba-1.5b at 2 layers on (1, 2),
   their states split over "model".
6. Durable open-loop ingest with a crash and a restart: ``torch-nbtree``
   at phase 2's shape under ``repro_torch.ingest.IngestFrontend`` with a
   WAL and LSN-keyed snapshots on local disk; a preload of 2^22 keys over
   2^24, then ``insert-heavy`` at 20,000 ops/s (Poisson, on the frontend's
   clock) killed right after the 2048th WAL fsync (acked, not applied).
   The queue bound holds the whole trace, so no op is shed and the number
   of commits does not depend on how fast the disk's fsync is.
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
   space of 2^22 (one batch, range-partitioned by its sample), each
   tenant's queue bound holding its whole trace (as in phase 6), killed
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

Kernel launch counters are zeroed just before each path (2-3, 4, the
measured runs of 8a and 8b, 9a, 10a, 11a, 12a-12b and 12d, 13a-13b and
13d, 6, 7) and read just after; every kernel
must have launched on its own path (3b counts each write path's launches
around its own calls: the eager one must launch ``merge_sorted``,
``bloom_build`` and the three read kernels, and no ``merge_sorted_batch``;
the four NB-tree kernels of the write side (both merges, the Bloom build
and update) and the two of the point reads on phase 6's too, and those and
``range_scan_rows`` on phase 7's; the root merge, the search, the probe
and ``paged_attention`` on 8a-8b's, summed as the path ``archs``, and on
9a's, the path ``variants``).  Prints a ``kernels`` JSON line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import functools
import gc
import io
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.roofline import hardware  # noqa: E402



@functools.cache
def card_rates() -> dict:
    """This card's rates, looked up once by its name in
    ``roofline/hardware.py`` (NVIDIA data sheets), and its ``variant``:
    ``hbm_bw`` bytes/s, ``fp32_ops`` the non-tensor fp32 rate (attention's
    fp32 ops; it stands in for int ops too), ``bf16_flops`` the dense bf16
    tensor-core peak (no sparsity).  The SXM's without a card (a phase
    rehearsed on the CPU)."""
    name = torch.cuda.get_device_name(0) if torch.cuda.is_available() else ""
    label = hardware.variant(name)
    return {**hardware.H100[label], "variant": label}


KEY_MAX = 0xFFFFFFFF
RUN_CAP, NW, H = 21504, 6784, 3      # f=4, sigma=4096 node-row shape
#: the path whose launches a kernel's row reports (the NB-tree path if absent)
KERNEL_PATH = {"paged_attention": "serve"}
#: kernels phase 6's durable ingest path must launch (its write side and
#: its point reads)
INGEST_KERNELS = ("merge_sorted", "merge_sorted_batch", "sorted_search_rows",
                  "bloom_probe_rows", "bloom_build", "bloom_update")
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
BUILD_SMEM = (0,)          # BB_MAX_SMEM values: 0 takes the device-memory body
#: the swept constant of each kernel source, and the key of its variants
SWEEPS = {"SS_W": ("sorted_search.cu", SEARCH_W, "search"),
          "BP_THREADS": ("bloom_filter.cu", BLOOM_THREADS, "bloom"),
          "RS_W": ("range_scan.cu", RANGE_W, "range lanes"),
          "RS_WARPS": ("range_scan.cu", RANGE_WARPS, "range warps"),
          "PA_SPLIT_CTAS": ("paged_attention.cu", PA_SPLIT_CTAS, "attention"),
          "BB_MAX_SMEM": ("bloom_filter.cu", BUILD_SMEM, "bloom build")}


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
    rates = card_rates()
    return max(nbytes / rates["hbm_bw"], reads * 6 / rates["fp32_ops"]) * 1e3


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
    rates = card_rates()
    return max(Q * (h * 8 + 8 + 4 + 1) / rates["hbm_bw"],
               Q * h * 12 / rates["fp32_ops"]) * 1e3


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


# ------------------------------------------------------- bloom build sweeps
BUILD_ROWS = 5     # a flush's filters: f = 4 children and the root's rest
INSERT_KEYS = 4096  # an insert batch, ORed onto the root's filter
#: the most words a row built in shared memory may have (BB_MAX_SMEM / 4
#: of bloom_filter.cu); longer rows take the device-memory body
BUILD_SMEM_WORDS = 232_448 // 4


def build_work(R: int, N: int, update: bool, h: int = H) -> tuple:
    """(bytes, integer ops) of one build launch over R rows of N keys:
    each key read once, each word written once (and read once by the
    update); ~12 integer ops a hash."""
    return 8 * R * N + 8 * R * NW * (2 if update else 1), R * N * h * 12


def build_inputs(g, dev, n_sets: int = 1) -> list:
    """``n_sets`` of (flush keys, insert words, insert keys): a flush's
    BUILD_ROWS runs of RUN_CAP keys in the node table's layout (counts 0, 1,
    RUN_CAP, RUN_CAP - 1 and one drawn, a KEY_MAX tail after each), and an
    insert batch of INSERT_KEYS keys (a tenth of them KEY_MAX padding) onto
    a built filter row."""
    from repro_torch.kernels import ops

    out = []
    for _ in range(n_sets):
        fk, _, _ = table_rows(g, BUILD_ROWS, dev)
        words = ops.bloom_build(fk[4], NW * 32, H)
        ik = torch.randint(0, KEY_MAX, (INSERT_KEYS,), generator=g, device=dev)
        ik[-INSERT_KEYS // 10:] = KEY_MAX
        out.append((fk, words, ik))
    return out


def bloom_build_edge_sweep(g, dev) -> tuple:
    """The build and the update, bit for bit against their plain versions:
    h = 1..6 on the flush's rows and on one run; rows of KEY_MAX alone,
    duplicate keys, keys 0 and KEY_MAX - 1; R = 1..5; nbits 32, 4096, NW *
    32 and one word past the rows shared memory holds (the device-memory
    body).  The update ORs onto random words, bit 31 included."""
    from repro_torch.kernels import bloom_filter as bf

    build = lambda *a: (bf.bloom_build_cuda(*a),)          # noqa: E731
    build_p = lambda *a: (bf.bloom_build_plain(*a),)       # noqa: E731
    update = lambda *a: (bf.bloom_update_cuda(*a),)        # noqa: E731
    update_p = lambda *a: (bf.bloom_update_plain(*a),)     # noqa: E731
    err = n_checks = 0

    def check(label, keys, nbits, h):
        nonlocal err, n_checks
        err = max(err, assert_exact(f"bloom_build {label}", build, build_p,
                                    keys, nbits, h))
        old = torch.randint(0, KEY_MAX + 1, (*keys.shape[:-1], nbits // 32),
                            generator=g, device=dev)
        err = max(err, assert_exact(f"bloom_update {label}", update, update_p,
                                    old, keys, nbits, h))
        n_checks += 2

    keys = torch.randint(0, KEY_MAX, (BUILD_ROWS, RUN_CAP), generator=g,
                         device=dev)
    keys[:, :2000] = keys[:, 2000:4000]                    # duplicates
    keys[:, 0], keys[:, 1] = 0, KEY_MAX - 1
    keys[:, -4000:] = KEY_MAX                              # padding tail
    keys[1] = KEY_MAX                                      # padding alone
    run = keys[0, :INSERT_KEYS].contiguous()
    for h in HASHES:
        check(f"h={h} flush rows", keys, NW * 32, h)
        check(f"h={h} one run", run, NW * 32, h)
    for r in range(1, BUILD_ROWS + 1):
        check(f"R={r}", keys[:r, :INSERT_KEYS].contiguous(), NW * 32, H)
    for nbits in (32, 4096, (BUILD_SMEM_WORDS + 1) * 32):
        check(f"nbits={nbits}", keys[:2, :INSERT_KEYS].contiguous(), nbits, H)
        check(f"nbits={nbits} one run", run, nbits, H)
    return err, n_checks


def bloom_build_timings(g, dev, label: str) -> dict:
    """The build at the flush shape and the update at the insert's, warm
    (20 calls on one set) and cold (one call on each of more than 64 MB of
    sets), each set checked bit for bit.  Returns {shape: (warm, cold,
    bound) ms}."""
    from repro_torch.kernels import bloom_filter as bf

    one = build_inputs(g, dev)[0]
    n_sets = int(COLD_BYTES // build_work(BUILD_ROWS, RUN_CAP, False)[0]) + 1
    sets = build_inputs(g, dev, n_sets)
    shapes = {
        f"flush {BUILD_ROWS} x {RUN_CAP}": (
            lambda s: bf.bloom_build_cuda(s[0], NW * 32, H),
            lambda s: bf.bloom_build_plain(s[0], NW * 32, H),
            build_work(BUILD_ROWS, RUN_CAP, False)),
        f"insert {INSERT_KEYS}": (
            lambda s: bf.bloom_update_cuda(s[1], s[2], NW * 32, H),
            lambda s: bf.bloom_update_plain(s[1], s[2], NW * 32, H),
            build_work(1, INSERT_KEYS, True))}
    rates, out = card_rates(), {}
    for shape, (fn, plain, (nbytes, nops)) in shapes.items():
        for s in (one, sets[0], sets[-1]):
            got, want = fn(s), plain(s)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"bloom build {label} {shape}: kernel "
                                     "differs from its plain version")
        warm = device_ms(lambda: fn(one), 20)
        cold = graph_ms([lambda s=s: fn(s) for s in sets])
        bound = max(nbytes / rates["hbm_bw"], nops / rates["fp32_ops"]) * 1e3
        out[shape] = (warm, cold, bound)
        log(f"  bloom build {label} {shape}: warm {warm:.5f} ms, cold "
            f"{cold:.5f} ms, bound {bound:.6f} ms ({len(sets)} input sets "
            f"for the cold calls)")
    del sets
    torch.cuda.empty_cache()
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
    rates = card_rates()
    return max(nbytes / rates["hbm_bw"], nops / rates["fp32_ops"]) * 1e3


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
             (2, 4, 4, 128, 8, 13, [104, 3]),
             (4, 1, 8, 256, 8, 36, None),                  # gemma-2b serving
             (4, 2, 12, 128, 8, 36, None),                 # starcoder2-3b
             (4, 2, 6, 128, 8, 36, None)]                  # qwen2-vl-2b
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
#: the decode shapes of phases 8 and 9's paged serving (8a, 8b, 9a):
#: 256-token prompts and 32 new tokens over pages of 8 slots, as SERVE_PA
ARCH_PA = {"gemma-2b": dict(B=4, KVH=1, G=8, D=256, S=8, MP=36),
           "starcoder2-3b": dict(B=4, KVH=2, G=12, D=128, S=8, MP=36),
           "qwen2-vl-2b": dict(B=4, KVH=2, G=6, D=128, S=8, MP=36)}


def pa_serving_sets(g, dev, c=SERVE_PA) -> list:
    """Inputs at a serving shape ``c`` (bf16 q over fp32 pages), one set per
    layer of an (L, KVH, P, S, D) cache of P = B * MP + 16 pages, with as
    many layers (at least 8) as hold more than ``COLD_BYTES`` of pages
    (SERVE_PA: 8 layers, 84 MB), more than L2; each call reads a layer's
    slice as the decoder does, with one block table for every layer (its
    range check then runs once, outside the CUDA graph)."""
    P = c["B"] * c["MP"] + 16
    layer_bytes = 2 * 4 * c["KVH"] * P * c["S"] * c["D"]
    layers = max(8, -(-int(COLD_BYTES) // layer_bytes))
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


def pa_bound_ms(c) -> float:
    """Bytes bound of one call at shape ``c``: every K and V element of the
    named pages read once (fp32), q read and out written (bf16), the block
    table and seq_lens read, over the card's memory rate."""
    kv = c["B"] * c["KVH"] * c["MP"] * c["S"] * c["D"] * 2 * 4
    qo = 2 * c["B"] * c["KVH"] * c["G"] * c["D"] * 2
    return ((kv + qo + c["B"] * c["MP"] * 4 + c["B"] * 4)
            / card_rates()["hbm_bw"] * 1e3)


def pa_arch_timings(g, dev, label: str) -> None:
    """``paged_attention`` at the serving shapes of phases 8 and 9
    (``ARCH_PA``), warm and cold, beside its bound."""
    for arch, c in ARCH_PA.items():
        sets = pa_serving_sets(g, dev, c)
        warm, cold = pa_timings(sets, f"{label} {arch} KVH={c['KVH']} "
                                      f"G={c['G']} D={c['D']}")
        log(f"  paged_attention {arch} shape: bound {pa_bound_ms(c):.6f} ms "
            f"(bytes); warm {warm / pa_bound_ms(c):.2f}x, cold "
            f"{cold / pa_bound_ms(c):.2f}x the bound ({len(sets)} layers of "
            f"pages for the cold calls)")
        del sets
        torch.cuda.empty_cache()


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
    pa_arch_timings(g, dev, "(this package)")


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
        t_bytes = nbytes / card_rates()["hbm_bw"] * 1e3
        t_ops = nops / card_rates()["fp32_ops"] * 1e3
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

    # ---- Bloom build and update: a flush's 5 rows, an insert batch ------
    err, n_checks = bloom_build_edge_sweep(g, dev)
    log(f"  bloom build edge sweep: {n_checks} kernel calls bit-exact vs "
        f"plain (build and update; h = 1..6; R = 1..{BUILD_ROWS}; rows of "
        f"KEY_MAX alone, duplicates, keys 0 and KEY_MAX - 1; nbits 32, 4096, "
        f"{NW * 32}, {(BUILD_SMEM_WORDS + 1) * 32})")
    bloom_build_timings(g, dev, "(this build)")
    for v, lib in variants["bloom build"].items():
        with kernel_library(lib):
            e, _ = bloom_build_edge_sweep(g, dev)
            err = max(err, e)
            bloom_build_timings(g, dev, f"BB_MAX_SMEM={v}")
    fk, words, ik = build_inputs(g, dev)[0]
    build = lambda *a: (bf.bloom_build_cuda(*a),)          # noqa: E731
    update = lambda *a: (bf.bloom_update_cuda(*a),)        # noqa: E731
    err = max(err, assert_exact(
        "bloom_build", build, lambda *a: (bf.bloom_build_plain(*a),),
        fk, NW * 32, H))
    err = max(err, assert_exact(
        "bloom_update", update, lambda *a: (bf.bloom_update_plain(*a),),
        words, ik, NW * 32, H))
    nbytes, nops = build_work(BUILD_ROWS, RUN_CAP, False)
    record("bloom_build", "bloom_filter.cu",
           "none (XLA runs src/repro/kernels/ref.py bloom_build_ref)", err,
           lambda: bf.bloom_build_cuda(fk, NW * 32, H),
           lambda: bf.bloom_build_plain(fk, NW * 32, H),
           None, nbytes=nbytes, nops=nops)
    nbytes, nops = build_work(1, INSERT_KEYS, True)
    record("bloom_update", "bloom_filter.cu",
           "none (XLA runs src/repro/kernels/ref.py bloom_update_ref)", err,
           lambda: bf.bloom_update_cuda(words, ik, NW * 32, H),
           lambda: bf.bloom_update_plain(words, ik, NW * 32, H),
           None, nbytes=nbytes, nops=nops)
    del fk, words, ik

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
        f"1, MP*S; G = 1, 6, 8, 12; KVH 1 at D 256, KVH 2 at G 12 and KVH 2 "
        f"at G 6 (phases 8 and 9's serving shapes); fp32, bf16 and bf16-over-fp32; (MP, splits) "
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
    log(f"  paged_attention qwen3-8b shape: bound {pa_bound_ms(SERVE_PA):.6f} "
        "ms (bytes)")
    for c, lib in variants["attention"].items():
        with kernel_library(lib):
            e32, e16, _, _ = pa_edge_sweep(g, dev)
            pa_timings(sets, f"PA_SPLIT_CTAS={c} ({pa_splits(B, KVH, MP)} "
                             f"splits; edge sweep fp32 {e32:.3g}, bf16 "
                             f"{e16:.3g})")
    del sets
    torch.cuda.empty_cache()
    pa_arch_timings(g, dev, "(this build)")
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
    """Tracer stand-in that keeps only the totals of the index's
    ``dispatch`` spans: ``stats``, impl name -> ``{count, wall_s, bytes}``
    (``bytes`` 0: a span counts no traffic)."""

    def __init__(self):
        self.stats = {}

    def complete(self, cat, name, t0_s, dur_s, **args):
        if cat == "dispatch":
            st = self.stats.setdefault(name,
                                       {"count": 0, "wall_s": 0.0, "bytes": 0})
            st["count"] += 1
            st["wall_s"] += dur_s

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


def busy_text(prof, wall_s: float) -> str:
    """``busy_share`` of a profiled window, as the log prints it."""
    share, top = busy_share(prof, wall_s)
    if share is None:
        return "device busy share not measured (profiler saw no device time)"
    return (f"device busy {share:.4f} of {wall_s:.4f} s wall (idle "
            f"{1 - share:.4f}); top kernels by device time: "
            + "; ".join(f"{k} {f:.3f}" for k, f in top))


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
    log(f"  {label} profiled batches {window.start}..{window.stop - 1}: "
        + busy_text(prof, t_window))
    return rates, n_ops / t_serve


def phase_main_path(dev, args):
    """Phases 2-3; returns (their kernel launches, the totals of the
    index's dispatch spans: impl name -> {count, wall_s, bytes})."""
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
    tally = _DispatchTally()
    idx.attach_tracer(tally)
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
    ds = tally.stats
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
    return launches, ds


# ----------------------------------------------------------------- phase 3b
#: phase 3b: the eager write path (``fused=False``) beside the fused one,
#: phase 2's index shape, one stream into both
EAGER = dict(f=4, sigma=4096, max_nodes=4096, max_results=128,
             keys=1 << 20, key_space=1 << 26, batch=4096, delete_every=8,
             deletes=256, queries=4096, ranges=256, span=1 << 11)
#: kernels the eager path must launch: the single-pair merge and the
#: filter build on its write side, and those of the reads after it
EAGER_KERNELS = ("merge_sorted", "bloom_build", "sorted_search_rows",
                 "bloom_probe_rows", "range_scan_rows")


def tree_shape(node):
    return (node.nid, node.count, tuple(node.skeys),
            tuple(tree_shape(c) for c in node.children))


class IngestTally:
    """The reference ingest benchmark's fields for one write path
    (``benchmarks/bench_ingest_device.py::_ingest``): wall time of the
    writes, their maintenance and the drain; dispatches by insert batch and
    by maintain unit; each unit's wall time (synchronised); kernel
    launches made inside this path's calls."""

    def __init__(self, engine):
        self.engine, self.idx = engine, engine.idx
        self.wall = self.drain_s = 0.0
        self.batches = self.insert_disp = 0
        self.unit_s: list = []
        self.units = {"flush": 0, "split": 0}
        self.unit_disp = {"flush": 0, "split": 0}
        self.launches = collections.Counter()
        self.flushes = 0
        plain_flush = self.idx._flush

        def counted_flush(node):
            self.flushes += 1
            plain_flush(node)

        self.idx._flush = counted_flush

    def _launched(self, fn):
        from repro_torch.kernels import ops
        before = ops.launch_counts()
        out = fn()
        self.launches.update({k: v - before[k]
                              for k, v in ops.launch_counts().items()})
        return out

    def write(self, batch) -> None:
        d0 = self.idx.dispatch_count
        t0 = time.perf_counter()
        self._launched(lambda: self.engine.apply(batch))   # syncs
        self.wall += time.perf_counter() - t0
        self.insert_disp += self.idx.dispatch_count - d0
        self.batches += 1

    def maintain(self) -> None:
        """One ``maintain(1)``, timed to its device work's end."""
        u0, d0, f0 = self.idx.units_done, self.idx.dispatch_count, self.flushes
        t0 = time.perf_counter()
        self._launched(lambda: self.engine.maintain(1))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.wall += dt
        if self.idx.units_done > u0:
            kind = "flush" if self.flushes > f0 else "split"
            self.unit_s.append(dt)
            self.units[kind] += 1
            self.unit_disp[kind] += self.idx.dispatch_count - d0

    def drain(self) -> None:
        d0, u0 = self.idx.dispatch_count, self.idx.units_done
        t0 = time.perf_counter()
        self._launched(self.engine.drain)
        torch.cuda.synchronize()
        self.drain_s = time.perf_counter() - t0
        self.wall += self.drain_s
        self.drain_units = self.idx.units_done - u0
        self.drain_disp = self.idx.dispatch_count - d0

    def line(self, label: str, n_ops: int) -> str:
        units = sum(self.units.values()) + self.drain_units
        ms = np.asarray(self.unit_s) * 1e3
        per = {k: self.unit_disp[k] / max(self.units[k], 1)
               for k in self.units}
        inside = self.idx.units_done - units
        disp = sum(self.unit_disp.values()) + self.drain_disp
        return (f"  {label}: {n_ops} write ops in {self.wall:.3f} s "
                f"({n_ops / self.wall:.1f} insert ops/s incl. maintain(1) "
                f"per batch and the drain); "
                f"{self.insert_disp / self.batches:.3f} dispatches per "
                f"insert batch (with the {inside} units its backpressure "
                f"ran); "
                f"{disp / units:.3f} per maintain unit "
                f"({self.units['flush']} flush units, {per['flush']:.3f} "
                f"each; {self.units['split']} split "
                f"units, {per['split']:.3f} each; {self.drain_units} in the "
                f"drain of {self.drain_s * 1e3:.3f} ms); maintain-unit p50 "
                f"{pct(ms, 50):.3f} ms, p99 {pct(ms, 99):.3f} ms, p100 "
                f"{ms.max():.3f} ms; launches "
                + json.dumps({k: v for k, v in sorted(self.launches.items())
                              if v}))


def phase_eager(dev) -> dict:
    """Phase 3b; returns the eager path's kernel launches."""
    from repro_torch.core.engine_api import OpBatch, OpKind, TorchNBTreeEngine
    from repro_torch.core.splitmix import splitmix64
    from repro_torch.core.state import TABLES

    c = EAGER
    if c["keys"] < 1 << 22:
        log(f"  CUT: {c['keys']} keys instead of 2^22: the stream of 2^22 "
            "took 81.4 s for both paths on an H100 80GB HBM3 at 700 W "
            "(fused 35.7 s, eager 42.4 s), over this phase's ~30 s share "
            "of the run's limit")
    cfg = dict(f=c["f"], sigma=c["sigma"], max_nodes=c["max_nodes"],
               max_results=c["max_results"], device=dev)
    tallies = {fused: IngestTally(TorchNBTreeEngine(fused=fused, **cfg))
               for fused in (True, False)}
    # YCSB's hashed insertion order: key i is splitmix64(i) % space
    keys = (splitmix64(np.arange(c["keys"], dtype=np.uint64))
            % np.uint64(c["key_space"])).astype(np.uint32)
    vals = np.arange(c["keys"], dtype=np.int32)
    rng = np.random.default_rng(7)
    log_k, log_v = [], []               # every write in order, -1 = delete
    for b, i in enumerate(range(0, c["keys"], c["batch"])):
        batches = [OpBatch.inserts(keys[i:i + c["batch"]],
                                   vals[i:i + c["batch"]])]
        if b % c["delete_every"] == c["delete_every"] - 1:
            batches.append(OpBatch.deletes(
                keys[rng.integers(0, i + c["batch"], c["deletes"])]))
        for batch in batches:
            log_k.append(batch.keys)
            log_v.append(np.where(batch.kinds == int(OpKind.DELETE), -1,
                                  batch.vals))
            for t in tallies.values():
                t.write(batch)
        for t in tallies.values():
            t.maintain()
    for t in tallies.values():
        t.drain()
    # last writer wins over the whole log, then deletes drop out
    log_k, log_v = np.concatenate(log_k), np.concatenate(log_v)
    n_ops = len(log_k)
    uk, last = np.unique(log_k[::-1], return_index=True)
    uv = log_v[::-1][last]
    oracle = Oracle(uk[uv >= 0], uv[uv >= 0])
    fused, eager = (tallies[f].idx for f in (True, False))

    # ---- the two indexes hold the same state, bit for bit ------------------
    for name in TABLES:
        assert torch.equal(getattr(fused, name), getattr(eager, name)), name
    assert tree_shape(fused.root) == tree_shape(eager.root), "host tree"
    assert fused._next_id == eager._next_id and not fused._pending \
        and not eager._pending
    for t in tallies.values():
        k, v = t.engine.dump_live()
        assert np.array_equal(k, oracle.keys), "dump_live keys != oracle"
        assert np.array_equal(v, oracle.vals), "dump_live vals != oracle"
    log(f"  {n_ops} write ops ({c['keys']} inserts of keys drawn from "
        f"{c['key_space']} in YCSB's hashed order, a delete batch of "
        f"{c['deletes']} after every {c['delete_every']}th insert batch): "
        f"the seven tables, the host tree and _next_id ({eager._next_id}) "
        f"equal on both paths bit for bit; both dump_live == oracle "
        f"({len(oracle.keys)} pairs); height {eager.height}, "
        f"{eager.max_nodes} rows")

    # ---- reads: equal on both, and equal to the oracle ---------------------
    q = np.concatenate([keys[rng.integers(0, c["keys"], c["queries"] // 2)],
                        rng.integers(0, c["key_space"], c["queries"] // 2,
                                     dtype=np.uint32)])
    lo = rng.integers(0, c["key_space"] - c["span"], c["ranges"],
                      dtype=np.uint32)
    reads = OpBatch.concat([OpBatch.queries(q),
                            OpBatch.ranges(lo, lo + np.uint32(c["span"]))])
    res = {f: t._launched(lambda t=t: t.engine.apply(reads))
           for f, t in tallies.items()}
    n_ranges = oracle.check(reads, res[True], OpKind)
    for field in ("found", "values", "range_truncated"):
        assert np.array_equal(getattr(res[True], field),
                              getattr(res[False], field)), field
    for a, b in zip(res[True].range_hits, res[False].range_hits):
        assert (a is None) == (b is None)
        if a is not None:
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
    log(f"  {len(q)} point queries and {n_ranges} ranges of {c['span']} "
        "keys: equal on both paths and == oracle")

    for f, t in tallies.items():
        log(t.line("fused" if f else "eager", n_ops))
    from repro_torch.kernels import ops
    launches = {k: tallies[False].launches[k] for k in ops.launch_counts()}
    if launches["merge_sorted_batch"]:
        raise AssertionError("the eager path launched merge_sorted_batch")
    for name_k in EAGER_KERNELS:
        if not launches[name_k]:
            raise AssertionError(f"{name_k} never launched on the eager path")
    return launches


# ------------------------------------------------------------------ phase 4
def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


#: each full-size arch the script draws: its published shape (n_layers,
#: d_model, n_heads, n_kv_heads, head_dim, d_ff, vocab, qk_norm, rope_base,
#: dtype) and its weight bytes in that dtype (the MoE router in fp32), as
#: the JAX package's init_params gives them under jax.eval_shape
ARCHS = {
    "qwen3-8b": ((36, 4096, 32, 8, 128, 12288, 151936, True, 1e6,
                  "bfloat16"), 16_381_470_720),
    "gemma-2b": ((18, 2048, 8, 1, 256, 16384, 256000, False, 1e4,
                  "bfloat16"), 5_012_344_832),
    "starcoder2-3b": ((30, 3072, 24, 2, 128, 12288, 49152, False, 1e5,
                       "bfloat16"), 6_361_411_584),
    "deepseek-moe-16b": ((28, 2048, 16, 16, 128, 10944, 102400, False, 1e4,
                          "bfloat16"), 32_758_534_144),
    "minicpm3-4b": ((62, 2560, 40, 40, 64, 6400, 73448, False, 1e4,
                     "bfloat16"), 8_147_751_936),
    "mixtral-8x22b": ((56, 6144, 48, 8, 128, 16384, 32768, False, 1e6,
                       "bfloat16"), 281_265_647_616),
    "qwen2-vl-2b": ((28, 1536, 12, 2, 128, 8960, 151936, False, 1e6,
                     "bfloat16"), 3_087_313_920),
    "xlstm-1.3b": ((48, 2048, 4, 4, 512, 0, 50304, False, 1e4, "bfloat16"),
                   2_477_461_504),
    "hymba-1.5b": ((32, 1600, 25, 5, 64, 5504, 32001, False, 1e4,
                    "bfloat16"), 3_287_254_400),    # a_log, d_skip, dt_bias fp32
    "hubert-xlarge": ((48, 1280, 16, 16, 80, 5120, 504, False, 1e4,
                       "bfloat16"), 1_890_513_920),
}


def arch_config(arch: str):
    """The registry's config of ``arch``, asserted against ``ARCHS``."""
    from repro_torch.models import registry

    cfg = registry.get_config(arch)
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.resolved_head_dim, cfg.d_ff, cfg.vocab, cfg.qk_norm,
           cfg.rope_base, cfg.dtype)
    assert got == ARCHS[arch][0], (arch, got)
    return cfg


def draw_model(cfg, args, dev, arch=None):
    """Random weights on the card from ``--seed``; at an arch's full depth
    the weight bytes are asserted against ``ARCHS``.  Collects the earlier
    phases' cyclic garbage first, so what they left on the card is freed
    (and the rest is printed) before a model is drawn and measured."""
    from repro_torch.models.transformer import init_params

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = init_params(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    w_bytes = sum(p.nbytes for p in model.parameters())
    if arch is not None and cfg.n_layers == ARCHS[arch][0][0]:
        assert w_bytes == ARCHS[arch][1], (arch, w_bytes)
    log(f"  {cfg.name}: {cfg.n_layers} layers {cfg.segments}, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV heads x "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}; {w_bytes} weight bytes drawn on the card from seed "
        f"{args.seed} in {time.perf_counter() - t0:.3f} s ({held} bytes "
        f"held on the card before the draw)")
    return model


def phase_serve(dev, args, arch="qwen3-8b", cfg=None) -> dict:
    """``arch`` at full width and depth through the paged serving engine;
    returns the kernel launches of its measured run.  ``cfg`` replaces the
    config only to rehearse the phase on the CPU at a reduced size."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve.engine import INDEX_PARTS, Engine, Request

    full = cfg is None
    if full:
        cfg = arch_config(arch)
    n_req, prompt_len, n_new, max_batch = 8, 256, 32, 4
    n_pages, page_size = 1024, 8
    model = draw_model(cfg, args, dev, arch if full else None)
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
    log(f"  profiled decode steps {window.start}..{window.stop - 1} of an "
        f"extra batch: {busy_text(prof, wall_p[0])}")
    del eng.decoder.decode           # the wrapper's cycle would keep the model
    del eng, model
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------ phase 5
def phase_exact(dev, args, arch="qwen3-8b", cfg=None) -> None:
    """``arch`` at full width, depth cut to 4 layers, fp32: the engine's
    greedy tokens equal the contiguous-cache decode's.  ``cfg`` replaces
    the cut config only to rehearse the phase on the CPU."""
    from repro_torch.serve.engine import Engine, Request

    depth, n_req, prompt_len, n_new = 4, 2, 64, 8
    if cfg is None:
        full = arch_config(arch)
        cfg = dataclasses.replace(full, n_layers=depth,
                                  segments=(("dense", depth),),
                                  dtype="float32")
        log(f"  CUT: {arch} depth {depth} of {full.n_layers} layers (full "
            f"width, fp32); {n_req} requests of {prompt_len}-token prompts, "
            f"{n_new} new tokens")
    model = draw_model(cfg, args, dev)
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


# ------------------------------------------------------------------ phase 8
#: kernels 8a-8b's and 9a's paged serving must launch (the attention, and
#: the page index's root merges, descents and probes)
ARCH_KERNELS = ("merge_sorted", "sorted_search_rows", "bloom_probe_rows",
                "paged_attention")


@contextlib.contextmanager
def counting_drops(tally):
    """While ``tally["on"]``, count the (token, k) slots that MoE routing
    sees and the ones its capacity drops (summed on the card)."""
    from repro_torch.models import moe

    real = moe.route

    def route(xf, p, cfg):
        out = real(xf, p, cfg)
        if tally["on"]:
            keep = out[3]
            tally["slots"] += keep.numel()
            tally["dropped"] = tally["dropped"] + (~keep).sum()
        return out

    moe.route = route
    try:
        yield tally
    finally:
        moe.route = real


@contextlib.contextmanager
def counting_blockwise(tally):
    """Count the attention calls that take the blockwise path."""
    from repro_torch.models import layers

    real = layers.blockwise_sdpa

    def blockwise_sdpa(*a, **kw):
        tally["blockwise"] += 1
        return real(*a, **kw)

    layers.blockwise_sdpa = blockwise_sdpa
    try:
        yield tally
    finally:
        layers.blockwise_sdpa = real


def cache_bytes(cache) -> int:
    """Bytes of every tensor of a decode cache (lists, tuples, dicts)."""
    if isinstance(cache, torch.Tensor):
        return cache.nbytes
    items = cache.values() if isinstance(cache, dict) else cache
    return sum(cache_bytes(c) for c in items)


def phase_contiguous(dev, args, arch, depth=None, cfg=None,
                     prompt_len=256) -> None:
    """``arch`` at full width (depth cut to ``depth`` if given) through
    ``serve/steps.py``'s prefill and decode steps over the contiguous
    cache, the reference's entry points for MoE, MLA, recurrent and
    hybrid stacks: 2 batches of 4 requests, ``prompt_len``-token prompts,
    32 new tokens each; then a third batch whose decode steps 2..9 run
    under torch.profiler.  ``cfg`` replaces the config only to rehearse
    the phase on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.moe import capacity
    from repro_torch.serve.steps import make_prefill_step, make_serve_step

    full = cfg is None
    if full:
        cfg = arch_config(arch)
        if depth is not None:
            log(f"  CUT: depth {depth} of {cfg.n_layers} layers (full width)")
            cfg = dataclasses.replace(cfg, n_layers=depth,
                                      segments=((cfg.segments[0][0], depth),))
    n_batches, B, n_new = 2, 4, 32
    model = draw_model(cfg, args, dev, arch if full else None)
    prefill = make_prefill_step(cfg, prompt_len + n_new)
    step = make_serve_step(cfg)
    rng = np.random.default_rng(args.seed)
    window = range(2, 10)
    tally = {"on": False, "slots": 0, "dropped": 0, "blockwise": 0}
    state = {}

    def serve(profiled=None):
        """One batch; returns (prefill s, decode step s, tokens)."""
        toks = torch.as_tensor(rng.integers(1, cfg.vocab, (B, prompt_len)),
                               device=dev)
        t0 = time.perf_counter()
        logits, cache = prefill(model, {"tokens": toks})
        nxt = logits[:, -1].argmax(-1).to(torch.int32)
        out = [nxt.tolist()]
        t_pf = time.perf_counter() - t0
        state["bytes"] = cache_bytes(cache)
        assert logits.shape == (B, 1, cfg.vocab)
        assert bool(torch.isfinite(logits).all()), "prefill logits not finite"
        steps = []
        for s in range(n_new - 1):
            if profiled is not None and s == window.start:
                torch.cuda.synchronize()
                profiled.start()
            tally["on"] = profiled is not None and s not in window
            t0 = time.perf_counter()
            nxt, cache = step(model, cache, nxt, prompt_len + s)
            out.append(nxt.tolist())
            steps.append(time.perf_counter() - t0)
            if profiled is not None and s == window.stop - 1:
                torch.cuda.synchronize()
                profiled.stop()
        tally["on"] = False
        tokens = torch.tensor(out).T
        assert tokens.shape == (B, n_new)
        assert bool(((tokens >= 0) & (tokens < cfg.vocab)).all())
        return t_pf, steps, tokens

    with counting_drops(tally), counting_blockwise(tally):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runs = [serve() for _ in range(n_batches)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        blockwise = tally["blockwise"]
        prof = profile(activities=[ProfilerActivity.CUDA])
        _, extra, _ = serve(profiled=prof)
    pf = [r[0] for r in runs]
    st = [s for r in runs for s in r[1]]
    n_tok = n_batches * B * n_new
    log(f"  served {n_batches} batches of {B} ({prompt_len}-token prompts, "
        f"{n_new} new tokens each) through make_prefill_step / "
        f"make_serve_step: {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tokens/s; prefill {np.mean(pf) * 1e3:.3f} ms "
        f"per batch ({', '.join(f'{x * 1e3:.3f}' for x in pf)}); decode "
        f"step p50 {pct(st, 50) * 1e3:.3f} ms, p99 {pct(st, 99) * 1e3:.3f} "
        f"ms, max {max(st) * 1e3:.3f} ms over {len(st)} steps "
        f"({B / np.median(st):.1f} tokens/s in decode); peak device memory "
        f"{peak} bytes")
    log(f"  decode cache after the prefill: {state['bytes']} bytes, "
        f"{state['bytes'] // B} a sequence (cache length "
        f"{prompt_len + n_new}); "
        f"blockwise attention calls in the two measured batches: {blockwise}")
    if tally["slots"]:
        dropped = int(tally["dropped"])
        log(f"  MoE capacity at decode (B = {B}, cap = {capacity(B, cfg)}): "
            f"{dropped} of {tally['slots']} (token, k) slots dropped, "
            f"share {dropped / tally['slots']:.4f} (the third batch's "
            f"unprofiled steps)")
    wall_p = sum(extra[s] for s in window)
    log(f"  profiled decode steps {window.start}..{window.stop - 1} of a "
        f"third batch: {busy_text(prof, wall_p)}")
    del model
    torch.cuda.empty_cache()


def prefill_vs_stepwise(dev, args, cfg, B=2, S=32, n=8) -> None:
    """A prefill-built cache continues with the same greedy tokens as a
    cache built token by token, for ``n`` decode steps, and the last
    prefill logits and every step's logits agree within 2e-3 (fp32; the
    reference's ``test_prefill_cache_matches_stepwise`` tolerance)."""
    model = draw_model(cfg, args, dev)
    toks = torch.as_tensor(np.random.default_rng(args.seed + 2).integers(
        1, cfg.vocab, (B, S)), device=dev)
    logits, _, cache_pf = model(toks, build_cache_len=S + n)
    cache_st = model.init_cache(B, S + n)
    for i in range(S):
        lg, cache_st = model.decode_step(toks[:, i], cache_st, i)
    diff = float((logits[:, -1].float() - lg).abs().max())
    torch.testing.assert_close(logits[:, -1].float(), lg, atol=2e-3,
                               rtol=2e-3)
    a, b = [logits[:, -1].argmax(-1)], [lg.argmax(-1)]
    for s in range(n):
        la, cache_pf = model.decode_step(a[-1], cache_pf, S + s)
        lb, cache_st = model.decode_step(b[-1], cache_st, S + s)
        diff = max(diff, float((la - lb).abs().max()))
        torch.testing.assert_close(la, lb, atol=2e-3, rtol=2e-3)
        a.append(la.argmax(-1))
        b.append(lb.argmax(-1))
    a, b = torch.stack(a, 1).tolist(), torch.stack(b, 1).tolist()
    log(f"  {cfg.name} {cfg.segments}: prefill-built cache tokens == "
        f"stepwise cache tokens over {n} steps: {a == b}; max abs logit "
        f"difference {diff:.3g} (tol 2e-3)")
    assert a == b, (a, b)
    del model, cache_pf, cache_st
    torch.cuda.empty_cache()


def ring_vs_full(dev, args, cfg, B=2, S=160, n=40) -> None:
    """An SWA prompt past window + 128: the prefill's ring decodes ``n``
    steps past its rollover with the tokens and logits (fp32, within
    1e-4) of a full-length cache built token by token.  The ring is that
    of the first windowed layer (``swa``, ``moe_swa`` or ``hybrid``)."""
    model = draw_model(cfg, args, dev)
    toks = torch.as_tensor(np.random.default_rng(args.seed + 3).integers(
        1, cfg.vocab, (B, S)), device=dev)
    logits, _, ring = model(toks, build_cache_len=S + n)
    li = next(i for i, blk in enumerate(model.layers)
              if blk.kind in ("swa", "moe_swa", "hybrid"))
    kv = lambda c: c["kv"] if "kv" in c else c     # hybrid: {"kv", "ssm"}
    slots = kv(ring[li])["k"].shape[1]
    assert slots == cfg.swa_window + 128 < S, slots
    full = model.init_cache(B, S + n)
    assert kv(full[li])["k"].shape[1] == S + n
    for i in range(S):
        _, full = model.decode_step(toks[:, i], full, i)
    nxt, diff, tokens = logits[:, -1].argmax(-1), 0.0, []
    for s in range(n):
        lr, ring = model.decode_step(nxt, ring, S + s)
        lf, full = model.decode_step(nxt, full, S + s)
        torch.testing.assert_close(lr, lf, atol=1e-4, rtol=1e-4)
        diff = max(diff, float((lr - lf).abs().max()))
        nxt = lr.argmax(-1)
        assert torch.equal(nxt, lf.argmax(-1)), s
        tokens.append(nxt)
    log(f"  {cfg.name} (d_model {cfg.d_model}, {cfg.n_layers} layers), "
        f"window {cfg.swa_window}: a {S}-token "
        f"prompt's ring of {slots} slots decoded {n} steps past its "
        f"rollover (positions {S}..{S + n - 1}): tokens == full-length "
        f"cache's, max abs logit difference {diff:.3g}")
    del model, ring, full
    torch.cuda.empty_cache()


def phase_archs_exact(dev, args) -> None:
    """8f, fp32: gemma-2b's engine against its contiguous decode (depth
    4); deepseek-moe-16b (1 dense + 1 moe layer) and minicpm3-4b (4
    layers) at full width, prefill-built cache against stepwise; the
    mixtral config reduced with window 16, a ring past its rollover
    against a full-length cache.  The MoE cases run at capacity factor
    8.0, the reference test's, so that neither routing drops: the
    prefill routes all B*S tokens under one capacity, a decode step B."""
    phase_exact(dev, args, "gemma-2b")
    ds = arch_config("deepseek-moe-16b")
    ds = dataclasses.replace(ds, n_layers=2, segments=(("dense", 1),
                                                        ("moe", 1)),
                             dtype="float32", capacity_factor=8.0)
    log("  CUT: deepseek-moe-16b depth 2 of 28 (layer 0 dense, one moe "
        "layer), fp32, capacity factor 8.0 (default 1.25)")
    prefill_vs_stepwise(dev, args, ds)
    mc = arch_config("minicpm3-4b")
    mc = dataclasses.replace(mc, n_layers=4, segments=(("mla", 4),),
                             dtype="float32")
    log("  CUT: minicpm3-4b depth 4 of 62, fp32")
    prefill_vs_stepwise(dev, args, mc)
    mx = dataclasses.replace(arch_config("mixtral-8x22b").reduced(),
                             dtype="float32", remat="none", swa_window=16,
                             capacity_factor=8.0)
    log("  CUT: mixtral-8x22b reduced (d_model 128, 2 layers, 4 experts), "
        "window 16, fp32, capacity factor 8.0 (the full-length cache is "
        "built token by token, the ring by the prefill)")
    ring_vs_full(dev, args, mx)


def phase_archs(dev, args) -> dict:
    """Phase 8 (see the module docstring); returns the kernel launches of
    8a's and 8b's measured runs, summed."""
    t0 = time.perf_counter()
    times = {}
    log("  8a: gemma-2b at full width and depth through the paged engine")
    la = phase_serve(dev, args, "gemma-2b")
    times["8a"] = time.perf_counter() - t0
    log("  8b: starcoder2-3b at full width and depth through the paged engine")
    lb = phase_serve(dev, args, "starcoder2-3b")
    times["8b"] = time.perf_counter() - t0 - sum(times.values())
    for part, arch, depth in (("8c", "deepseek-moe-16b", None),
                              ("8d", "minicpm3-4b", None),
                              ("8e", "mixtral-8x22b", 4)):
        log(f"  {part}: {arch} at full width through serve/steps.py")
        phase_contiguous(dev, args, arch, depth)
        times[part] = time.perf_counter() - t0 - sum(times.values())
    log("  8f: exactness, fp32")
    phase_archs_exact(dev, args)
    times["8f"] = time.perf_counter() - t0 - sum(times.values())
    log("  phase 8 parts took " + ", ".join(f"{k} {v:.1f} s"
                                            for k, v in times.items()))
    return {k: la[k] + lb[k] for k in la}


# ------------------------------------------------------------------ phase 9
def phase_encode(dev, args, cfg=None) -> None:
    """9d: hubert-xlarge at full width and depth through ``make_encode_step``
    on 4 clips of 1,500 frame embeddings (30 s of audio at 20 ms frames;
    the conv frontend is a stub, as in the reference), drawn on the card
    from ``--seed``: two measured clips, then one under torch.profiler.
    ``cfg`` replaces the config only to rehearse the phase on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.steps import make_encode_step

    full = cfg is None
    if full:
        cfg = arch_config("hubert-xlarge")
    B, frames = 4, 1500
    model = draw_model(cfg, args, dev, "hubert-xlarge" if full else None)
    encode = make_encode_step(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    # frame embeddings at the scale of the token embeddings' init
    clips = [torch.randn((B, frames, cfg.d_model), generator=g, device=dev)
             / cfg.d_model ** 0.5 for _ in range(3)]
    tally = {"blockwise": 0}
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counting_blockwise(tally):
        for e in clips[:2]:
            t0 = time.perf_counter()
            logits = encode(model, {"embeds": e})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            assert logits.shape == (B, frames, cfg.vocab), logits.shape
            assert bool(torch.isfinite(logits).all()), "logits not finite"
    peak = torch.cuda.max_memory_allocated()
    assert tally["blockwise"] == 2 * cfg.n_layers, tally
    prof = profile(activities=[ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    t0 = time.perf_counter()
    encode(model, {"embeds": clips[2]})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.stop()
    log(f"  encoded 2 batches of {B} clips x {frames} frames through "
        f"make_encode_step: {', '.join(f'{t * 1e3:.3f}' for t in times)} ms "
        f"per batch ({B * frames / np.mean(times):.1f} frames/s); logits "
        f"{tuple(logits.shape)} finite; {tally['blockwise']} blockwise "
        f"attention calls (B*S*S*H = {B * frames * frames * cfg.n_heads}); "
        f"peak device memory {peak} bytes")
    log(f"  profiled third batch ({wall * 1e3:.3f} ms): {busy_text(prof, wall)}")
    del model, clips, logits
    torch.cuda.empty_cache()


def mrope_exact(dev, args) -> None:
    """qwen2-vl-2b at full width, depth 4, fp32: a forward with three equal
    M-RoPE rows equals the tokens forward bit for bit, and a forward over
    a 16x16 patch grid with distinct (t, h, w) rows is finite."""
    cfg = dataclasses.replace(arch_config("qwen2-vl-2b"), n_layers=4,
                              segments=(("dense", 4),), dtype="float32")
    model = draw_model(cfg, args, dev)
    B, n_text, side = 2, 8, 16
    S = n_text + side * side
    toks = torch.as_tensor(np.random.default_rng(args.seed + 5).integers(
        1, cfg.vocab, (B, S)), device=dev)
    plain, _ = model(toks)
    same = torch.arange(S, device=dev).expand(3, B, S)
    assert torch.equal(model(toks, mrope_positions=same)[0], plain), \
        "M-RoPE with three equal rows must be RoPE bit for bit"
    text = torch.arange(n_text, device=dev)
    cell = torch.arange(side * side, device=dev)
    pos3 = torch.stack([torch.cat([text, torch.full_like(cell, n_text)]),
                        torch.cat([text, n_text + cell // side]),
                        torch.cat([text, n_text + cell % side])])
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 5)
    embeds = torch.cat([model.embed[toks[:, :n_text]],
                        torch.randn((B, side * side, cfg.d_model),
                                    generator=g, device=dev)
                        / cfg.d_model ** 0.5], dim=1)
    grid, _ = model(embeds=embeds, mrope_positions=pos3[:, None].expand(3, B, S))
    assert grid.shape == (B, S, cfg.vocab)
    assert bool(torch.isfinite(grid).all()), "patch-grid logits not finite"
    log(f"  M-RoPE: three equal rows == RoPE bit for bit over {S} tokens; "
        f"{n_text} text tokens + a {side}x{side} patch grid with distinct "
        f"(t, h, w) rows: logits finite, max |logit| "
        f"{float(grid.abs().max()):.4g}")
    del model, plain, grid
    torch.cuda.empty_cache()


#: 9e's blockwise checks: (label, B, S, H, KVH, D, kind, window), the
#: prefill shapes of 9c (hymba-1.5b) and 9d (hubert-xlarge)
BLOCKWISE_SHAPES = (("9c hymba-1.5b", 4, 1536, 25, 5, 64, "causal", 1024),
                    ("9d hubert-xlarge", 4, 1500, 16, 16, 80, "bidir", None))


def blockwise_exact(dev, args) -> None:
    """``blockwise_sdpa`` against the naive ``_sdpa`` at ``BLOCKWISE_SHAPES``
    (fp32, within 3e-5, the reference test's tolerance; the chunks
    accumulate in another order), and with int8 K/V and ``kv_scales``
    against the naive attention over the dequantized K/V."""
    from repro_torch.models.blockwise_attn import blockwise_sdpa
    from repro_torch.models.layers import _quantize_kv, _sdpa, causal_mask

    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 4)
    for label, B, S, H, KVH, D, kind, window in BLOCKWISE_SHAPES:
        q = torch.randn((B, S, H, D), generator=g, device=dev)
        k = torch.randn((B, S, KVH, D), generator=g, device=dev)
        v = torch.randn((B, S, KVH, D), generator=g, device=dev)
        pos = torch.arange(S, device=dev).expand(B, S)
        if kind == "causal":
            mask = causal_mask(S, window=window, device=dev)
        else:
            mask = torch.ones((S, S), dtype=torch.bool, device=dev)
        mask = mask.expand(B, S, S)
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        errs = []
        for kk, vv, scales in ((k, v, None), (kq, vq, (ks, vs))):
            got = blockwise_sdpa(q, kk, vv, qpos=pos, kpos=pos, kind=kind,
                                 window=window, kv_scales=scales)
            if scales is not None:
                kk = kk.float() * scales[0][..., None]
                vv = vv.float() * scales[1][..., None]
            want = _sdpa(q, kk, vv, mask)
            torch.testing.assert_close(got, want, atol=3e-5, rtol=0)
            errs.append(float((got - want).abs().max()))
            del got, want
        log(f"  blockwise_sdpa vs naive _sdpa at {label}'s prefill (B {B}, "
            f"S {S}, H {H}, KVH {KVH}, D {D}, {kind}, window {window}): max "
            f"abs err {errs[0]:.3g}; int8 K/V with kv_scales vs the "
            f"dequantized naive path {errs[1]:.3g} (tol 3e-5)")
        del q, k, v, kq, vq
        torch.cuda.empty_cache()


def int8_exact(dev, args) -> None:
    """qwen2-vl-2b at full width, depth 4, fp32, 16 decode steps over an
    int8 cache and over a model-dtype one (the same weights): every
    stored int8 value, dequantized, lies within scale / 2 of the fp32 K/V
    it stores; the reference test's bounds hold (relative logit error
    < 0.05, >= 14 argmax agreements)."""
    from repro_torch.models import layers

    cfg = dataclasses.replace(arch_config("qwen2-vl-2b"), n_layers=4,
                              segments=(("dense", 4),), dtype="float32")
    m16 = draw_model(cfg, args, dev)
    m8 = draw_model(dataclasses.replace(cfg, kv_cache_dtype="int8"), args,
                    dev)
    assert all(torch.equal(a, b) for a, b in zip(m16.parameters(),
                                                  m8.parameters()))
    n = 16
    toks = torch.as_tensor(np.random.default_rng(args.seed + 6).integers(
        1, cfg.vocab, n), device=dev)
    c16, c8 = m16.init_cache(1, 2 * n), m8.init_cache(1, 2 * n)
    assert c8[0]["k"].dtype == torch.int8 and "k_scale" in c8[0]
    stored, real = [], layers._quantize_kv
    layers._quantize_kv = lambda t: stored.append(t.clone()) or real(t)
    try:
        agree = 0
        for i in range(n):
            l16, c16 = m16.decode_step(toks[i:i + 1], c16, i)
            l8, c8 = m8.decode_step(toks[i:i + 1], c8, i)
            agree += int(l16[0].argmax() == l8[0].argmax())
    finally:
        layers._quantize_kv = real
    rel = float((l16 - l8).abs().max() / (l16.abs().max() + 1e-9))
    L = cfg.n_layers
    assert len(stored) == n * L * 2
    worst = 0.0
    for i in range(n):
        for layer in range(L):
            for j, name in enumerate(("k", "v")):
                want = stored[(i * L + layer) * 2 + j][:, 0]
                scale = c8[layer][f"{name}_scale"][:, i, :, None]
                got = c8[layer][name][:, i].float() * scale
                worst = max(worst, float(((got - want).abs() / scale).max()))
    log(f"  int8 KV cache over {n} decode steps: stored values within "
        f"{worst:.4f} x scale of the fp32 K/V they store (bound 0.5); "
        f"relative logit error {rel:.4g} (< 0.05), {agree} of {n} argmax "
        f"agreements (>= 14) against the model-dtype cache")
    assert worst <= 0.5 + 1e-4, worst     # + fp32 rounding of w * scale
    assert rel < 0.05, rel
    assert agree >= 14, agree
    del m16, m8, c16, c8, stored
    torch.cuda.empty_cache()


def phase_variants_exact(dev, args) -> None:
    """9e, fp32 (see the module docstring)."""
    phase_exact(dev, args, "qwen2-vl-2b")
    mrope_exact(dev, args)
    xl = dataclasses.replace(arch_config("xlstm-1.3b"), n_layers=8,
                             segments=(("mlstm", 7), ("slstm", 1)),
                             dtype="float32")
    log("  CUT: xlstm-1.3b depth 8 of 48 (one (mlstm 7, slstm 1) segment), "
        "fp32")
    prefill_vs_stepwise(dev, args, xl)
    hy = dataclasses.replace(arch_config("hymba-1.5b"), n_layers=3,
                             segments=(("hybrid_global", 1), ("hybrid", 1),
                                       ("hybrid_global", 1)),
                             dtype="float32")
    log("  CUT: hymba-1.5b depth 3 of 32 (hybrid_global, hybrid, "
        "hybrid_global), fp32")
    prefill_vs_stepwise(dev, args, hy)
    log("  CUT: the same hymba-1.5b config with window 16 (published 1024)")
    ring_vs_full(dev, args, dataclasses.replace(hy, swa_window=16))
    blockwise_exact(dev, args)
    int8_exact(dev, args)


def phase_variants(dev, args) -> dict:
    """Phase 9 (see the module docstring); returns the kernel launches of
    9a's measured run."""
    t0 = time.perf_counter()
    times = {}
    log("  9a: qwen2-vl-2b at full width and depth through the paged engine")
    launches = phase_serve(dev, args, "qwen2-vl-2b")
    times["9a"] = time.perf_counter() - t0
    log("  9b: xlstm-1.3b at full width and depth through serve/steps.py")
    phase_contiguous(dev, args, "xlstm-1.3b")
    times["9b"] = time.perf_counter() - t0 - sum(times.values())
    log("  9c: hymba-1.5b at full width and depth through serve/steps.py, "
        "1,536-token prompts")
    phase_contiguous(dev, args, "hymba-1.5b", prompt_len=1536)
    times["9c"] = time.perf_counter() - t0 - sum(times.values())
    log("  9d: hubert-xlarge at full width and depth through make_encode_step")
    phase_encode(dev, args)
    times["9d"] = time.perf_counter() - t0 - sum(times.values())
    log("  9e: exactness, fp32")
    phase_variants_exact(dev, args)
    times["9e"] = time.perf_counter() - t0 - sum(times.values())
    log("  phase 9 parts took " + ", ".join(f"{k} {v:.1f} s"
                                            for k, v in times.items()))
    return launches


# ----------------------------------------------------------------- phase 10
#: 10a's run through the train CLI: gemma-2b at full width and depth (its
#: config: bf16, remat "layer"), 4 rows of 1,024 tokens a step
TRAIN = dict(arch="gemma-2b", batch=4, seq=1024, steps=4, params=2_506_172_416)
#: 10b: steps on one repeated batch at a constant rate, the last 4 profiled
LOSS_STEPS, LOSS_LR = 6, 3e-4


def train_pair(arch: str, dev, seed: int):
    """(config, CPU model, card model, CPU float64 model) of ``arch``
    reduced in fp32 with the same weights, drawn on the CPU from
    ``seed``."""
    from repro_torch.models import registry
    from repro_torch.models.transformer import Transformer, init_params

    cfg = dataclasses.replace(registry.get_config(arch).reduced(),
                              dtype="float32", remat="none")
    host = init_params(cfg, seed=seed, device="cpu")
    card = Transformer(cfg, device=dev)
    card.load_state_dict(host.state_dict())
    exact = Transformer(dataclasses.replace(cfg, dtype="float64"),
                        device="cpu")
    exact.load_state_dict({k: v.double() for k, v in
                           host.state_dict().items()})
    return cfg, host, card, exact


def state_diffs(a, b) -> dict:
    """Max abs difference of params, ``m`` and ``v`` between two trained
    (model, opt_state) pairs, compared in float64 on the CPU."""
    (ma, oa), (mb, ob) = a, b
    pb = dict(mb.named_parameters())
    out = {"params": 0.0, "m": 0.0, "v": 0.0}
    for name, p in ma.named_parameters():
        for part, (x, y) in {"params": (p, pb[name]),
                             "m": (oa["m"][name], ob["m"][name]),
                             "v": (oa["v"][name], ob["v"][name])}.items():
            d = x.detach().cpu().double() - y.detach().cpu().double()
            out[part] = max(out[part], float(d.abs().max()))
    return out


#: 10c's bound on the first step's gradients, card vs CPU (fp32, TF32
#: off): the reference's own bound between two runs of a step
#: (``tests/test_distributed.py``), fixed
GRAD_ATOL = 2e-5


def train_card_vs_cpu(dev, args) -> None:
    """10c: two train steps of qwen3-8b and deepseek-moe-16b reduced, fp32,
    TF32 off, on the card and on the CPU from the same weights and batch,
    and the same on the CPU in float64.  The first step's gradients (before
    AdamW) of the card must lie within ``GRAD_ATOL`` of the CPU's.  Params,
    ``m`` and ``v`` of the card must lie within ``max(2e-5, 2 * e)`` of
    the CPU's, ``e`` the CPU fp32 run's distance from the float64 run: the
    reference's own bound between two runs of a step, unless fp32
    rounding alone, which AdamW's normalisation amplifies on weights whose
    gradient is near ``eps``, is wider."""
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import (_grads_microbatched,
                                              make_loss_fn, make_train_step)

    assert not torch.backends.cuda.matmul.allow_tf32
    for arch in ("qwen3-8b", "deepseek-moe-16b"):
        cfg, host, card, exact = train_pair(arch, dev, args.seed)
        toks = torch.from_numpy(np.random.default_rng(args.seed).integers(
            1, cfg.vocab, (8, 64)).astype(np.int64))
        first = []
        for model in (host, card):
            model.requires_grad_(True)
            g, _, _ = _grads_microbatched(make_loss_fn(cfg), model,
                                          {"tokens": toks.to(model.device)}, 1)
            first.append(g)
        gdiff = max(float((first[1][n].cpu() - g).abs().max())
                    for n, g in first[0].items())
        gmax = max(float(g.abs().max()) for g in first[0].values())
        log(f"  {arch} reduced, fp32: first-step gradients, card vs CPU max "
            f"abs diff {gdiff:.3e} (fixed bound {GRAD_ATOL:.0e}; largest "
            f"gradient {gmax:.4f})")
        if not gdiff <= GRAD_ATOL:
            raise AssertionError(f"10c {arch}: the card's gradients differ "
                                 "from the CPU's")
        del first
        runs = []
        for model in (host, card, exact):
            step = make_train_step(model.cfg, adamw.AdamWConfig(lr=1e-3))
            opt = adamw.init(dict(model.named_parameters()))
            ms = [step(model, opt, {"tokens": toks.to(model.device)})
                  for _ in range(2)]
            runs.append((model, opt, ms))
        (h, ho, hm), (c, co, cm), (x, xo, _) = runs
        errs = state_diffs((c, co), (h, ho))
        rounding = state_diffs((h, ho), (x, xo))
        tols = {k: max(2e-5, 2 * v) for k, v in rounding.items()}
        dl = max(abs(float(a["loss"]) - float(b["loss"]))
                 for a, b in zip(hm, cm))
        aux = float(cm[-1]["aux_loss"])
        log(f"  {arch} reduced, fp32, 2 steps of 8 x 64 tokens: card vs CPU "
            "max abs diff " + ", ".join(
                f"{k} {errs[k]:.3e} (CPU fp32 vs float64 {rounding[k]:.3e}, "
                f"bound {tols[k]:.3e})" for k in errs)
            + f"; loss diff {dl:.3e}; aux {aux:.6f}; card grad norms "
            f"{[round(float(m['grad_norm']), 6) for m in cm]}")
        if any(errs[k] > tols[k] for k in errs) or dl > 1e-4:
            raise AssertionError(f"10c {arch}: card differs from the CPU")
        if cfg.n_experts and not aux > 0:
            raise AssertionError("10c: the MoE aux term did not run")


def train_restart(dev, args, cfg=None) -> None:
    """10d: a reduced qwen3-8b (its registry config: bf16, remat "layer")
    trains 4 steps saving only at step 2 into a temporary checkpoint
    directory; a new Trainer there restores step 2 and runs the
    pipeline's batches 3 and 4: params, m, v and count must equal the
    uninterrupted run's bit for bit."""
    from repro_torch.data.pipeline import (PackedBatches, StreamingIngest,
                                           synthetic_documents)
    from repro_torch.models import registry
    from repro_torch.optim import adamw, schedules
    from repro_torch.train.trainer import Trainer

    cfg = cfg or registry.get_config("qwen3-8b").reduced()
    opt_cfg = adamw.AdamWConfig(lr=schedules.cosine_with_warmup(3e-3, 2, 8))

    def batches():
        ing = StreamingIngest()
        for d in synthetic_documents(64, 72, cfg.vocab, seed=args.seed):
            ing.ingest(d)
        return PackedBatches(ing, batch=4, seq_len=64, seed=args.seed)

    with tempfile.TemporaryDirectory() as ckpt:
        a = Trainer(cfg, device=dev, opt_cfg=opt_cfg, ckpt_dir=ckpt,
                    seed=args.seed)
        stream = batches()
        hist = a.run(stream, 2, ckpt_every=2, log_every=0)
        hist += a.run(stream, 2, log_every=0)
        b = Trainer(cfg, device=dev, opt_cfg=opt_cfg, ckpt_dir=ckpt,
                    seed=args.seed)
        assert b.step == 2, b.step
        resumed = batches()
        next(resumed), next(resumed)
        hb = b.run(resumed, 2, log_every=0)
    same = all(torch.equal(b.params[n], p) for n, p in a.params.items())
    same &= all(torch.equal(b.opt_state[k][n], a.opt_state[k][n])
                for k in ("m", "v") for n in a.params)
    same &= int(b.opt_state["count"]) == int(a.opt_state["count"]) == 4
    log(f"  {cfg.name} reduced ({cfg.dtype}, remat {cfg.remat}): losses "
        f"{[round(h['loss'], 6) for h in hist]} uninterrupted, "
        f"{[round(h['loss'], 6) for h in hb]} after the restore at step 2; "
        f"params, m, v and count bit for bit equal: {same}")
    if not same or [h["loss"] for h in hb] != [h["loss"] for h in hist[2:]]:
        raise AssertionError("10d: the restarted run differs")


def phase_train(dev, args, cfg=None) -> dict:
    """Phase 10 (see the module docstring); returns the kernel launches of
    10a's run.  ``cfg`` replaces gemma-2b's config (and 10a runs the CLI
    with ``--reduced``) only to rehearse the phase on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import (PackedBatches, StreamingIngest,
                                           synthetic_documents)
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models.transformer import param_count
    from repro_torch.optim import adamw, schedules
    from repro_torch.train.train_step import _grads_microbatched, make_loss_fn
    from repro_torch.train.trainer import Trainer

    full = cfg is None
    t0 = time.perf_counter()
    times = {}
    tokens = TRAIN["batch"] * TRAIN["seq"]
    label, peak_flops = card_rates()["variant"], card_rates()["bf16_flops"]
    log(f"  10a: {TRAIN['arch']} at full width and depth through "
        "repro_torch.launch.train.main")
    argv = ["--arch", TRAIN["arch"], "--steps", str(TRAIN["steps"]),
            "--batch", str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]),
            "--ckpt-every", "0"]
    if not full:
        argv += ["--reduced", "--device", str(dev)]
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    hist = train_cli.main(argv)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    secs = [h["sec"] for h in hist]
    if len(hist) != TRAIN["steps"] or not np.isfinite(losses + norms).all():
        raise AssertionError(f"10a: losses {losses}, grad norms {norms}")
    p50 = pct(secs[1:], 50)
    log(f"  10a: losses {[round(x, 6) for x in losses]}, grad norms "
        f"{[round(x, 6) for x in norms]}, all finite; step s "
        f"{[round(x, 6) for x in secs]} (the first builds the cuBLAS "
        f"plans); steps 2-{len(secs)}: p50 {p50:.6f} s, "
        f"{tokens / p50:.1f} tokens/s, 6 * {TRAIN['params']} * {tokens} = "
        f"{6 * TRAIN['params'] * tokens:.4e} FLOP a step = "
        f"{6 * TRAIN['params'] * tokens / p50 / peak_flops:.4f} of the "
        f"{label} bf16 dense peak ({peak_flops / 1e12:.0f} TFLOP/s); peak "
        f"device memory {peak} bytes ({held} held before)")
    if any(launches.values()):
        raise AssertionError(f"10a launched a kernel: {launches}")
    log("  10a launched none of the six kernels (training reaches no Pallas "
        "kernel's counterpart): " + json.dumps(launches))
    times["10a"] = time.perf_counter() - t0

    log(f"  10b: {TRAIN['arch']} at full width, one batch repeated "
        f"{LOSS_STEPS} times at a constant rate {LOSS_LR}")
    gc.collect()
    torch.cuda.empty_cache()
    tcfg = cfg or arch_config(TRAIN["arch"])
    tr = Trainer(tcfg, device=dev, seed=args.seed,
                 opt_cfg=adamw.AdamWConfig(lr=schedules.constant(LOSS_LR)))
    if full and param_count(tr.model) != TRAIN["params"]:
        raise AssertionError(f"10b: {param_count(tr.model)} parameters")
    ing = StreamingIngest()
    for d in synthetic_documents(512, TRAIN["seq"] + 8, tcfg.vocab):
        ing.ingest(d)
    batch = next(PackedBatches(ing, TRAIN["batch"], TRAIN["seq"]))
    hist = tr.run([batch] * 2, 2, log_every=0)
    prof = profile(activities=[ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    t1 = time.perf_counter()
    hist += tr.run([batch] * (LOSS_STEPS - 2), LOSS_STEPS - 2, log_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    prof.stop()
    losses = [h["loss"] for h in hist]
    secs = [h["sec"] for h in hist]
    share, _ = busy_share(prof, wall)
    log(f"  10b: losses {[round(x, 6) for x in losses]}; step s "
        f"{[round(x, 6) for x in secs]}; steps 3-{LOSS_STEPS} profiled "
        f"({wall:.6f} s): {busy_text(prof, wall)}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"10b: the loss did not fall: {losses}")
    # one more step split in two, each half synchronised: the gradient
    # (forward, recompute and backward) and the AdamW update
    dev_batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads, _, _ = _grads_microbatched(make_loss_fn(tcfg), tr.model,
                                      dev_batch, 1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    adamw.update(grads, tr.opt_state, tr.params, tr.opt_cfg)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log(f"  10b: a step split: gradient {(t2 - t1) * 1e3:.3f} ms, AdamW "
        f"update {(t3 - t2) * 1e3:.3f} ms")
    del tr, prof, grads
    gc.collect()
    torch.cuda.empty_cache()
    times["10b"] = time.perf_counter() - t0 - sum(times.values())

    log("  10c: card vs CPU, reduced, fp32")
    train_card_vs_cpu(dev, args)
    times["10c"] = time.perf_counter() - t0 - sum(times.values())
    log("  10d: checkpoint restart")
    train_restart(dev, args, cfg)
    times["10d"] = time.perf_counter() - t0 - sum(times.values())
    log("  the compressed all-reduce (int8 over a 'pod' axis) is not run "
        "here: this script runs on one card and NCCL takes one rank per "
        "card; the CPU tests run it over gloo (tests/test_torch_train.py)")
    log("  phase 10 parts took " + ", ".join(f"{k} {v:.1f} s"
                                             for k, v in times.items())
        + (f"; busy share of 10b's profiled steps {share:.4f}"
           if share is not None else ""))
    return launches


# ----------------------------------------------------------------- phase 11
#: 11a: gemma-2b at full width, its depth cut to 4 layers (its config: bf16,
#: remat "layer"), 4 rows of 1,024 tokens, 2 steps at a constant rate
SHARDED = dict(arch="gemma-2b", layers=4, batch=4, seq=1024, steps=2,
               lr=3e-4)


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cut_depth(cfg, depth: int):
    """``cfg`` with its first ``depth`` layers, segments cut in order."""
    segs, left = [], depth
    for kind, count in cfg.segments:
        if left:
            segs.append((kind, min(count, left)))
            left -= segs[-1][1]
    return dataclasses.replace(cfg, n_layers=depth, segments=tuple(segs))


def sharded_config(cfg=None):
    from repro_torch.models import registry

    cfg = cfg or registry.get_config(SHARDED["arch"])
    if cfg.n_layers <= SHARDED["layers"]:
        return cfg
    return cut_depth(cfg, SHARDED["layers"])


def state_equal(model_a, opt_a, model_b, opt_b) -> bool:
    """Params, ``m``, ``v`` and count bit for bit (DTensors by their local
    pieces: on a one-rank mesh, the whole tensor)."""
    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    pb = dict(model_b.named_parameters())
    same = int(opt_a["count"]) == int(opt_b["count"])
    for n, p in model_a.named_parameters():
        same &= torch.equal(local(p), local(pb[n]))
        for k in ("m", "v"):
            same &= torch.equal(local(opt_a[k][n]), local(opt_b[k][n]))
    return bool(same)


def ckpt_bytes(directory: str) -> int:
    """Bytes of every file under ``directory``."""
    return sum(f.stat().st_size for f in Path(directory).rglob("*")
               if f.is_file())


def phase_sharded(dev, args, nbtree_stats, cfg=None) -> dict:
    """Phase 11 (see the module docstring); returns the kernel launches of
    11a's sharded run.  ``cfg`` replaces 11a's config only to rehearse the
    phase on the CPU (over ``gloo``)."""
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.shapes import all_cells
    from repro_torch.distributed import sharding
    from repro_torch.distributed.fault_tolerance import elastic_resize
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.models.transformer import (Transformer, init_params,
                                                param_count)
    from repro_torch.optim import adamw, schedules
    from repro_torch.roofline.analysis import measured_kernel_table
    from repro_torch.train.train_step import make_train_step

    t0 = time.perf_counter()
    times = {}
    cfg = sharded_config(cfg)
    on_card = dev.type == "cuda"
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    tmp = tempfile.TemporaryDirectory()
    try:
        kind = "cuda" if on_card else "cpu"
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), kind)
        opt_cfg = adamw.AdamWConfig(lr=schedules.constant(SHARDED["lr"]))
        batch = {"tokens": torch.from_numpy(np.random.default_rng(
            args.seed).integers(1, cfg.vocab, (SHARDED["batch"],
                                               SHARDED["seq"])).astype(
            np.int32)).to(dev)}
        log(f"  11a: {cfg.name} at full width, {cfg.n_layers} layers "
            f"({cfg.dtype}, remat {cfg.remat}), {SHARDED['batch']} x "
            f"{SHARDED['seq']} tokens: the sharded step over a one-rank "
            f"{'NCCL' if on_card else 'gloo'} mesh (pod, data, model) = "
            "(1, 1, 1) against the replicated step, same weights and batch")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        shard = sharding.shard_model(init_params(cfg, seed=args.seed,
                                                 device=dev), mesh)
        shard_opt = adamw.init(dict(shard.named_parameters()))
        sharded_step = make_train_step(cfg, opt_cfg, mesh=mesh)
        ckpt = Checkpointer(tmp.name)
        secs = {"sharded": [], "replicated": []}
        ops.reset_launch_counts()
        for i in range(SHARDED["steps"]):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            m = sharded_step(shard, shard_opt, batch)
            loss = float(m["loss"])
            secs["sharded"].append(time.perf_counter() - t1)
            if not np.isfinite(loss):
                raise AssertionError(f"11a: sharded loss {loss}")
            if i == 0:          # 11b restarts from here
                t1 = time.perf_counter()
                ckpt.save(1, sharding.full_state(
                    {"params": dict(shard.named_parameters()),
                     "opt": {k: shard_opt[k] for k in ("m", "v", "count")}}))
                save_s = time.perf_counter() - t1
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        peak_sharded = torch.cuda.max_memory_allocated()
        n_params = param_count(shard)
        torch.cuda.reset_peak_memory_stats()
        rep = init_params(cfg, seed=args.seed, device=dev)
        rep_opt = adamw.init(dict(rep.named_parameters()))
        rep_step = make_train_step(cfg, opt_cfg)
        for _ in range(SHARDED["steps"]):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            float(rep_step(rep, rep_opt, batch)["loss"])
            secs["replicated"].append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        peak_rep = torch.cuda.max_memory_allocated()
        same = state_equal(shard, shard_opt, rep, rep_opt)
        log(f"  11a: {n_params} parameters; step s sharded "
            f"{[round(x, 6) for x in secs['sharded']]}, replicated "
            f"{[round(x, 6) for x in secs['replicated']]} (the first of "
            f"each builds its plans); peak device memory sharded "
            f"{peak_sharded} B, with the replicated model beside it "
            f"{peak_rep} B; after {SHARDED['steps']} steps params, m, v and "
            f"count bit for bit equal: {same}")
        if not same:
            raise AssertionError("11a: the sharded step differs from the "
                                 "replicated one")
        if any(launches.values()):
            raise AssertionError(f"11a launched a kernel: {launches}")
        log("  11a launched none of the six kernels: " + json.dumps(launches))
        del rep, rep_opt
        gc.collect()
        torch.cuda.empty_cache()
        times["11a"] = time.perf_counter() - t0 - save_s
        times["11b"] = save_s

        mesh2 = make_mesh((1, 1), ("data", "model"), kind)
        like = dict(Transformer(cfg, device="meta").named_parameters())
        t1 = time.perf_counter()
        state = elastic_resize(ckpt, 1, {"params": like,
                                         "opt": adamw.init(like)},
                               mesh2, sharding.param_specs)
        restore_s = time.perf_counter() - t1
        resized = sharding.shard_model(Transformer(cfg, device="meta"),
                                       mesh2, params=state["params"])
        resized_opt = state["opt"]
        m = make_train_step(cfg, opt_cfg, mesh=mesh2)(resized, resized_opt,
                                                      batch)
        same = state_equal(resized, resized_opt, shard, shard_opt)
        log(f"  11b: step 1 saved ({3 * len(like) + 1} leaves, "
            f"{ckpt_bytes(tmp.name)} B on disk) in {save_s:.3f} s "
            f"(gathered, written, fsynced, checksummed), elastic_resize "
            f"onto (data, model) = (1, 1) in {restore_s:.3f} s, one step "
            f"(loss {float(m['loss']):.6f}): params, m, v and count bit for "
            f"bit equal to 11a's step 2: {same}")
        if not same:
            raise AssertionError("11b: the resized run differs from 11a")
        del shard, shard_opt, resized, resized_opt, state
        gc.collect()
        torch.cuda.empty_cache()
        times["11b"] += time.perf_counter() - t0 - sum(times.values())
    finally:
        dist.destroy_process_group()
        tmp.cleanup()

    out = Path(tempfile.mkdtemp()) / "dryrun.jsonl"
    try:
        with contextlib.redirect_stdout(io.StringIO()):   # its cell lines
            recs = dryrun.main(["--all", "--mesh", "both", "--out",
                                str(out)])
    finally:
        shutil.rmtree(out.parent)
    want = all_cells({a: registry.get_config(a)
                      for a in registry.list_archs()})
    for mesh_kind in ("single", "multi"):
        got = [(r["arch"], r["shape"], r["status"]) for r in recs
               if r["mesh_kind"] == mesh_kind]
        expect = [(a, s, "ok" if w == "run" else w) for a, s, w in want]
        if got != expect:
            raise AssertionError(f"11c {mesh_kind}: {got} != {expect}")
    log(f"  11c: repro_torch.launch.dryrun over {len(want)} cells x "
        f"{{single, multi}} on meta: {len(recs)} records, the statuses of "
        "all_cells, every run cell ok; per rank (train cells: "
        f"{dryrun.PLAN}; prefill and decode cells, marked [serving]: "
        f"{dryrun.SERVING_PLAN}):")
    log("    mesh   arch x shape: per-rank GB (params, opt, activation "
        "estimate), fits 80 GB; t_compute, t_memory, t_collective s, "
        "bottleneck")
    for r in recs:
        if r["status"] != "ok":
            continue
        b, ro = r["per_rank_bytes"], r["roofline"]
        tag = "" if r["plan"] == dryrun.PLAN else " [serving]"
        log(f"    {r['mesh']:>7} {r['arch']} x {r['shape']}{tag}: "
            f"{b['total'] / 1e9:.3f} ({b['params'] / 1e9:.3f}, "
            f"{b.get('opt_m_v', 0.0) / 1e9:.3f}, "
            f"{b['activation_estimate'] / 1e9:.3f}), fits {r['fits']}; "
            f"{ro['t_compute']:.6f}, {ro['t_memory']:.6f}, "
            f"{ro['t_collective']:.6f}, {ro['bottleneck']}")
    times["11c"] = time.perf_counter() - t0 - sum(times.values())

    rows = measured_kernel_table(nbtree_stats,
                                 peak_bw=card_rates()["hbm_bw"])
    if not rows:
        raise AssertionError("11d: phase 2 recorded no dispatch stats")
    # dispatch spans time the host's enqueue of each impl call and count
    # no bytes, so a rate or a share of the HBM peak taken from them
    # bounds neither the device's time nor its traffic: only the calls and
    # their host time are printed
    log("  11d: measured_kernel_table over phase 2's dispatch spans (calls "
        "and the host's clock around each impl call; no rates):")
    for r in rows:
        log(f"    {r['kernel']}: {r['count']} calls, {r['wall_s']:.6f} s")
    times["11d"] = time.perf_counter() - t0 - sum(times.values())
    log("  phase 11 parts took " + ", ".join(f"{k} {v:.1f} s"
                                             for k, v in times.items()))
    return launches


# ----------------------------------------------------------------- phase 12
#: 12a-12b, 12d: two ranks on one card over a gloo group, mesh (data,
#: model) = (1, 2); each arch at full width with its depth cut (bf16,
#: remat "layer"), 2 steps of 4 x 1,024 random tokens at a constant rate,
#: 12d's recurrent archs (their cells split over "model") of 4 x ``seqs``
#: (64: xlstm-1.3b's Python loop over time took 10.3-14.3 s a step at 256
#: tokens, PERF.md §6)
TP = dict(ranks=2, batch=4, seq=1024, steps=2, lr=3e-4,
          depth={"gemma-2b": 4, "deepseek-moe-16b": 3, "xlstm-1.3b": 8,
                 "hymba-1.5b": 4},
          seqs={"xlstm-1.3b": 64, "hymba-1.5b": 64})
#: 12c: the same archs at 2 layers (``every_kind``: xlstm-1.3b's an mLSTM
#: and an sLSTM) in fp32 (TF32 off), one step of 2 x 256 tokens, split
#: over the 2 ranks against the one-rank replicated step
TP_EXACT = dict(depth=2, batch=2, seq=256, lr=1e-3)
#: the tag each arch of phase 12 and 13 is logged under
TP_TAGS = {"gemma-2b": "a", "deepseek-moe-16b": "b", "qwen3-8b": "a",
           "xlstm-1.3b": "d", "hymba-1.5b": "d"}
#: 12c's bounds, fixed before the first run: the loss within 1e-4 and
#: every gradient (read back from AdamW's first m and v) within 10c's
#: ``GRAD_ATOL``, the reference's own bound between two runs of a step;
#: every weight within 2 x LR, what one AdamW step can move it (the CPU
#: tests' bound, ``tests/test_torch_tensor_parallel.py``)
TP_LOSS_ATOL = 1e-4
#: bytes by which a step's all-reduces along "model" may differ from the
#: dry-run's count of them: the scalars (loss, aux, norm, the MoE
#: fractions) and the loss's last position of each row, uncounted
TP_PLAN_SLACK = 256


def every_kind(cfg, depth: int):
    """``cfg`` cut to ``depth`` layers that hold each of its block kinds
    (at most ``depth``): one layer of each, in the order they first
    appear, the last kind taking the layers left (xlstm-1.3b at 2: an
    mLSTM and an sLSTM, where :func:`cut_depth` keeps two mLSTMs; the
    other archs as :func:`cut_depth`)."""
    kinds = list(dict.fromkeys(k for k, _ in cfg.segments))[:depth]
    counts = [1] * len(kinds)
    counts[-1] += depth - len(kinds)
    return dataclasses.replace(cfg, n_layers=depth,
                               segments=tuple(zip(kinds, counts)))


def plan_exceptions(cfg, sizes: dict) -> list:
    """The weights (names within a block, sorted) that the plan of ``cfg``
    on a mesh of ``sizes`` gathers along "model": sharded there, fetched
    "full" or "partial" (``analysis.step_plan``)."""
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.roofline import analysis

    shapes = {n: s for n, (s, _) in analysis.param_shapes(cfg).items()}
    specs = param_specs(shapes, sizes)
    return sorted({n.split(".", 2)[2] for n, mode in analysis.step_plan(
        cfg, sizes).modes.items() if n.startswith("layers.")
        and mode != "local" and "model" in specs[n]})


def tp_batch(cfg, rows: int, seq: int, seed: int, dev):
    return {"tokens": torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab, (rows, seq)).astype(np.int64)).to(dev)}


def tp_rank(rank, port, out, seed, dev_type, runs, exact, shapes) -> None:
    """One of phase 12's two ranks (module docstring): ``runs`` are the
    bf16 configs stepped at ``TP``'s shape, ``exact`` the fp32 ones held
    against the replicated step at ``TP_EXACT``'s (``shapes``: the
    parent's two dicts); rank 0 writes the results to ``out``."""
    TP.update(shapes[0])
    TP_EXACT.update(shapes[1])
    import torch.distributed as dist

    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_params, param_count
    from repro_torch.optim import adamw, schedules
    from repro_torch.train.train_step import make_train_step

    on_card = dev_type == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:                  # a CPU rehearsal: nothing to synchronise or read
        for f in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
            setattr(torch.cuda, f, lambda *a, **k: None)
        torch.cuda.max_memory_allocated = lambda *a, **k: 0
        torch.set_num_threads(2)
    dev = torch.device(dev_type)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=TP["ranks"], rank=rank)
    try:
        mesh = make_mesh((1, TP["ranks"]), ("data", "model"), dev_type)
        res = {"runs": {}, "exact": {}}
        t_up = time.perf_counter()
        ops.reset_launch_counts()
        for cfg in runs:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model = sharding.shard_model(init_params(cfg, seed=seed,
                                                     device=dev), mesh)
            opt = adamw.init(dict(model.named_parameters()))
            step = make_train_step(cfg, adamw.AdamWConfig(
                lr=schedules.constant(TP["lr"])), mesh=mesh)
            batch = tp_batch(cfg, TP["batch"],
                             TP["seqs"].get(cfg.name, TP["seq"]), seed, dev)
            secs, losses = [], []
            for _ in range(TP["steps"]):
                torch.cuda.synchronize()
                sharding.reset_wire_counts()
                t0 = time.perf_counter()
                m = step(model, opt, batch)
                losses.append(float(m["loss"]))
                secs.append(time.perf_counter() - t0)
            wire = sharding.wire_counts()
            res["runs"][cfg.name] = dict(
                secs=secs, losses=losses, grad_norm=float(m["grad_norm"]),
                peak=torch.cuda.max_memory_allocated(), wire=wire,
                local_params=sum(p.to_local().numel()
                                 for p in model.parameters()),
                params=param_count(model))
            del model, opt, step, m
        res["launches"] = ops.launch_counts()
        res["times"] = {"12a-12b, 12d": time.perf_counter() - t_up}
        for cfg in exact:
            gc.collect()
            torch.cuda.empty_cache()
            opt_cfg = adamw.AdamWConfig(lr=TP_EXACT["lr"])
            batch = tp_batch(cfg, TP_EXACT["batch"], TP_EXACT["seq"], seed,
                             dev)
            model = sharding.shard_model(init_params(cfg, seed=seed,
                                                     device=dev), mesh)
            opt = adamw.init(dict(model.named_parameters()))
            loss = float(make_train_step(cfg, opt_cfg, mesh=mesh)(
                model, opt, batch)["loss"])
            # every rank runs the replicated step beside and holds its own
            # shards against the same pieces of the replicated state
            rep = init_params(cfg, seed=seed, device=dev)
            rep_opt = adamw.init(dict(rep.named_parameters()))
            rep_loss = float(make_train_step(cfg, opt_cfg)(
                rep, rep_opt, batch)["loss"])
            b1, b2 = opt_cfg.b1, opt_cfg.b2
            diff = {"grad": 0.0, "grad_v": 0.0, "params": 0.0, "gmax": 0.0}

            def mine(full, like):
                return sharding.shard_tensor(full.detach(), mesh,
                                             list(like.placements)).to_local()

            for n, p in model.named_parameters():
                g_rep = mine(rep_opt["m"][n], p).double() / (1 - b1)
                g_tp = opt["m"][n].to_local().double() / (1 - b1)
                v_rep = (mine(rep_opt["v"][n], p).double() / (1 - b2)).sqrt()
                v_tp = (opt["v"][n].to_local().double() / (1 - b2)).sqrt()
                w_rep = mine(dict(rep.named_parameters())[n], p).double()
                for k, d in (("grad", g_tp - g_rep), ("grad_v", v_tp - v_rep),
                             ("params", p.detach().to_local().double()
                              - w_rep),
                             ("gmax", g_rep)):
                    diff[k] = max(diff[k], float(d.abs().max()))
            res["exact"][cfg.name] = dict(loss=loss, rep_loss=rep_loss, **diff)
            del model, opt, rep, rep_opt
        res["times"]["12c"] = time.perf_counter() - t_up - res["times"][
            "12a-12b, 12d"]
        if rank == 0:
            Path(out).write_text(json.dumps(res))
        else:
            Path(out).with_suffix(".rank1").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def spawn_ranks(phase: str, target, n: int, args: tuple,
                timeout: float) -> None:
    """``target(rank, *args)`` in ``n`` spawned processes, every join
    bounded; a rank that hangs or fails fails ``phase``."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args)) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(timeout=10)
    if hung or any(p.exitcode for p in procs):
        raise AssertionError(f"{phase}: rank exit codes "
                             f"{[p.exitcode for p in procs]}"
                             + (" (hung, killed)" if hung else ""))


def phase_tp(dev, args, cfgs=None) -> None:
    """Phase 12 (see the module docstring).  ``cfgs`` = (runs, exact)
    replaces the configs only to rehearse the phase on the CPU."""
    from repro_torch.models import registry
    from repro_torch.roofline import analysis

    t0 = time.perf_counter()
    if cfgs is None:
        runs = [cut_depth(registry.get_config(a), d)
                for a, d in TP["depth"].items()]
        exact = [dataclasses.replace(every_kind(registry.get_config(a),
                                                TP_EXACT["depth"]),
                                     dtype="float32")
                 for a in TP["depth"]]
    else:
        runs, exact = cfgs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip() \
        if dev.type == "cuda" else "no card (CPU rehearsal)"
    log(f"  12: {TP['ranks']} ranks on one {dev.type} device over a gloo "
        f"group (tcp://127.0.0.1), mesh (data, model) = (1, {TP['ranks']}); "
        "collectives of CUDA tensors go through host copies (gloo's "
        f"transport), compute stays on the device; card: {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "tp.json"
        spawn_ranks("phase 12", tp_rank, TP["ranks"],
                    (free_port(), str(out), args.seed, dev.type, runs, exact,
                     (TP, TP_EXACT)), timeout=600)
        res = json.loads(out.read_text())
        res1 = json.loads(out.with_suffix(".rank1").read_text())
    sizes = {"data": 1, "model": TP["ranks"]}
    for cfg in runs:
        r, r1 = res["runs"][cfg.name], res1["runs"][cfg.name]
        seq = TP["seqs"].get(cfg.name, TP["seq"])
        tokens = TP["batch"] * seq
        tag = "12" + TP_TAGS.get(cfg.name, "")
        log(f"  {tag}: {cfg.name} at full width, "
            f"{cfg.n_layers} layers {cfg.segments} ({cfg.dtype}, remat "
            f"{cfg.remat}), {r['params']} parameters, {r['local_params']} "
            f"and {r1['local_params']} held by ranks 0 and 1; "
            f"{TP['steps']} steps of {TP['batch']} x {seq} tokens: "
            f"losses {r['losses']}, grad norm {r['grad_norm']:.6f}; step s "
            f"rank 0 {[round(x, 6) for x in r['secs']]}, rank 1 "
            f"{[round(x, 6) for x in r1['secs']]} ({tokens} tokens a step; "
            "two ranks share the card's SMs: recorded, not a speed); peak "
            f"device memory rank 0 {r['peak']} B, rank 1 {r1['peak']} B; "
            f"bytes of the last step, rank 0: {r['wire']}; rank 1: "
            f"{r1['wire']}; [{smi}]")
        if not np.isfinite(r["losses"] + [r["grad_norm"]]).all() or \
                r["losses"] != r1["losses"]:
            raise AssertionError(f"12 {cfg.name}: losses {r['losses']} "
                                 f"vs {r1['losses']}")
        if r["wire"].get("all-gather/data", 0):
            raise AssertionError("12: a gather along data on a data "
                                 "axis of one rank")
        # the dry-run's count of this step (remat "layer": the recompute's
        # all-reduces included) against the bytes each rank moved, and
        # the weights it gathered along model against the plan's
        plan = {k: v for k, v in analysis.plan_collective_bytes(
            cfg, sizes, "train", tokens=tokens,
            seq=seq)["by_axis"].items() if k.endswith("/model")}
        want = plan_exceptions(cfg, sizes)
        log(f"  {tag}: the dry-run's plan of this step along model "
            f"(analysis.plan_collective_bytes): {plan}; moved by rank 0 "
            f"{ {k: r['wire'].get(k) for k in plan} }, by rank 1 "
            f"{ {k: r1['wire'].get(k) for k in plan} } (the plan leaves out "
            f"the scalars and the loss's last position of each row: bound "
            f"{TP_PLAN_SLACK} B); gathered along model {want}, the plan's "
            "exceptions")
        for x in (r, r1):
            got = {k: x["wire"][k] for k in x["wire"] if k.endswith("/model")}
            if set(plan) != set(got) or any(
                    abs(got[k] - v) > (TP_PLAN_SLACK if k.startswith(
                        "all-reduce") else 0) for k, v in plan.items()):
                raise AssertionError(f"12 {cfg.name}: the plan's count "
                                     f"{plan} is not the step's {got}")
            if x["wire"]["model_gathered"] != want:
                raise AssertionError(
                    f"12 {cfg.name}: gathered along model "
                    f"{x['wire']['model_gathered']}, the plan names {want}")
    for launches in (res["launches"], res1["launches"]):
        if any(launches.values()):
            raise AssertionError(f"12 launched a kernel: {launches}")
    log("  12a-12b, 12d launched none of the six kernels: "
        + json.dumps(res["launches"]))
    for cfg in exact:
        e = {k: max(res["exact"][cfg.name][k], res1["exact"][cfg.name][k])
             for k in res["exact"][cfg.name]}
        dl = max(abs(r["exact"][cfg.name]["loss"]
                     - r["exact"][cfg.name]["rep_loss"]) for r in (res, res1))
        log(f"  12c: {cfg.name} at full width, {cfg.n_layers} layers "
            f"{cfg.segments}, fp32, TF32 off, one step of "
            f"{TP_EXACT['batch']} x {TP_EXACT['seq']} tokens split over "
            f"{TP['ranks']} ranks vs the one-rank replicated step: loss "
            f"{e['loss']:.6f} vs {e['rep_loss']:.6f} (diff {dl:.3e}, bound "
            f"{TP_LOSS_ATOL:.0e}); gradients from m max abs diff "
            f"{e['grad']:.3e}, from v {e['grad_v']:.3e} (bound "
            f"{GRAD_ATOL:.0e}; largest gradient {e['gmax']:.4f}); weights "
            f"{e['params']:.3e} (bound {2 * TP_EXACT['lr']:.0e}); each rank "
            "holds its own shards against the same pieces of a replicated "
            "step it runs beside")
        if (dl > TP_LOSS_ATOL or e["grad"] > GRAD_ATOL
                or e["grad_v"] > GRAD_ATOL
                or e["params"] > 2 * TP_EXACT["lr"]):
            raise AssertionError(f"12c {cfg.name}: the split step differs "
                                 "from the replicated one")
    log(f"  phase 12 took {time.perf_counter() - t0:.1f} s (rank 0 from its "
        "process group up: " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                          res["times"].items()) + ")")


# ----------------------------------------------------------------- phase 13
#: 13a-13b, 13d: two ranks on the card, mesh (data, model) = (1, 2),
#: bf16, a prefill of ``batch`` x ``prompt`` tokens then ``steps`` greedy
#: steps (``arch_steps`` where an arch takes fewer: each hymba-1.5b step
#: gathers 524 MB of its weights along "model" through host copies, ~2 s
#: on two ranks of one card, PERF.md §6); ``depth``: the layers each arch
#: keeps (None: all)
SERVE_TP = dict(ranks=2, batch=4, prompt=256, steps=32,
                arch_steps={"hymba-1.5b": 8},
                depth={"qwen3-8b": None, "deepseek-moe-16b": 3,
                       "xlstm-1.3b": None, "hymba-1.5b": None})
#: 13c, fp32 with TF32 off, each against the one-rank steps each rank runs
#: beside: (arch, mesh (data, model), rows, prompt (0: decode from an
#: empty cache), decode steps, cache length).  deepseek-moe-16b on (1, 2)
#: decodes expert-parallel (32 of 64 experts a rank); on (2, 1) its 4 rows
#: of 16 tokens fall back to one dispatch group in the prefill (64 tokens
#: over 2 groups: 32 x 1.25 < 64 experts) and in every decode step, as
#: the reference's do (2 steps: each gathers every fp32 weight over data
#: through host copies); hymba-1.5b's one row splits its 24 slots over
#: data, 12 a rank, so positions 0-11 land in rank 0's run and 12-16 in
#: rank 1's, and both add to the softmax merge from step 13 on; on (1, 2)
#: xlstm-1.3b (an mLSTM split by heads, an sLSTM by channels) and
#: hymba-1.5b (its Mamba by channels) carry split states through the
#: prefill and 8 steps
SERVE_EXACT = [("qwen3-8b", (1, 2), 4, 64, 8, 96),
               ("deepseek-moe-16b", (1, 2), 4, 64, 8, 96),
               ("deepseek-moe-16b", (2, 1), 4, 16, 2, 48),
               ("hymba-1.5b", (2, 1), 1, 0, 16, 24),
               ("xlstm-1.3b", (1, 2), 4, 64, 8, 96),
               ("hymba-1.5b", (1, 2), 4, 64, 8, 96)]
SERVE_EXACT_DEPTH = 2
#: 13c's bound on the last logits, fixed before the first run
SERVE_LOGIT_ATOL = 1e-4


def serve_tp_cfgs():
    """(runs, exact): 13a-13b's bf16 configs and 13c's fp32 ones."""
    from repro_torch.models import registry

    runs = []
    for arch, depth in SERVE_TP["depth"].items():
        cfg = registry.get_config(arch)
        runs.append(cfg if depth is None else cut_depth(cfg, depth))
    exact = [dataclasses.replace(every_kind(registry.get_config(e[0]),
                                            SERVE_EXACT_DEPTH),
                                 dtype="float32") for e in SERVE_EXACT]
    return runs, exact


def build_sharded(cfg, seed, dev, mesh, rank, world):
    """``init_params`` placed on ``mesh`` by ``shard_model``, the ranks
    taking turns (a barrier between them), so that the card never holds
    two full copies at once."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding
    from repro_torch.models.transformer import init_params

    model = None
    for r in range(world):
        if r == rank:
            model = sharding.shard_model(init_params(cfg, seed=seed,
                                                     device=dev), mesh)
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    return model


def serve_tp_rank(rank, port, out, seed, dev_type, runs, exact,
                  shapes) -> None:
    """One of phase 13's two ranks (module docstring): ``runs`` served at
    ``SERVE_TP``'s shape, ``exact`` held against the one-rank steps
    (``shapes``: the parent's ``SERVE_TP`` and ``SERVE_EXACT``); each rank
    writes its results to ``out`` (rank 1 beside it)."""
    SERVE_TP.update(shapes[0])
    SERVE_EXACT[:] = shapes[1]
    import torch.distributed as dist

    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_params, param_count
    from repro_torch.serve import steps

    on_card = dev_type == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:                  # a CPU rehearsal: nothing to synchronise or read
        for f in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
            setattr(torch.cuda, f, lambda *a, **k: None)
        torch.cuda.max_memory_allocated = lambda *a, **k: 0
        torch.set_num_threads(2)
    dev = torch.device(dev_type)
    world = SERVE_TP["ranks"]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        res = {"runs": {}, "exact": []}
        t_up = time.perf_counter()
        mesh = make_mesh((1, world), ("data", "model"), dev_type)
        B, P = SERVE_TP["batch"], SERVE_TP["prompt"]
        ops.reset_launch_counts()
        for cfg in runs:
            n = SERVE_TP["arch_steps"].get(cfg.name, SERVE_TP["steps"])
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model = build_sharded(cfg, seed, dev, mesh, rank, world)
            toks = tp_batch(cfg, B, P, seed, dev)["tokens"]
            prefill = steps.make_prefill_step(cfg, P + n)
            serve = steps.make_serve_step(cfg)
            torch.cuda.synchronize()
            sharding.reset_wire_counts()
            t0 = time.perf_counter()
            logits, cache = prefill(model, {"tokens": toks})
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            wire_prefill = sharding.wire_counts()
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
            out_toks, secs = [tok.cpu().tolist()], []
            for i in range(n):
                sharding.reset_wire_counts()
                t0 = time.perf_counter()
                tok, cache = serve(model, cache, tok, P + i)
                out_toks.append(tok.cpu().tolist())
                secs.append(time.perf_counter() - t0)
            res["runs"][cfg.name] = dict(
                prefill_s=prefill_s, secs=secs, tokens=out_toks,
                finite=bool(torch.isfinite(logits).all()),
                logits_shape=list(logits.shape),
                wire_prefill=wire_prefill, wire_decode=sharding.wire_counts(),
                peak=torch.cuda.max_memory_allocated(),
                local_params=sum(p.to_local().numel()
                                 for p in model.parameters()),
                params=param_count(model))
            del model, cache, logits
        res["launches"] = ops.launch_counts()
        res["times"] = {"13a-13b, 13d": time.perf_counter() - t_up}
        for cfg, (_, dims, rows, prompt, n_dec, L) in zip(exact,
                                                          SERVE_EXACT):
            gc.collect()
            torch.cuda.empty_cache()
            emesh = make_mesh(dims, ("data", "model"), dev_type)
            sh = sharding.shard_model(init_params(cfg, seed=seed,
                                                  device=dev), emesh)
            one = init_params(cfg, seed=seed, device=dev)
            prefill = steps.make_prefill_step(cfg, L)
            serve = steps.make_serve_step(cfg)
            r = {"logit_diff": 0.0, "equal": True}
            tallies, t_run = [], time.perf_counter()
            for model in (sh, one):
                tally = {"on": True, "slots": 0, "dropped": 0}
                with counting_drops(tally):
                    if prompt:
                        toks = tp_batch(cfg, rows, prompt, seed, dev)[
                            "tokens"]
                        logits, cache = prefill(model, {"tokens": toks})
                        tok = torch.argmax(logits[:, -1], -1).to(
                            torch.int32)
                    else:
                        cache = model.init_cache(rows, L)
                        tok = torch.full((rows,), 1 + seed, dtype=torch.int32,
                                         device=dev)
                        logits = None
                    seq = [tok.cpu().tolist()]
                    for i in range(n_dec):
                        tok, cache = serve(model, cache, tok, prompt + i)
                        seq.append(tok.cpu().tolist())
                    if logits is None:       # the next step's logits
                        logits = model.decode_step(
                            sharding.local_rows(tok) if model is sh
                            else tok, cache, prompt + n_dec)[0]
                tallies.append((tally["slots"], int(tally["dropped"]),
                                seq, logits.float().cpu()))
            (s0, d0, q0, l0), (s1, d1, q1, l1) = tallies
            r.update(slots=[s0, s1], dropped=[d0, d1], tokens=q0,
                     equal=q0 == q1 and (s0, d0) == (s1, d1),
                     logit_diff=float((l0 - l1).abs().max()),
                     secs=time.perf_counter() - t_run)
            res["exact"].append(r)
            del sh, one, cache
        res["times"]["13c"] = time.perf_counter() - t_up - res["times"][
            "13a-13b, 13d"]
        path = Path(out) if rank == 0 else Path(out).with_suffix(".rank1")
        path.write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def phase_serve_tp(dev, args, cfgs=None) -> None:
    """Phase 13 (see the module docstring).  ``cfgs`` = (runs, exact)
    replaces the configs only to rehearse the phase on the CPU."""
    from repro_torch.distributed.sharding import rows_per_rank
    from repro_torch.roofline import analysis

    t0 = time.perf_counter()
    runs, exact = cfgs if cfgs is not None else serve_tp_cfgs()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip() \
        if dev.type == "cuda" else "no card (CPU rehearsal)"
    world = SERVE_TP["ranks"]
    log(f"  13: {world} ranks on one {dev.type} device over a gloo group "
        f"(tcp://127.0.0.1), collectives of CUDA tensors through host "
        f"copies, compute on the device; card: {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "serve.json"
        spawn_ranks("phase 13", serve_tp_rank, world,
                    (free_port(), str(out), args.seed, dev.type, runs, exact,
                     (SERVE_TP, SERVE_EXACT)), timeout=600)
        res = json.loads(out.read_text())
        res1 = json.loads(out.with_suffix(".rank1").read_text())
    B, P = SERVE_TP["batch"], SERVE_TP["prompt"]
    sizes = {"data": 1, "model": world}
    for cfg in runs:
        n = SERVE_TP["arch_steps"].get(cfg.name, SERVE_TP["steps"])
        r, r1 = res["runs"][cfg.name], res1["runs"][cfg.name]
        tag = "13" + TP_TAGS.get(cfg.name, "")
        want = plan_exceptions(cfg, sizes)
        p50 = [pct(x["secs"], 50) * 1e3 for x in (r, r1)]
        p99 = [pct(x["secs"], 99) * 1e3 for x in (r, r1)]
        plans = {k: {a: v for a, v in analysis.plan_collective_bytes(
            cfg, sizes, k, tokens=rows_per_rank(B, sizes) * (
                1 if k == "decode" else P), batch=B,
            cache_len=P + n)["by_axis"].items()}
            for k in ("prefill", "decode")}
        log(f"  {tag}: {cfg.name} at full width, {cfg.n_layers} layers "
            f"({cfg.dtype}), mesh (data, model) = (1, {world}), "
            f"{r['params']} parameters, {r['local_params']} and "
            f"{r1['local_params']} held by ranks 0 and 1; prefill of {B} x "
            f"{P} tokens {r['prefill_s'] * 1e3:.3f} / "
            f"{r1['prefill_s'] * 1e3:.3f} ms (ranks 0 / 1), last logits "
            f"{r['logits_shape']} whole on each rank; {n} greedy steps: "
            f"p50 {p50[0]:.3f} / {p50[1]:.3f} ms, p99 {p99[0]:.3f} / "
            f"{p99[1]:.3f} ms (two ranks share the card's SMs: recorded, "
            f"not a speed); peak device memory {r['peak']} / {r1['peak']} "
            f"B; bytes moved by rank 0, prefill {r['wire_prefill']}, a "
            f"decode step {r['wire_decode']}; the plan's count "
            f"(analysis.plan_collective_bytes): prefill {plans['prefill']}, "
            f"decode {plans['decode']}; gathered along model {want}, the "
            f"plan's exceptions; first tokens {r['tokens'][1]}; [{smi}]")
        if not r["finite"] or r["tokens"] != r1["tokens"]:
            raise AssertionError(f"{tag} {cfg.name}: tokens differ between "
                                 "the ranks or the logits are not finite")
        if r["logits_shape"] != [B, 1, cfg.vocab]:
            raise AssertionError(f"{tag}: logits {r['logits_shape']}")
        for k in ("prefill", "decode"):
            for x in (r, r1):
                got = {a: v for a, v in x[f"wire_{k}"].items()
                       if a != "model_gathered"}
                if got != plans[k] or x[f"wire_{k}"]["model_gathered"] != \
                        want:
                    raise AssertionError(
                        f"{tag} {cfg.name} {k}: moved {x[f'wire_{k}']}, "
                        f"the plan counts {plans[k]}")
    for launches in (res["launches"], res1["launches"]):
        if any(launches.values()):
            raise AssertionError(f"13 launched a kernel: {launches}")
    log("  13a-13b, 13d launched none of the six kernels: "
        + json.dumps(res["launches"]))
    for i, (cfg, (_, dims, rows, prompt, n_dec, L)) in enumerate(
            zip(exact, SERVE_EXACT)):
        e, e1 = res["exact"][i], res1["exact"][i]
        diff = max(e["logit_diff"], e1["logit_diff"])
        log(f"  13c: {cfg.name} at full width, {cfg.n_layers} layers, "
            f"fp32, TF32 off, mesh (data, model) = {tuple(dims)}, {rows} "
            f"rows, " + (f"a prefill of {prompt} tokens" if prompt
                         else "from an empty cache") + f", {n_dec} greedy "
            f"steps, cache {L}: vs the one-rank steps each rank runs "
            f"beside, tokens equal {e['equal'] and e1['equal']}, last "
            f"logits max abs diff {diff:.3e} (bound "
            f"{SERVE_LOGIT_ATOL:.0e}); MoE slots routed / dropped, sharded "
            f"vs one rank: {e['slots']} / {e['dropped']}; tokens "
            f"{e['tokens'][-1]}; both paths {e['secs']:.1f} s (every "
            "weight's data gathers through host copies)")
        if not (e["equal"] and e1["equal"]) or diff > SERVE_LOGIT_ATOL \
                or e["tokens"] != e1["tokens"]:
            raise AssertionError(f"13c {cfg.name}: the sharded steps differ "
                                 "from the one-rank steps")
    log(f"  phase 13 took {time.perf_counter() - t0:.1f} s (rank 0 from its "
        "process group up: " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                          res["times"].items()) + ")")


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

    wl1 = make_workload("insert-heavy", preload=preload,
                        key_space=key_space, n_ops=1 << 18, batch_size=4096,
                        seed=2)
    trace1 = make_trace(wl1, PoissonArrivals(rate))
    wl2 = make_workload("insert-heavy", preload=0, key_space=key_space,
                        n_ops=1 << 16, batch_size=4096, seed=3)
    trace2 = make_trace(wl2, PoissonArrivals(rate))
    # commit_ops 64; the fsync's wall time is charged to the frontend's
    # clock, so a queue bound below the trace would shed more ops the
    # slower the disk is, and with them the commits the crash point and
    # the profiled window count on.  A bound that holds the whole trace
    # makes the number of commits (>= n_ops / 64) independent of the disk.
    cfg = FrontendConfig(max_queue=max(len(trace1), len(trace2)))
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
        log("  trace 2 profiled commits 256..767: "
            + busy_text(prof, window[1] - window[0]))
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
    # each tenant's bound holds its whole trace, as in phase 6: the commits
    # the crash point and the window count on must not hang on the disk
    tenants = [dataclasses.replace(t, max_queue=len(traces[t.tenant_id]))
               for t in tenants]
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
        tally = _DispatchTally()

        def counted_apply(batch):
            if fe.preload_wall_s and not calls["commits"]:
                eng.attach_tracer(tally)    # per-impl wall times
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
        per_impl = {k: (v["count"], v["wall_s"])
                    for k, v in tally.stats.items()}
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
        busy = busy_text(prof, window[1] - window[0])
        mark("profile read")
        log(f"  7a profiled commits {w0}..{w1 - 1}: {busy}")

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


def check_launches(rows: dict, paths: dict) -> None:
    """Each of phase 1's kernels must have launched on its own path (its
    row gets those launches), and each path's kernels on that path; a path
    left out of ``paths`` is not checked."""
    for name_k, row in rows.items():
        path = KERNEL_PATH.get(name_k, "nbtree")
        if path not in paths:
            continue
        row["launches"] = paths[path][name_k]
        row["launches_by_path"] = {p: c[name_k] for p, c in paths.items()
                                   if c.get(name_k)}
        if not row["launches"]:
            raise AssertionError(f"{name_k} never launched on the {path} path")
    for path, names in (("eager", EAGER_KERNELS),
                        ("archs", ARCH_KERNELS), ("variants", ARCH_KERNELS),
                        ("ingest", INGEST_KERNELS),
                        ("tenancy", TENANCY_KERNELS)):
        for name_k in names if path in paths else ():
            if not paths[path][name_k]:
                raise AssertionError(
                    f"{name_k} never launched on the {path} path")


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
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    # fp32 matmuls and convolutions in full fp32 (phase 5 compares tokens)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}"
        f"; rates of the {card_rates()['variant']} (roofline/hardware.py): "
        f"{card_rates()['hbm_bw']:.4g} B/s, {card_rates()['fp32_ops']:.4g} "
        "fp32 op/s")
    tmp = tempfile.TemporaryDirectory()
    variants = build_kernels(tmp.name)

    log("phase 1: kernels vs their plain versions on the card")
    try:
        rows = phase_kernels(dev, variants)
    finally:
        tmp.cleanup()
    log("phase 2+3: NB-tree path through TorchNBTreeEngine, checked by an oracle")
    paths = {}
    paths["nbtree"], nbtree_stats = phase_main_path(dev, args)
    log("launches on the NB-tree path: " + json.dumps(paths["nbtree"]))
    log("phase 3b: the eager write path (fused=False) beside the fused one, "
        "one stream into both, bit for bit")
    t3b = time.perf_counter()
    paths["eager"] = phase_eager(dev)
    log(f"launches on the eager path: {json.dumps(paths['eager'])}; phase 3b "
        f"took {time.perf_counter() - t3b:.1f} s")
    log("phase 4: qwen3-8b served at full width through the paged-KV engine")
    paths["serve"] = phase_serve(dev, args)
    log("phase 5: engine vs contiguous decode, exact tokens")
    phase_exact(dev, args)
    log("phase 8: the attention-backbone archs (gemma-2b, starcoder2-3b, "
        "deepseek-moe-16b, minicpm3-4b, mixtral-8x22b cut to 4 layers)")
    t8 = time.perf_counter()
    paths["archs"] = phase_archs(dev, args)
    log(f"launches on the archs path (8a-8b): {json.dumps(paths['archs'])}; "
        f"phase 8 took {time.perf_counter() - t8:.1f} s")
    log("phase 9: the remaining archs (qwen2-vl-2b, xlstm-1.3b, hymba-1.5b, "
        "hubert-xlarge) and the attention variants")
    t9 = time.perf_counter()
    paths["variants"] = phase_variants(dev, args)
    log(f"launches on the variants path (9a): "
        f"{json.dumps(paths['variants'])}; phase 9 took "
        f"{time.perf_counter() - t9:.1f} s")
    log("phase 10: training on the card (gemma-2b at full width and depth "
        "through the train CLI; the loss on a repeated batch; card vs CPU; "
        "a checkpoint restart)")
    t10 = time.perf_counter()
    paths["train"] = phase_train(dev, args)
    log(f"phase 10 took {time.perf_counter() - t10:.1f} s")
    log("phase 11: the sharded train step (one-rank NCCL mesh vs the "
        "replicated step), elastic resize, the meta dry-run of every cell, "
        "the measured impl table")
    t11 = time.perf_counter()
    paths["sharded"] = phase_sharded(dev, args, nbtree_stats)
    log(f"phase 11 took {time.perf_counter() - t11:.1f} s")
    log("phase 12: the sharded step split over model (tensor and expert "
        "parallelism, the recurrent cells by head, value column or "
        "channel), two ranks on the card: gemma-2b, deepseek-moe-16b, "
        "xlstm-1.3b and hymba-1.5b at full width, depth cut; fp32 vs the "
        "replicated step")
    gc.collect()
    torch.cuda.empty_cache()
    phase_tp(dev, args)
    log("phase 13: sharded serving, two ranks on the card: qwen3-8b, "
        "xlstm-1.3b and hymba-1.5b at full width and depth and "
        "deepseek-moe-16b at 3 layers through the prefill and greedy steps "
        "of serve/steps.py over (data, model) = (1, 2); fp32 vs the "
        "one-rank steps")
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_tp(dev, args)
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
    check_launches(rows, paths)
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s, every phase "
        "passed")
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
