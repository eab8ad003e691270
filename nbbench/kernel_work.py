"""What each hand-written kernel launch must move and compute, and the least
time the card could take for it.

Least time = max(bytes / HBM bandwidth, ops / integer op rate), against the
published H100 peaks (:data:`H100`).  Bytes count each live input element
read once and each output written once; padding does not count, since the
kernels' padded lengths would otherwise read over 100%.  The counts are
taken from each launch's arguments and live counts on the device, without a
host sync, and summed once the window has closed (:class:`KernelWork`).

The arithmetic is copied from ``chip_smoke.py`` (``merge_ops``,
``search_bound_ms``, ``bloom_bound_ms``, ``range_work``), rewritten for the
launches the program makes.  A kernel's roofline share is then its launches'
least time over their device time in the profiler's trace.
"""
from __future__ import annotations

import math

import numpy as np
import torch

#: Frozen copy of ``repro_torch/roofline/hardware.py::H100`` (NVIDIA's H100
#: data sheet, dense rates): HBM bytes/s and the non-tensor fp32 op/s, which
#: stands in for integer ops as in the program's kernel bounds.
H100 = {
    "H100 SXM": {"hbm_bw": 3.35e12, "int_ops": 67e12},
    "H100 PCIe": {"hbm_bw": 2.0e12, "int_ops": 51e12},
}

#: the key that pads runs and rows (``repro_torch/kernels/ref.py::KEY_MAX32``)
KEY_MAX = 0xFFFFFFFF
#: ``MS_T`` and ``MS_W`` of ``merge_sorted.cu`` (outputs a tile, staged width)
MERGE_T, MERGE_E, MERGE_W = 512, 4, 128

#: program kernel entry point -> the name its kernel has in a device trace
KERNEL_NAMES = {
    "merge_sorted": "merge_tile_kernel",
    "merge_sorted_batch": "merge_tile_kernel",
    "sorted_search_rows": "search_rows_kernel",
    "bloom_probe_rows": "probe_rows_kernel",
    "range_scan_rows": "range_scan_rows_kernel",
}


def peaks(device_name: str) -> dict:
    """The H100 entry of a card by its name ("... PCIe" or else SXM)."""
    return H100["H100 PCIe" if "PCIe" in device_name else "H100 SXM"]


def merge_ops(out_n):
    """Integer ops of the merge kernel for ``out_n`` outputs (6 a
    compare-and-step): per tile 2 x 32 probes, per thread a binary search
    over its staged spans, per output one merge step.  Copied from
    ``chip_smoke.py::merge_ops``."""
    search = math.ceil(math.log2(MERGE_T + 4 * MERGE_W + 2))
    return 6 * (out_n / MERGE_T * 64 + out_n / MERGE_E * search + out_n)


def merge_work(pairs) -> tuple:
    """(bytes, ops) of one merge launch over ``pairs`` live pairs of both
    sides: each read once and written once, 12 bytes a pair."""
    return 24 * pairs, merge_ops(pairs)


def search_work(bits, n_queries) -> tuple:
    """(bytes, ops) of one ``sorted_search_rows`` launch: 8 bytes a key its
    binary search reads (``ceil(log2(count + 1)) + 1`` a query, which is the
    count's bit length plus one), plus each query's row, count, key and
    outputs (``chip_smoke.py::search_bound_ms``).  ``bits`` is the sum of
    the queries' counts' bit lengths."""
    reads = bits + n_queries
    return 8 * reads + n_queries * (4 + 8 + 4 + 4 + 1 + 4 + 4), 6 * reads


def bloom_work(n_queries, h: int) -> tuple:
    """(bytes, ops) of one ``bloom_probe_rows`` launch: each query's row,
    key, output and h words once, ~12 integer ops a hash
    (``chip_smoke.py::bloom_bound_ms``)."""
    return n_queries * (h * 8 + 8 + 4 + 1), n_queries * h * 12


def range_work(bits, gathered, n_queries, n_cand, cap) -> tuple:
    """(bytes, ops) of one ``range_scan_rows`` launch over ``n_cand``
    candidate runs of ``n_queries`` queries: 8 bytes a key of both bounds'
    searches, each matched pair gathered once (``gathered``, capped at
    ``cap`` a candidate), the candidates' inputs, and every output slot
    written once (``chip_smoke.py::range_work``)."""
    reads = 2 * (bits + n_cand)
    nbytes = (8 * reads + 12 * gathered + n_cand * (4 + 4 + 4)
              + n_queries * 16 + n_cand * cap * 12)
    return nbytes, 6 * reads + n_cand * cap * 3


def bit_lengths(counts) -> torch.Tensor:
    """Sum of the counts' bit lengths, on the counts' device (frexp's
    exponent of a count is its bit length; 0 for 0)."""
    return torch.frexp(counts.to(torch.float32))[1].sum()


def live_pairs(*runs) -> torch.Tensor:
    """Live pairs of sorted KEY_MAX-padded runs, on their device."""
    return sum((keys != KEY_MAX).sum() for keys in runs)


class KernelWork:
    """Wraps the program's kernel entry points (``repro_torch.kernels.ops``)
    while active and keeps, per launch and on the device, the few numbers
    its work depends on (live pairs, searched counts' bit lengths, matched
    pairs), with no host sync: a handful of small kernels a launch.  The
    wrappers call the originals unchanged; ``least_time_s()`` copies the
    numbers to the host once, after the window, and does the arithmetic
    there."""

    def __init__(self, ops_module, rates: dict):
        self.ops = ops_module
        self.rates = rates
        self.records: dict = {name: [] for name in KERNEL_NAMES}
        self._orig: dict = {}

    def __enter__(self):
        ops, rec = self.ops, self.records
        orig = self._orig = {name: getattr(ops, name) for name in KERNEL_NAMES}

        def merge_sorted(a_keys, a_vals, b_keys, b_vals):
            rec["merge_sorted"].append((live_pairs(a_keys, b_keys),))
            return orig["merge_sorted"](a_keys, a_vals, b_keys, b_vals)

        def merge_sorted_batch(a_keys, a_vals, b_keys, b_vals):
            rec["merge_sorted_batch"].append((live_pairs(a_keys, b_keys),))
            return orig["merge_sorted_batch"](a_keys, a_vals, b_keys, b_vals)

        def sorted_search_rows(table_keys, table_vals, rows, counts, queries):
            rec["sorted_search_rows"].append(
                (bit_lengths(counts), queries.shape[0]))
            return orig["sorted_search_rows"](table_keys, table_vals, rows,
                                              counts, queries)

        def bloom_probe_rows(bloom_table, rows, queries, *, nbits, h=3):
            rec["bloom_probe_rows"].append((queries.shape[0], h))
            return orig["bloom_probe_rows"](bloom_table, rows, queries,
                                            nbits=nbits, h=h)

        def range_scan_rows(table_keys, table_vals, nodes, counts, lo, hi,
                            cap):
            out = orig["range_scan_rows"](table_keys, table_vals, nodes,
                                          counts, lo, hi, cap)
            rec["range_scan_rows"].append(
                (bit_lengths(counts), out[2].clamp(max=cap).sum(),
                 nodes.shape[0], nodes.numel(), cap))
            return out

        for fn in (merge_sorted, merge_sorted_batch, sorted_search_rows,
                   bloom_probe_rows, range_scan_rows):
            setattr(ops, fn.__name__, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.ops, name, fn)
        return False

    def _columns(self, name: str) -> list:
        """The records of one entry point as host arrays, column by
        column (device numbers copied in one transfer a column)."""
        rows = self.records[name]
        out = []
        for col in zip(*rows):
            if isinstance(col[0], torch.Tensor):
                out.append(torch.stack(col).double().cpu().numpy())
            else:
                out.append(np.asarray(col, np.float64))
        return out

    def least_time_s(self) -> dict:
        """Per entry point: (launches, summed least time in seconds)."""
        work = {"merge_sorted": merge_work, "merge_sorted_batch": merge_work,
                "sorted_search_rows": search_work,
                "bloom_probe_rows": bloom_work,
                "range_scan_rows": range_work}
        out = {}
        for name, rows in self.records.items():
            if not rows:
                out[name] = (0, 0.0)
                continue
            nbytes, nops = work[name](*self._columns(name))
            least = np.maximum(nbytes / self.rates["hbm_bw"],
                               nops / self.rates["int_ops"])
            out[name] = (len(rows), float(np.sum(least)))
        return out
