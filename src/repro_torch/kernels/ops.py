"""The one dispatch point for the hand-written kernels.

A CPU tensor goes to the kernel's plain PyTorch version, a CUDA tensor to
the hand-written CUDA kernel; any other device raises.  There is no
fallback: a kernel that fails to build or launch raises on the card.  The
CUDA wrappers count their launches (``launch_counts``), so a run can show
that its main path went through the kernels.

Bloom build and update have no Pallas kernel in the JAX package (XLA runs
them); the port gives them a CUDA kernel of their own all the same
(``bloom_filter.py``), since their plain chain of ~90 small passes cost the
write path more host time than any other part of it.
"""
from __future__ import annotations

from . import bloom_filter as _bf
from . import merge_sorted as _ms
from . import paged_attention as _pa
from . import range_scan as _rs
from . import sorted_search as _ss

_MODULES = (_ms, _ss, _bf, _rs, _pa)


def _on_card(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def merge_sorted(a_keys, a_vals, b_keys, b_vals):
    """(n,) + (m,) sorted runs -> merged (n_pad + m_pad,); a first on ties."""
    fn = _ms.merge_sorted_cuda if _on_card(a_keys) else _ms.merge_sorted_plain
    return fn(a_keys, a_vals, b_keys, b_vals)


def merge_sorted_batch(a_keys, a_vals, b_keys, b_vals):
    """R pairs of sorted runs merged in one launch (fused-flush fan-out)."""
    fn = (_ms.merge_sorted_batch_cuda if _on_card(a_keys)
          else _ms.merge_sorted_plain)
    return fn(a_keys, a_vals, b_keys, b_vals)


def sorted_search(run_keys, run_vals, queries):
    fn = (_ss.sorted_search_cuda if _on_card(run_keys)
          else _ss.sorted_search_plain)
    return fn(run_keys, run_vals, queries)


def sorted_search_rows(table_keys, table_vals, rows, counts, queries):
    fn = (_ss.sorted_search_rows_cuda if _on_card(table_keys)
          else _ss.sorted_search_rows_plain)
    return fn(table_keys, table_vals, rows, counts, queries)


def bloom_probe(words, queries, *, nbits: int, h: int = 3):
    fn = _bf.bloom_probe_cuda if _on_card(words) else _bf.bloom_probe_plain
    return fn(words, queries, nbits=nbits, h=h)


def bloom_probe_rows(bloom_table, rows, queries, *, nbits: int, h: int = 3):
    fn = (_bf.bloom_probe_rows_cuda if _on_card(bloom_table)
          else _bf.bloom_probe_rows_plain)
    return fn(bloom_table, rows, queries, nbits=nbits, h=h)


def range_scan(run_keys, run_vals, lo, hi, *, max_results: int = 128):
    fn = _rs.range_scan_cuda if _on_card(run_keys) else _rs.range_scan_plain
    return fn(run_keys, run_vals, lo, hi, max_results=max_results)


def range_scan_rows(table_keys, table_vals, nodes, counts, lo, hi, cap: int):
    fn = (_rs.range_scan_rows_cuda if _on_card(table_keys)
          else _rs.range_scan_rows_plain)
    return fn(table_keys, table_vals, nodes, counts, lo, hi, cap)


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens):
    """Decode attention over the pages ``block_tables`` names (serving)."""
    fn = (_pa.paged_attention_cuda if _on_card(q)
          else _pa.paged_attention_plain)
    return fn(q, k_pages, v_pages, block_tables, seq_lens)


def bloom_build(keys, nbits: int, h: int = 3):
    """Filter build over one run ``(N,)`` or a batch of runs ``(R, N)``."""
    fn = _bf.bloom_build_cuda if _on_card(keys) else _bf.bloom_build_plain
    return fn(keys, nbits, h)


def bloom_update(words, keys, nbits: int, h: int = 3):
    """OR a batch's bits into ``words``: O(batch), bit-identical to a rebuild."""
    fn = _bf.bloom_update_cuda if _on_card(words) else _bf.bloom_update_plain
    return fn(words, keys, nbits, h)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: n for mod in _MODULES for name, n in mod.launches.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES:
        for name in mod.launches:
            mod.launches[name] = 0
