"""Decode attention over a paged KV cache: CUDA kernel
(``csrc/paged_attention.cu``) and plain version.

Replaces the Pallas ``_paged_attn_kernel`` (``repro/kernels/
paged_attention.py:35``, ``pl.pallas_call`` at :95): one query token per
sequence, flash-decoding over the pages that ``block_tables`` names (the
NB-tree page index builds the tables, ``serve/kv_cache.py``).  Shapes, with
G query heads per KV head and S slots per page::

    q             (B, KVH, G, D)   fp32 or bf16
    k_pages       (KVH, P, S, D)   fp32 or bf16, contiguous (a layer of
    v_pages       (KVH, P, S, D)   the cache's (L, KVH, P, S, D) tensor is)
    block_tables  (B, MP) int32    logical page p of b -> physical page
    seq_lens      (B,)    int32
    out           (B, KVH, G, D)   q's dtype

Slots at or past ``seq_lens[b]`` score -1e30, a finite value, as in the
Pallas kernel.  So a sequence of length 0 gets the mean of V over all
``MP * S`` gathered slots, not NaN as ``repro.kernels.ref.
paged_attention_ref`` gives: the port reproduces the kernel.  A page id
outside ``[0, P)`` raises before anything is read.

What bounds it on the H100: bytes.  Every K and V element of the named
pages is read once (fp32 pages at the serving shapes: 9.4 MB, whose bound
is 2.8 us on an H100 SXM at 3.35 TB/s), against ~2 flops per byte.  The
kernel splits each sequence's pages over NS CTAs (split-K, flash-decoding;
NS from B, KVH and MP so that the grid fills the SMs), and each CTA holds
up to 8 query heads of its KV head (all G = 4 of them when serving), so a
page is read from device memory once.  A CTA stages its pages into shared
memory with 16-byte ``cp.async`` in a ring of three chunks, two in flight
while one is used; each warp keeps its own online-softmax state in
registers over blocks of 4 slots, so a chunk has no barrier of its own.
Each split leaves its partial state (m, l, acc) in a workspace; the last
CTA of each (b, kv head, head group), found by an atomic ticket, combines
them, so a call is one launch.  What is left: the dot products run on the
CUDA cores (``wgmma`` does not pay at G = 4 rows), and a CTA waits two
dependent device-memory round trips before it computes.  The page storage
must be 16-byte aligned, a page (S*D elements) a multiple of 16 bytes and
D a multiple of 32 up to 256: a layer of the cache is at every served
shape, and anything else raises.
"""
from __future__ import annotations

import math
import weakref

import torch

from . import _build

NEG_INF = -1e30

launches = {"paged_attention": 0}

#: the last block table found in range: (weak ref, its version, P).  The
#: decoder hands one table to every layer of a step, so the range check
#: (a device-to-host read) runs once per step, not once per launch.
_checked: list = [None]


def _check_tables(block_tables, P: int) -> None:
    last = _checked[0]
    if (last is not None and last[0]() is block_tables
            and last[1] == block_tables._version and last[2] == P):
        return
    if block_tables.numel():
        lo, hi = (int(x) for x in torch.aminmax(block_tables))
        if lo < 0 or hi >= P:
            raise IndexError(f"paged_attention: page ids in [{lo}, {hi}] "
                             f"outside [0, {P})")
    _checked[0] = (weakref.ref(block_tables), block_tables._version, P)


def paged_attention_plain(q, k_pages, v_pages, block_tables, seq_lens):
    """Gather the named pages, mask with -1e30, fp32 softmax: the Pallas
    kernel's result (its per-page online softmax reaches the same values)."""
    B, KVH, G, D = q.shape
    _, P, S, _ = k_pages.shape
    MP = block_tables.shape[1]
    _check_tables(block_tables, P)
    bt = block_tables.long()

    def gather(pages):             # (KVH, B, MP, S, D) -> (B, KVH, MP*S, D)
        return pages[:, bt].transpose(0, 1).reshape(B, KVH, MP * S, D).float()

    s = torch.einsum("bhgd,bhtd->bhgt", q.float(), gather(k_pages))
    s = s * (1.0 / (D ** 0.5))
    slot = torch.arange(MP * S, device=q.device)
    s = torch.where(slot < seq_lens.long()[:, None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgt,bhtd->bhgd", p, gather(v_pages)).to(q.dtype)


_FLOATS = (torch.float32, torch.bfloat16)

#: per device, the split-K tickets: one counter per (b, kv head, head
#: group), zero between launches (the last CTA of each resets its own)
_ticket_buffers: dict = {}


def _tickets(dev, n: int):
    buf = _ticket_buffers.get(dev)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
        _ticket_buffers[dev] = buf
    return buf


#: per device, the split-K workspace (each split's m, l and acc); launches
#: on one stream use it in turn, so it only grows
_workspaces: dict = {}


def _workspace(dev, n: int):
    buf = _workspaces.get(dev)
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, 1), dtype=torch.float32, device=dev)
        _workspaces[dev] = buf
    return buf


#: split count per (kernel library, B, KVH, MP): the launcher's rule, asked
#: of the library once per shape (a swept variant's rule may differ)
_split_counts: dict = {}


def _splits(B: int, KVH: int, MP: int) -> int:
    lib = _build.library()
    key = (lib, B, KVH, MP)
    if key not in _split_counts:
        _split_counts[key] = lib.paged_attention_splits(B, KVH, MP)
    return _split_counts[key]


def check_alignment(k_pages, v_pages) -> None:
    """Raise unless the kernel's 16-byte copies fit: both page tensors start
    on a 16-byte boundary and a page (S*D elements) is a multiple of 16
    bytes.  No narrower copy stands in."""
    _, _, S, D = k_pages.shape
    page_bytes = S * D * k_pages.element_size()
    if page_bytes % 16 or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(
            f"paged_attention: pages are copied in 16-byte units: a page of "
            f"{page_bytes} bytes and storage at {k_pages.data_ptr() % 16} / "
            f"{v_pages.data_ptr() % 16} bytes past a 16-byte boundary")


def paged_attention_cuda(q, k_pages, v_pages, block_tables, seq_lens):
    dev = q.device
    if q.dtype not in _FLOATS or k_pages.dtype not in _FLOATS:
        raise TypeError(f"paged_attention: q {q.dtype} / pages {k_pages.dtype}"
                        " must be float32 or bfloat16")
    _build.require("q", q, q.dtype, 4)
    _build.require("k_pages", k_pages, k_pages.dtype, 4, dev)
    _build.require("v_pages", v_pages, k_pages.dtype, 4, dev)
    _build.require("block_tables", block_tables, torch.int32, 2, dev)
    _build.require("seq_lens", seq_lens, torch.int32, 1, dev)
    B, KVH, G, D = q.shape
    _, P, S, _ = k_pages.shape
    MP = block_tables.shape[1]
    if (k_pages.shape != v_pages.shape or k_pages.shape[0] != KVH
            or k_pages.shape[3] != D):
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, k_pages "
                         f"{tuple(k_pages.shape)}, v_pages "
                         f"{tuple(v_pages.shape)} do not agree")
    if D % 32 or D > 256:
        raise ValueError(f"paged_attention: the kernel takes D in 4-wide "
                         f"pieces, at most two a lane: D = {D} must be a "
                         f"multiple of 32 and at most 256")
    if block_tables.shape[0] != B or seq_lens.shape != (B,):
        raise ValueError("paged_attention: block_tables / seq_lens batch "
                         "differs from q's")
    check_alignment(k_pages, v_pages)
    _check_tables(block_tables, P)
    out = torch.empty_like(q)
    if q.numel():
        splits = _splits(B, KVH, MP)
        ws = _workspace(dev, B * KVH * splits * G * (D + 2) if splits > 1 else 0)
        _build.launch("paged_attention_launch", dev, q.data_ptr(),
                      k_pages.data_ptr(), v_pages.data_ptr(),
                      block_tables.data_ptr(), seq_lens.data_ptr(),
                      out.data_ptr(), ws.data_ptr(),
                      _tickets(dev, B * KVH * -(-G // 4)).data_ptr(), B, KVH,
                      G, D, P, S, MP, 1.0 / math.sqrt(D),
                      int(q.dtype == torch.bfloat16),
                      int(k_pages.dtype == torch.bfloat16))
        launches["paged_attention"] += 1
    return out
