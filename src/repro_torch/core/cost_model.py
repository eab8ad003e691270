"""Explicit external-memory I/O cost model (paper Sec. 2, "Performance
Metrics"); the port's copy of ``repro/core/cost_model.py``.

The paper measures every index in *time* = seek time + sequential transfer
time over all disk accesses of an operation.  This module implements that
accounting exactly, with the paper's own device constants (Seagate 7200rpm
HDD from [41] and a Crucial-MX500-class SSD), so that the paper's figures
(Figs. 4-9) and tables (1-2) can be reproduced deterministically on any host.
The host tiers (``refimpl``) charge it; the ingest frontend charges WAL
fsyncs and snapshots on its device constants.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager

#: bytes per key / value / pair — the paper's workload (Sec. 6.1).
KEY_BYTES = 8
VALUE_BYTES = 128
PAIR_BYTES = KEY_BYTES + VALUE_BYTES


@dataclasses.dataclass(frozen=True)
class Device:
    """Secondary-storage device constants."""

    name: str
    page_bytes: int
    seek_s: float          # T_seek
    read_bw: float         # bytes/s sequential read
    write_bw: float        # bytes/s sequential write

    @property
    def pairs_per_page(self) -> int:
        return max(1, self.page_bytes // PAIR_BYTES)


#: 7200rpm, 125 MB/s, 8.5 ms seek — the constants the paper quotes from [41].
HDD = Device("hdd", page_bytes=4096, seek_s=8.5e-3, read_bw=125e6, write_bw=125e6)
#: SATA SSD in the Crucial MX500 class used by the paper's testbed.
SSD = Device("ssd", page_bytes=4096, seek_s=1.0e-4, read_bw=520e6, write_bw=450e6)


class CostModel:
    """Mutable accumulator of simulated I/O time.

    ``cost`` (page accesses) and ``time`` (seconds) follow the paper's
    terminology: *cost* counts pages, *time* adds seek + sequential terms.
    """

    def __init__(self, device: Device = HDD):
        self.device = device
        self.reset()

    def reset(self) -> None:
        self.seeks = 0
        self.bytes_read = 0
        self.bytes_written = 0
        self.pages = 0

    # -- elementary operations -------------------------------------------------
    def seek(self, n: int = 1) -> float:
        self.seeks += n
        return n * self.device.seek_s

    def seq_read(self, nbytes: int) -> float:
        self.bytes_read += nbytes
        self.pages += -(-nbytes // self.device.page_bytes)
        return nbytes / self.device.read_bw

    def seq_write(self, nbytes: int) -> float:
        self.bytes_written += nbytes
        self.pages += -(-nbytes // self.device.page_bytes)
        return nbytes / self.device.write_bw

    def read_pairs(self, npairs: int) -> float:
        return self.seq_read(npairs * PAIR_BYTES)

    def write_pairs(self, npairs: int) -> float:
        return self.seq_write(npairs * PAIR_BYTES)

    def page_read(self, n: int = 1) -> float:
        """A random single-page read: seek + one sequential page."""
        return self.seek(n) + self.seq_read(n * self.device.page_bytes)

    # -- totals ----------------------------------------------------------------
    @property
    def time(self) -> float:
        return (
            self.seeks * self.device.seek_s
            + self.bytes_read / self.device.read_bw
            + self.bytes_written / self.device.write_bw
        )

    @contextmanager
    def measure(self):
        """Measure the simulated time of one operation.

        >>> cm = CostModel()
        >>> with cm.measure() as t:
        ...     cm.seek(); cm.seq_read(4096)
        >>> t.seconds  # doctest: +ELLIPSIS
        0.0085...
        """
        before = self.time

        class _T:
            seconds = 0.0

        t = _T()
        try:
            yield t
        finally:
            t.seconds = self.time - before
