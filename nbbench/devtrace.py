"""The device's side of a traced window, from ``torch.profiler``'s trace.

``DeviceTrace`` holds the device operations of a window (kernels, copies,
sets) as ``(name, start_ns, duration_ns)``.  From them: the seconds in which
some operation ran (the union of their intervals), the device time of each
operation by name, and the idle gaps between them, labelled by what the host
was doing halfway through each.  The host side comes from spans on the host's
clock (``time.perf_counter_ns``); a marker kernel launched just after a host
reading ties the two clocks together.

The device events are read straight from the profiler's results (as
``chip_smoke.py::busy_share`` does), without parsing them into a tree of
function events, which takes tens of seconds over a window of many
thousand launches.
"""
from __future__ import annotations

import collections

import numpy as np

#: the kernel of ``torch.cuda._sleep``: the marker that aligns the clocks
MARKER = "spin_kernel"


def short_name(name: str, width: int = 80) -> str:
    """A kernel's name without ``void`` and its argument list, at most
    ``width`` characters."""
    name = name.replace("(anonymous namespace)", "anon")
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:width]


def device_events(prof) -> list:
    """``(name, start_ns, duration_ns)`` of every device operation."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def union_intervals(starts, ends) -> tuple:
    """Merged ``[start, end)`` intervals (ns) of the given ones, sorted:
    ``(starts, ends)`` arrays."""
    if not len(starts):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > e[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(s) - 1)
    return s[first], e[last]


class HostSpans:
    """Named host intervals in ``perf_counter_ns``, in layers: a time takes
    the name of the first layer (in the order added) with a span that holds
    it.  Spans of one layer do not overlap."""

    def __init__(self):
        self.layers: list = []     # [(starts, ends, names)]

    def add_layer(self, spans) -> None:
        spans = sorted(spans)
        self.layers.append((np.array([x[0] for x in spans], np.int64),
                            np.array([x[1] for x in spans], np.int64),
                            np.array([x[2] for x in spans], object)))

    def labels(self, times, default: str) -> np.ndarray:
        out = np.full(len(times), default, object)
        todo = np.ones(len(times), bool)
        for starts, ends, names in self.layers:
            if not len(starts):
                continue
            i = np.searchsorted(starts, times, "right") - 1
            hit = todo & (i >= 0)
            hit[hit] = times[hit] < ends[i[hit]]
            out[hit] = names[i[hit]]
            todo &= ~hit
        return out


class DeviceTrace:
    """The device operations inside one traced window."""

    def __init__(self, events, t0_ns: int, t1_ns: int, offset_ns=None):
        """``events``: ``(name, start_ns, duration_ns)``; ``t0_ns``/``t1_ns``
        bound the window on the host clock; ``offset_ns`` is device clock
        minus host clock (None: unknown, the window is then the span of the
        events themselves)."""
        events = [e for e in events if MARKER not in e[0]]
        names = [e[0] for e in events]
        starts = np.array([e[1] for e in events], np.int64)
        ends = starts + np.array([e[2] for e in events], np.int64)
        self.offset = offset_ns
        if offset_ns is not None:
            lo, hi = t0_ns + offset_ns, t1_ns + offset_ns
            keep = (starts < hi) & (ends > lo)
            starts = np.maximum(starts[keep], lo)
            ends = np.minimum(ends[keep], hi)
            names = [n for n, k in zip(names, keep) if k]
        elif len(starts):
            lo, hi = int(starts.min()), int(ends.max())
        else:
            lo = hi = 0
        self.lo, self.hi = lo, hi
        self.window_s = (t1_ns - t0_ns) / 1e9
        self.busy = union_intervals(starts, ends)
        self._by_name: collections.Counter = collections.Counter()
        for name, d in zip(names, (ends - starts).tolist()):
            self._by_name[name] += d

    @property
    def busy_s(self) -> float:
        return float((self.busy[1] - self.busy[0]).sum()) / 1e9

    def by_name(self) -> collections.Counter:
        """Device seconds of each operation, by its short name."""
        out: collections.Counter = collections.Counter()
        for name, d in self._by_name.items():
            out[short_name(name)] += d / 1e9
        return out

    def kernel_s(self, kernel: str) -> float:
        """Device seconds of operations whose name holds ``kernel``."""
        return sum(d for n, d in self._by_name.items() if kernel in n) / 1e9

    def idle_gaps(self, host: HostSpans, default: str = "loop") -> list:
        """``[label, seconds]`` of idle device time by what the host was
        doing halfway through each gap, largest first."""
        if self.offset is None:
            return []
        a = np.concatenate([[self.lo], self.busy[1]])
        b = np.concatenate([self.busy[0], [self.hi]])
        gap = b > a
        a, b = a[gap], b[gap]
        labels = host.labels((a + b) // 2 - self.offset, default)
        sums: collections.Counter = collections.Counter()
        for label, d in zip(labels.tolist(), (b - a).tolist()):
            sums[label] += d / 1e9
        return [[k, v] for k, v in sums.most_common()]


def clock_offset(marker_host_ns: int, events) -> int | None:
    """Device clock minus host clock, from the first marker kernel, launched
    right after the host read ``marker_host_ns``."""
    starts = [s for n, s, _ in events if MARKER in n]
    return (min(starts) - marker_host_ns) if starts else None
