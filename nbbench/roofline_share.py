"""A kernel's share of its roofline: its launches' least time over their
device time in the trace, in percent; nothing without launches or time.
Both come from the traced window's second half, where the kernel wrappers
count each launch."""
from .kernel_work import KERNEL_NAMES


def roofline_share(obs, *entry_points):
    if obs.kernel_least is None or obs.kernel_trace is None:
        return None
    launches = sum(obs.kernel_least[e][0] for e in entry_points)
    least = sum(obs.kernel_least[e][1] for e in entry_points)
    kernels = {KERNEL_NAMES[e] for e in entry_points}
    busy = sum(obs.kernel_trace.kernel_s(k) for k in kernels)
    if not launches or busy <= 0:
        return None
    return 100.0 * least / busy
