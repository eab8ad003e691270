"""merge_sorted_roofline, in percent: both merge entry points (the root
merge and the flush fan-out), one kernel.

Least time (the larger of bytes over HBM bandwidth and ops over the integer
rate, from each launch's live counts) over the kernel's device time."""
from nbbench.roofline_share import roofline_share


def read(obs):
    return roofline_share(obs, "merge_sorted", "merge_sorted_batch")
