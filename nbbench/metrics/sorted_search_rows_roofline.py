"""sorted_search_rows_roofline, in percent: the descent's run searches.

Least time (the larger of bytes over HBM bandwidth and ops over the integer
rate, from each launch's live counts) over the kernel's device time."""
from nbbench.roofline_share import roofline_share


def read(obs):
    return roofline_share(obs, "sorted_search_rows")
