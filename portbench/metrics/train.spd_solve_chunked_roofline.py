"""B1's share of its roofline over the traced training window: the least
time of the real rows' solves over its profiler time."""

from portbench.core.program import kernel_kind
from portbench.roofline import counts


def read(r):
    t = r.trace.device_s(lambda name: kernel_kind(name) == "B1")
    if t <= 0:
        return None
    c = r.counters
    rows, k = c["rows_per_step"], c["k"]
    return 100.0 * c["steps"] * counts.bound_s(counts.solve_ops(rows, k), counts.solve_bytes(rows, k)) / t
