"""G's share of its roofline over the traced training window: the least
time of the entries it summed (real ones only) over its profiler time."""

from portbench.core.program import kernel_kind
from portbench.roofline import counts


def read(r):
    t = r.trace.device_s(lambda name: kernel_kind(name) == "G")
    if t <= 0:
        return None
    c = r.counters
    e, rows, k = c["entries_per_step"], c["rows_per_step"], c["k"]
    bound = c["steps"] * counts.bound_s(counts.gram_ops(e, k), counts.gram_bytes(e, rows, k))
    return 100.0 * bound / t
