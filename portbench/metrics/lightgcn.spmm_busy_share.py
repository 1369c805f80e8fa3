"""The sparse products' share of the device's busy time in the traced
window, in %: the profiler time of cuSPARSE's kernels over the union of
every device activity."""

from portbench.roofline import graph


def read(r):
    busy = r.trace.busy_s()
    t = r.trace.device_s(graph.spmm_kernel)
    if busy <= 0 or t <= 0:
        return None
    return 100.0 * t / busy
