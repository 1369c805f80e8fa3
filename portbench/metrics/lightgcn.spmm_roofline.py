"""The graph propagation's share of its roofline over the traced training
window: the least time of the sparse products the program issued (its
counters ``graph.spmm_products`` and ``graph.spmm_edges``, forward and
backward; :mod:`portbench.roofline.graph`) over the profiler time of
cuSPARSE's kernels, which run them."""

from portbench.core.program_trace import counter
from portbench.roofline import graph


def read(r):
    t = r.trace.device_s(graph.spmm_kernel)
    products, edges = counter(r, "graph.spmm_products"), counter(r, "graph.spmm_edges")
    if t <= 0 or not products or not edges:
        return None
    c = r.counters
    return 100.0 * graph.spmm_bound_s(products, edges, c["n_rows"], c["k"]) / t
