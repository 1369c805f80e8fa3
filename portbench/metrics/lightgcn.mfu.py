"""The LightGCN step's share of the card's float32 peak: the operations of
the window's steps (the sparse products' ``2·edges·k`` from the program's
counter ``graph.spmm_edges``, the blend, the loss and Adam;
:mod:`portbench.roofline.graph`) over the traced window's seconds.  The
products and Adam run in float32 outside the tensor cores, so that is the
peak."""

from portbench.core.program_trace import counter
from portbench.roofline import graph, peaks


def read(r):
    edges = counter(r, "graph.spmm_edges")
    c = r.counters
    if not edges or r.trace.busy_s() <= 0:
        return None
    k = c["k"]
    ops = graph.spmm_ops(edges, k) + c["steps"] * graph.other_step_ops(c["batch"], c["n_rows"], k, c["layers"])
    return 100.0 * ops / c["window_s"] / peaks.F32_FLOP_PER_S
