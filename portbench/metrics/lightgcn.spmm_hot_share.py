"""The share of the sparse products' edges whose source rows came from
shared memory, in %: the program's counters ``graph.spmm_hot_edges`` over
``graph.spmm_edges``, added by every product, forward and backward, in the
traced window.  None where the program keeps no such counter."""

from portbench.core.program_trace import counter


def read(r):
    hot, edges = counter(r, "graph.spmm_hot_edges"), counter(r, "graph.spmm_edges")
    if hot is None or not edges:
        return None
    return 100.0 * hot / edges
