"""The ALS epoch's share of the card's float32 peak: the operations its
inputs need (G's over the real entries, a solve a real row) over the
traced window's seconds.  G, B1 and B2 run in float32 outside the tensor
cores, so that is the peak."""

from portbench.roofline import counts, peaks


def read(r):
    c = r.counters
    if "entries_per_step" not in c or r.trace.busy_s() <= 0:
        return None
    k = c["k"]
    ops = c["steps"] * (counts.gram_ops(c["entries_per_step"], k) + counts.solve_ops(c["rows_per_step"], k))
    return 100.0 * ops / c["window_s"] / peaks.F32_FLOP_PER_S
