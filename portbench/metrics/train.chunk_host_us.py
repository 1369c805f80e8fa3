"""Host microseconds to issue one chunk of the ALS epoch: the mean of the
program's ``lkt.als.chunk`` spans in the traced window (the slicing, G's
and B1's launches, the delta and the scatter)."""

from portbench.core.program_trace import mean_s


def read(r):
    s = mean_s(r, "lkt.als.chunk")
    return None if s is None else 1e6 * s
