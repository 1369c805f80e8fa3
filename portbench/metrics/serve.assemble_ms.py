"""Host ms to assemble a request's lists: the mean of the program's
``lkt.serve.assemble`` spans in the traced window (the rest of
``result()``: the reorder, the lengths, ``ArrayTopNILC`` and the log
line)."""

from portbench.core.program_trace import mean_s


def read(r):
    s = mean_s(r, "lkt.serve.assemble")
    return None if s is None else 1e3 * s
