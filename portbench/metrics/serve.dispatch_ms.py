"""Host ms to dispatch a serving request: the mean of the program's
``lkt.serve.dispatch`` spans in the traced window (the whole of
``device_recommend_async``, from the vocabulary lookup to the last block's
launch)."""

from portbench.core.program_trace import mean_s


def read(r):
    s = mean_s(r, "lkt.serve.dispatch")
    return None if s is None else 1e3 * s
