"""Host ms of a request's readback: the mean of the program's
``lkt.serve.readback`` spans in the traced window (the wait for the
device's work and the copy of the lists to the host)."""

from portbench.core.program_trace import mean_s


def read(r):
    s = mean_s(r, "lkt.serve.readback")
    return None if s is None else 1e3 * s
