"""Host microseconds of one LightGCN step: the mean of the program's
``lkt.grad.step`` spans in the traced window (the batch's slicing, the
negatives, the propagation's launches, the loss, the backward's and Adam's
launches); beside the window's seconds a step it says whether the host or
the device paces the step."""

from portbench.core.program_trace import mean_s


def read(r):
    s = mean_s(r, "lkt.grad.step")
    return None if s is None else 1e6 * s
