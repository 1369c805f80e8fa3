"""The share of the entries G sums that are real, in %: the program's
counters ``als.entries_real`` over ``als.entries_padded``, added once a
chunk issued in the traced window."""

from portbench.core.program_trace import counter


def read(r):
    real, padded = counter(r, "als.entries_real"), counter(r, "als.entries_padded")
    if not real or not padded:
        return None
    return 100.0 * real / padded
