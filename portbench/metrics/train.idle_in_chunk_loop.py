"""The device's idle time whose gap began while the host was inside the
ALS half-epoch (a program span ``lkt.als.*``: a chunk, or the half's
set-up between them), in % of the traced window."""

from portbench.core.program_trace import idle_percent_in


def read(r):
    return idle_percent_in(r, lambda name: name.startswith("lkt.als."))
