"""The device's idle time whose gap began while the host assembled a
request's lists (the program's ``lkt.serve.assemble``), in % of the traced
window."""

from portbench.core.program_trace import idle_percent_in


def read(r):
    return idle_percent_in(r, lambda name: name == "lkt.serve.assemble")
