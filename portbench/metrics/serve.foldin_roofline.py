"""Fold-in's share of its roofline: the least times of G (the requests'
history entries) and B2 (a row a user) over their profiler times."""

from portbench.core.program import kernel_kind


def read(r):
    t = r.trace.device_s(lambda name: kernel_kind(name) in ("G", "B2"))
    work = r.counters["work"]
    if t <= 0 or not work or "G_bound_s" not in work[0]:
        return None
    return 100.0 * sum(w["G_bound_s"] + w["B2_bound_s"] for w in work) / t
