"""Serving's share of the card's float32 peak: the operations the
requests need (fold-in where the model has one, the score product) over
the traced window's seconds.  The product runs in float32 with TF32 off."""

from portbench.roofline import peaks


def read(r):
    if r.trace.busy_s() <= 0:
        return None
    return 100.0 * sum(w["ops"] for w in r.counters["work"]) / r.trace.window_s / peaks.F32_FLOP_PER_S
