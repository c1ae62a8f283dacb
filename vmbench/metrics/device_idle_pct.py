"""The share of the traced window (%) in which the card runs no kernel and
no copy: one less the union of the trace's device intervals over the
window."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
