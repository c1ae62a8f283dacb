"""The card's idle share inside the robust flow's IRLS steps (%): one less
the trace's busy union (kernels and copies) inside the program's
``flow.irls`` spans over their summed length, both on the profiler's
clock. None where no span is logged."""

from vmbench import program_spans


def read(r):
    steps = program_spans.named("flow.irls")
    total = program_spans.length_s(steps)
    if r.trace is None or total <= 0:
        return None
    busy = program_spans.covered_within(r.trace.busy, [program_spans.seconds(s) for s in steps])
    return 100.0 * (1.0 - busy / total)
