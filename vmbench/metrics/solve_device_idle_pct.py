"""The card's idle share inside the solver's levels (%): one less the
trace's busy union (kernels and copies) inside the program's
``solve.level`` spans over their length, both on the profiler's clock."""

from vmbench import program_spans


def read(r):
    levels = program_spans.named("solve.level")
    total = program_spans.length_s(levels)
    if r.trace is None or total <= 0:
        return None
    busy = program_spans.covered_within(r.trace.busy, [program_spans.seconds(s) for s in levels])
    return 100.0 * (1.0 - busy / total)
