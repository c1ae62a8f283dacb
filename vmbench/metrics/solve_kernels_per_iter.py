"""Device kernels per solver iteration (kernels/iter): the trace's kernels
that start inside the program's ``solve.level`` spans (each level ends on
a read, so its kernels have run by its end) over those levels' ``iters``."""

from vmbench import program_spans


def read(r):
    levels = program_spans.named("solve.level")
    iters = sum(int(s.attrs.get("iters", 0)) for s in levels)
    if r.trace is None or iters <= 0:
        return None
    starts = [a for a, _, _ in r.trace.kernels()]
    n = sum(program_spans.starts_within(starts, *program_spans.seconds(s)) for s in levels)
    return n / iters if n else None
