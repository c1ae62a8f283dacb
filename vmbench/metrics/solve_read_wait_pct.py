"""The share of the solver's levels (%) that the host spends waiting on a
device-to-host read: the program's ``host.read`` spans inside its
``solve.level`` spans over the length of those levels."""

from vmbench import program_spans


def read(r):
    levels = program_spans.named("solve.level")
    ids = {s.id for s in levels}
    reads = [s for s in program_spans.named("host.read") if s.parent in ids]
    total = program_spans.length_s(levels)
    if not reads or total <= 0:
        return None
    return 100.0 * program_spans.length_s(reads) / total
