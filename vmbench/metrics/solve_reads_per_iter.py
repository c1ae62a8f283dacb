"""Device-to-host reads per solver iteration (reads/iter): the ``reads``
counters of the program's ``solve.level`` spans over their ``iters``, the
cold and warm levels alike. Each read blocks the host until the card has
caught up."""

from vmbench import program_spans


def read(r):
    return program_spans.per_iter(program_spans.named("solve.level"), "reads")
