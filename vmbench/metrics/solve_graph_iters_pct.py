"""The share of solver iterations that ran as replays of captured CUDA
graphs (%): the ``graph_iters`` counters of the program's ``solve.level``
spans over their ``iters``, times 100, the cold and warm levels alike.
None where no span carries the counter, as in a program that runs every
iteration eagerly."""

from vmbench import program_spans


def read(r):
    levels = program_spans.named("solve.level")
    iters = sum(int(s.attrs.get("iters", 0)) for s in levels)
    if iters == 0 or not any("graph_iters" in s.counts for s in levels):
        return None
    return 100.0 * sum(int(s.counts.get("graph_iters", 0)) for s in levels) / iters
