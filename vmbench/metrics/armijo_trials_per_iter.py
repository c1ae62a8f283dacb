"""Armijo trials per solver iteration (trials/iter): the ``armijo_trials``
counters of the program's ``solve.level`` spans (kernel 2's calls in the
line search, the first trial included) over their ``iters``."""

from vmbench import program_spans


def read(r):
    return program_spans.per_iter(program_spans.named("solve.level"), "armijo_trials")
