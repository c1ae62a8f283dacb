"""The share of the flows' Horn-Schunck Jacobi sweeps that ran as one
launch of the fused sweep kernel (%): the ``fused_sweeps`` counters of the
program's ``flow.level`` spans over their ``sweeps``, times 100. None where
no span carries the counter, as in a program that runs every sweep
eagerly."""

from vmbench import program_spans


def read(r):
    levels = program_spans.named("flow.level")
    sweeps = sum(int(s.attrs.get("sweeps", 0)) for s in levels)
    if sweeps == 0 or not any("fused_sweeps" in s.counts for s in levels):
        return None
    return 100.0 * sum(int(s.counts.get("fused_sweeps", 0)) for s in levels) / sweeps
