"""The share of the robust flow's IRLS steps that ran as hand-written
launches (%): the ``fused_irls_steps`` counters of the program's
``flow.level`` spans over their ``irls_steps``, times 100. None where no
span carries the counter, as in a program that runs every IRLS step in
eager operations or runs Horn-Schunck flows."""

from vmbench import program_spans


def read(r):
    levels = program_spans.named("flow.level")
    steps = sum(int(s.counts.get("irls_steps", 0)) for s in levels)
    if steps == 0 or not any("fused_irls_steps" in s.counts for s in levels):
        return None
    return 100.0 * sum(int(s.counts.get("fused_irls_steps", 0)) for s in levels) / steps
