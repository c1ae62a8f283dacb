"""Device kernels per robust Jacobi sweep of the flows (kernels/sweep): the
trace's kernels that start inside the program's ``flow.irls`` spans (an
IRLS step's weights, its normal matrix and its inner sweeps) over those
spans' ``sweeps`` summed. The spans are not synchronized: where the card
lags the host (a device-bound level), a step's last kernels start after
its span and the count reads low. None where no span is logged, as in a
program without the span or with Horn-Schunck flows."""

from vmbench import program_spans


def read(r):
    steps = program_spans.named("flow.irls")
    sweeps = sum(int(s.attrs.get("sweeps", 0)) for s in steps)
    if r.trace is None or sweeps <= 0:
        return None
    starts = [a for a, _, _ in r.trace.kernels()]
    n = sum(program_spans.starts_within(starts, *program_spans.seconds(s)) for s in steps)
    return n / sweeps if n else None
