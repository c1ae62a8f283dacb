"""The finest level's device work per solver iteration (ms/iter): the
trace's busy union (kernels and copies) inside the program's
``solve.level`` spans of the largest h x w in the log, over those levels'
``iters``. What a kernel or fusion change moves at that level, whether the
level is device-bound (4K) or host-bound (1024^2)."""

from vmbench import program_spans


def read(r):
    levels = program_spans.named("solve.level")
    if r.trace is None or not levels:
        return None
    size = lambda s: int(s.attrs.get("h", 0)) * int(s.attrs.get("w", 0))  # noqa: E731
    finest = [s for s in levels if size(s) == max(size(s) for s in levels)]
    iters = sum(int(s.attrs.get("iters", 0)) for s in finest)
    busy = program_spans.covered_within(r.trace.busy, [program_spans.seconds(s) for s in finest])
    return 1e3 * busy / iters if iters > 0 and busy > 0 else None
