"""Device kernels per morph, the program's and torch's, from the trace:
the launch pressure on a host-bound path."""


def read(r):
    if r.trace is None:
        return None
    n = len(r.trace.kernels())
    return n / r.n_morphs if n else None
