"""Device time of kernels 1-2 per morph (ms): every form in
``kernel_names/sweeps.txt`` and the reduce after each, from the trace."""


def read(r):
    if r.trace is None:
        return None
    s = r.kernel_seconds("sweeps")
    return 1e3 * s / r.n_morphs if s else None
