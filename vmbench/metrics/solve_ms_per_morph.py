"""The solve's wall per morph (ms): the harness's ``solve`` span (pairs),
or the program's ``cold_solve`` + ``warm_loop`` phases (video), each closed
by a synchronize."""

SPANS = ("solve", "cold_solve", "warm_loop")


def read(r):
    s = r.span_s(*SPANS)
    return 1e3 * s / r.n_morphs if s > 0 else None
