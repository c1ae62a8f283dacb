"""The flows and the point tracking per clip (ms): the program's ``flows``
+ ``tracking`` phases."""


def read(r):
    if not r.has_span("flows"):
        return None
    return 1e3 * r.span_s("flows", "tracking") / r.n_morphs
