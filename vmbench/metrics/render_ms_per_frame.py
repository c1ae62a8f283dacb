"""The synthesis per rendered frame (ms): the harness's ``render`` span
(pairs), or the program's ``bulges`` + ``confidences`` + ``render``
phases (video)."""


def read(r):
    s = r.span_s("bulges", "confidences", "render")
    return 1e3 * s / r.frames if s > 0 and r.frames else None
