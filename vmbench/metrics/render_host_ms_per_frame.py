"""The host's wall to issue one rendered frame (ms): the mean length of the
program's ``render.frame`` spans, which do not synchronize. Beside the
synced ``render_ms_per_frame`` it shows how far the render is host-bound."""

from vmbench import program_spans


def read(r):
    frames = program_spans.named("render.frame")
    return 1e3 * program_spans.length_s(frames) / len(frames) if frames else None
