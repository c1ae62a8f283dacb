"""The share of rendered frames that were replays of a captured CUDA graph
(%): the ``graph_replays`` counters of the program's ``render.frame`` spans
over the number of those spans, times 100. None where no span carries the
counter, as in a program that renders every frame eagerly."""

from vmbench import program_spans


def read(r):
    frames = program_spans.named("render.frame")
    if not any("graph_replays" in s.counts for s in frames):
        return None
    return 100.0 * sum(int(s.counts.get("graph_replays", 0)) for s in frames) / len(frames)
