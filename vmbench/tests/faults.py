"""Faults planted in the program's timed path, for the tests that see
``correct`` come out false: each patches the program with ``monkeypatch``."""

import torch


def unchanged(monkeypatch):
    """Every level solve runs, reports what it ran, and returns the field it
    was given."""
    import videomorphing_tpu_torch.solver.ctf as ctf
    import videomorphing_tpu_torch.video.pipeline as pipeline
    from videomorphing_tpu_torch.solver.descent import make_level_solver

    def make(p, n):
        solve = make_level_solver(p, n)
        return lambda v, data: (v, solve(v, data)[1])

    monkeypatch.setattr(ctf, "make_level_solver", make)
    monkeypatch.setattr(pipeline, "make_level_solver", make)


def stale(monkeypatch):
    """The cold solve runs every level and reports its true ``LevelStats``,
    and returns the field its finest level started from (a stale buffer):
    the pair's solve and the video's frame 0."""
    import videomorphing_tpu_torch.models.image_morph as image_morph
    import videomorphing_tpu_torch.solver.ctf as ctf
    import videomorphing_tpu_torch.video.pipeline as pipeline
    from videomorphing_tpu_torch.solver.descent import make_level_solver

    last = {}

    def make(p, n):
        solve = make_level_solver(p, n)

        def run(v, data):
            last["v"] = v.clone()
            return solve(v, data)

        return run

    optimize = ctf.optimize_pair

    def optimize_stale(*a, **k):
        res = optimize(*a, **k)
        return res._replace(v=last["v"])

    monkeypatch.setattr(ctf, "make_level_solver", make)
    monkeypatch.setattr(image_morph, "optimize_pair", optimize_stale)
    monkeypatch.setattr(pipeline, "optimize_pair", optimize_stale)


def frames(monkeypatch, broken):
    """The program's frames pass through ``broken(frames)``: the pair's
    ``render_clip`` and the video's per-frame ``render_frame``."""
    import videomorphing_tpu_torch.models.image_morph as image_morph
    import videomorphing_tpu_torch.video.pipeline as pipeline

    clip, frame = image_morph.render_clip, pipeline.render_frame
    monkeypatch.setattr(image_morph, "render_clip", lambda *a, **k: broken(clip(*a, **k)))
    seen = []

    def one(*a, **k):
        seen.append(frame(*a, **k))
        return broken(torch.stack(seen))[-1]

    monkeypatch.setattr(pipeline, "render_frame", one)


def half(out):
    """Half of the frames left out: each odd frame repeats the one before."""
    out = out.clone()
    out[1::2] = out[0:-1:2][: out[1::2].shape[0]]
    return out


def altered(out):
    out = out.clone()
    out[-1, :4, :4] += 0.05
    return out


FAULTS = {
    "unchanged": unchanged,
    "stale": stale,
    "half": lambda mp: frames(mp, half),
    "altered": lambda mp: frames(mp, altered),
}
