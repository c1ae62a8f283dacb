"""Faults planted in the program's timed path, for the tests that see
``correct`` come out false.

Each fault replaces one function of the program wherever the program holds
it: in the module that defines it and in every module of
``videomorphing_tpu_torch`` that holds the same object under a name
(compared by identity), so that every entry that reaches the function, by
whatever path, meets the fault. Every module of the program is imported
first, so that none binds the fault at its own import and keeps it once
``monkeypatch`` has undone the rest."""

import importlib
import pkgutil
import sys

PROGRAM = "videomorphing_tpu_torch"


def program_modules() -> list:
    """Every module of the program, imported."""
    package = importlib.import_module(PROGRAM)
    for info in pkgutil.walk_packages(package.__path__, PROGRAM + "."):
        importlib.import_module(info.name)
    return [m for name, m in list(sys.modules.items())
            if m is not None and (name == PROGRAM or name.startswith(PROGRAM + "."))]


def plant(monkeypatch, module: str, name: str, make) -> None:
    """``make(original)`` in place of ``<module>.<name>`` of the program,
    under every name that any module of the program holds it by."""
    original = getattr(importlib.import_module(f"{PROGRAM}.{module}"), name)
    fault = make(original)
    for mod in program_modules():
        for attr, value in list(vars(mod).items()):
            if value is original:
                monkeypatch.setattr(mod, attr, fault)


def unchanged(monkeypatch):
    """Every level solve runs, reports what it ran, and returns the field it
    was given."""

    def make(make_level_solver):
        def make_unchanged(p, n):
            solve = make_level_solver(p, n)
            return lambda v, data: (v, solve(v, data)[1])

        return make_unchanged

    plant(monkeypatch, "solver.descent", "make_level_solver", make)


def stale(monkeypatch):
    """Every coarse-to-fine solve runs every level and reports its true
    ``LevelStats``, and returns the field its finest level started from (a
    stale buffer): the pair's solve, the video's frame 0, each pair of a
    batch."""
    last = {}

    def make_recorded(make_level_solver):
        def make(p, n):
            solve = make_level_solver(p, n)

            def run(v, data):
                last["v"] = v.clone()
                return solve(v, data)

            return run

        return make

    def make_stale(optimize_pair):
        def optimize_stale(*a, **k):
            return optimize_pair(*a, **k)._replace(v=last["v"])

        return optimize_stale

    plant(monkeypatch, "solver.descent", "make_level_solver", make_recorded)
    plant(monkeypatch, "solver.ctf", "optimize_pair", make_stale)


def frames(monkeypatch, broken):
    """Each frame that ``synth.render.render_frame`` returns passes through
    ``broken(k, frame, before)``: ``k`` counts the frames rendered since the
    fault was planted, ``before`` is the frame rendered before this one."""

    def make(render_frame):
        seen = {"k": 0, "before": None}

        def one(*a, **k):
            frame = render_frame(*a, **k)
            out = broken(seen["k"], frame, seen["before"])
            seen["k"], seen["before"] = seen["k"] + 1, frame
            return out

        return one

    plant(monkeypatch, "synth.render", "render_frame", make)


def half(k, frame, before):
    """Half of the frames left out: each odd frame repeats the one before."""
    return before.clone() if k % 2 else frame


def altered(k, frame, before):
    out = frame.clone()
    out[:4, :4] += 0.05
    return out


FAULTS = {
    "unchanged": unchanged,
    "stale": stale,
    "half": lambda mp: frames(mp, half),
    "altered": lambda mp: frames(mp, altered),
}
