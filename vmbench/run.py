"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m vmbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up makes the cell's pool of inputs on the
card from ``--seed``, builds the program's morpher and runs one warm-up
morph of every shape the cell uses (the first run of a checkout also
builds the program's CUDA library there, under ``build/``). Then:

- ``--trace 0``: the timed window. Morphs run one after another (a closed
  loop, one client) through the pool in turn; the window opens at the
  first morph's start and closes at the end of the last morph that started
  before ``--seconds`` had elapsed. The end-to-end metrics come from the
  host clock, each morph closed by a synchronize.
- ``--trace 1``: the mix's ``trace_morphs`` morphs under ``torch.profiler``,
  each layer's span closed by a synchronize; the per-layer metrics, the
  device's busy time and a breakdown come from the spans and the trace.

Then the program's state is freed and the plain reference
(``vmbench.reference``) computes a sample of the morphs again, drawn from
the seed; each number compared is printed beside its limit as the last
lines on standard error and under ``check`` in the result line, which is
the last line on standard output. Exit codes other than 0 print no result:
2 for a cell the checkout cannot resolve, 3 without enough cards, 4 when
``jax``, ``jaxlib``, ``flax`` or ``videomorphing_tpu`` was loaded.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, NamedTuple, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "videomorphing_tpu")
HERE = Path(__file__).resolve().parent
WINDOW_RANGE = "vmbench.morph"


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell named ``workload`` with its configuration, its mix and the
    metrics it reports, from ``BENCHMARK.json`` at ``root``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((HERE / "mixes" / f"{w['traffic']}.json").read_text())

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return Cell(workload, int(w["chips"]), config, mix,
                [m for m in spec["end_to_end"] if mine(m)], [m for m in spec["per_layer"] if mine(m)])


def since_process_start() -> float:
    """Seconds since this process started (``/proc/self/stat``), or since
    this module was imported where that cannot be read."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``videomorphing_tpu_torch`` is not ``videomorphing_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Spans:
    """The harness's spans around its calls into the program. Off (the
    timed window): nothing, so the window runs the program as a user
    would. On (a traced run): a profiler range, a synchronize at entry and
    exit, and the host seconds added under the span's name."""

    def __init__(self, on: bool, sync):
        self.on, self.sync = on, sync
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        import torch

        with torch.profiler.record_function(name):
            self.sync()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.sync()
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


class Record(NamedTuple):
    item: int
    start: float
    end: float
    frames: int
    counts: dict
    spans: Dict[str, float]


class Reading:
    """What a per-layer metric reads: the traced morphs, their spans and
    counts, the device trace, and the kernel-name lists."""

    def __init__(self, config: dict, mix: dict, records: List[Record], trace):
        self.config, self.mix, self.records, self.trace = config, mix, records, trace

    @property
    def n_morphs(self) -> int:
        return len(self.records)

    @property
    def frames(self) -> int:
        return sum(r.frames for r in self.records)

    def span_s(self, *names: str) -> float:
        """Seconds under the named spans, summed over the traced morphs."""
        return sum(r.spans.get(n, 0.0) for r in self.records for n in names)

    def has_span(self, name: str) -> bool:
        return any(name in r.spans for r in self.records)

    def count(self, name: str) -> list:
        """The per-morph counts under ``name`` of the morphs that have one."""
        return [r.counts[name] for r in self.records if name in r.counts]

    @staticmethod
    def kernel_names(name: str) -> List[str]:
        """The substrings of ``kernel_names/<name>.txt`` (one a line; ``#``
        starts a comment)."""
        lines = (HERE / "kernel_names" / f"{name}.txt").read_text().splitlines()
        return [ln.split("#", 1)[0].strip() for ln in lines if ln.split("#", 1)[0].strip()]

    def kernel_seconds(self, names: str) -> Optional[float]:
        """Device seconds of the kernels that match ``kernel_names/<names>``,
        each with the launches of ``kernel_names/followers`` that follow it
        (a sweep's reduce), or None when none ran."""
        mains, followers = self.kernel_names(names), self.kernel_names("followers")
        total, found, last = 0.0, False, False
        for a, b, name in self.trace.kernels():
            if any(s in name for s in mains):
                total, found, last = total + (b - a), True, True
            elif any(s in name for s in followers):
                total += (b - a) if last else 0.0
            else:
                last = False
        return total if found else None


def read_metric(name: str, reading: Reading) -> Optional[float]:
    mod = importlib.import_module(f"vmbench.metrics.{name}")
    value = mod.read(reading)
    return None if value is None else float(value)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"power limit not read ({type(e).__name__})"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, origin=since_process_start) -> dict:
    """One run of ``cell``: set-up, the window or the traced morphs, the
    check. Returns the result object (``check`` as its last key)."""
    import torch

    on_card = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    kind = importlib.import_module(f"vmbench.kinds.{cell.config['kind']}")
    pool = int(cell.mix["pool"])
    # the items checked, drawn from the seed among the first ones the run
    # reaches (items run in order), so that every run has them
    within = min(pool, int(cell.mix["check_within"]), int(cell.mix["trace_morphs"]) if trace else pool)
    check_items = set(random.Random(int(seed)).sample(range(within), min(int(cell.mix["check_morphs"]), within)))

    program = kind.Program(cell.config, cell.mix, seed, device)
    # warm-up: every shape of the cell, on the item the window reaches last
    program.morph(pool - 1, Spans(False, sync))
    sync()
    setup_s = origin()

    spans = Spans(trace, sync)
    records: List[Record] = []
    kept: Dict[int, dict] = {}
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        t_open = None
        while True:
            k = len(records)
            if trace and k >= int(cell.mix["trace_morphs"]):
                break
            t0 = time.perf_counter()
            if t_open is None:
                t_open = t0
            elif not trace and t0 - t_open >= seconds:
                break
            spans.seconds = {}
            with (torch.profiler.record_function(WINDOW_RANGE) if trace else contextlib.nullcontext()):
                out = program.morph(k % pool, spans)
                sync()
            t1 = time.perf_counter()
            records.append(Record(k % pool, t0, t1, out["frames"], out["counts"],
                                  {**spans.seconds, **out.get("phases", {})}))
            kept = {i: o for i, o in kept.items() if i in check_items and i != k % pool}
            kept[k % pool] = out["outputs"]
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0

    metrics: Dict[str, dict] = {}
    result: dict = {}
    if trace:
        from vmbench import trace as trace_mod

        t0 = time.perf_counter()
        tr = trace_mod.collect(prof, WINDOW_RANGE, program.span_names) if on_card else None
        prof = None
        reading = Reading(cell.config, cell.mix, records, tr)
        for m in cell.per_layer:
            value = read_metric(m["name"], reading) if (tr is not None or m["source"] != "device_trace") else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
            busy_s, window_s = tr.busy_s, tr.window_s
        else:
            busy_s, window_s = None, None
        print(f"vmbench: trace read in {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    else:
        from vmbench import stats

        rate, window, frames = stats.window_rate([(r.start, r.end, r.frames) for r in records])
        times = [r.end - r.start for r in records]
        values = {"frames_per_s": rate, "setup_s": setup_s, "morph_s_p90": stats.percentile(times, 90)}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        print(f"vmbench: {len(records)} morphs, {frames} frames in {window:.3f} s", file=sys.stderr)
    print(f"vmbench: memory_peak_bytes {peak}", file=sys.stderr)

    # the check: the sample's latest outputs against the plain reference
    sample = sorted(i for i in kept if i in check_items) or [records[-1].item]
    outputs = {i: kept[i] for i in sample}
    del kept
    program.release()
    del program
    if on_card:
        torch.cuda.empty_cache()
    checks = []
    for i in sample:
        for name, value in kind.check(cell.config, cell.mix, seed, device, i, outputs[i]).items():
            checks.append((f"{name}.item{i}", name, value))
        del outputs[i]
    limits = cell.config["limits"]
    correct = all(math.isfinite(v) and v <= limits[n] for _, n, v in checks)

    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": peak,
        "card": card_line() if on_card else "cpu",
    }
    if trace:
        device_info.update({"busy_s": busy_s, "window_s": window_s})
    return {
        "correct": correct,
        "attempted": len(records),
        "failed": 0,
        "metrics": metrics,
        "device": device_info,
        **result,
        "check": {key: {"value": v, "limit": limits[n]} for key, n, v in checks},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = load_cell(Path.cwd(), args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"vmbench: cannot resolve cell {args.workload!r}: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"vmbench: {cell.name} needs {cell.chips} CUDA device(s), {n} visible", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"vmbench: loaded modules that the benchmark must not load: {', '.join(found)}", file=sys.stderr)
        return 4
    for key, c in result["check"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
