"""Structured metrics: JSON-line records of every run and its fidelity
measures.

Port of ``videomorphing_tpu/utils/logging.py``. Every CLI run emits
per-level solver records (energy, iterations, step), phase walls and the
run's metrics as JSON lines, so every run is a benchmark run. The two
fidelity measures run on the device of the tensors they are given.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from videomorphing_tpu_torch.kernels.warp import bilinear_sample_batched
from videomorphing_tpu_torch.ops.resample import grid_coords
from videomorphing_tpu_torch.ops.ssim import dssim_map

logger = logging.getLogger("videomorphing_tpu_torch")


def level_record(level: int, shape, stats) -> Dict[str, Any]:
    """A ``LevelStats`` as a plain-dict record."""
    return {
        "level": level,
        "shape": list(shape),
        "e0": float(stats.e0),
        "e_final": float(stats.e_final),
        "iters": int(stats.iters),
        "step": float(stats.step),
    }


class MetricsLogger:
    """JSON-lines metrics sink with wall-clock phase timing.

    >>> m = MetricsLogger(verbose=True)
    >>> with m.phase("optimize"):
    ...     ...
    >>> m.emit("solve_done", levels=records)
    """

    def __init__(self, stream=None, verbose: bool = False):
        self.stream = stream if stream is not None else sys.stderr
        self.verbose = verbose
        self._t0 = time.perf_counter()

    def emit(self, event: str, **fields: Any) -> None:
        rec = {"event": event, "t": round(time.perf_counter() - self._t0, 4), **fields}
        line = json.dumps(rec, default=_to_jsonable)
        if self.verbose:
            print(line, file=self.stream, flush=True)
        logger.info(line)

    def phase(self, name: str):
        return _Phase(self, name)


class _Phase:
    def __init__(self, m: MetricsLogger, name: str):
        self.m = m
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.m.emit("phase", name=self.name, seconds=round(time.perf_counter() - self.t0, 4))
        return False


def _to_jsonable(x):
    try:
        return float(x)
    except Exception:
        return str(x)


def _tensor(x, device=None) -> torch.Tensor:
    """``x`` (array or tensor) as a float32 tensor, on ``device`` if given."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))
    return t.to(device=t.device if device is None else device, dtype=torch.float32)


def endpoint_ssim(frames, src_a, src_b) -> Dict[str, float]:
    """Endpoint fidelity: SSIM of frame 0 against source A and of the last
    frame against source B, 2 px away from the border (the warps
    edge-clamp there), rounded to 5 decimals. At t = 0 and 1 the morph
    must reproduce its inputs."""
    f0 = _tensor(frames[0])
    f1, a, b = (_tensor(x, f0.device) for x in (frames[-1], src_a, src_b))
    sl = (slice(2, -2), slice(2, -2))
    s0 = 1.0 - torch.mean(dssim_map(f0[sl], a[sl]))
    s1 = 1.0 - torch.mean(dssim_map(f1[sl], b[sl]))
    return {"ssim_t0_vs_a": round(float(s0), 5), "ssim_t1_vs_b": round(float(s1), 5)}


def midpoint_agreement_ssim(v, i0, i1, crop: int = 4) -> Dict[str, float]:
    """Correspondence quality for any inputs: SSIM between the two one-sided
    halfway reconstructions I0(p - v) and I1(p + v), ``crop`` px away from
    the border, rounded to 5 decimals. A correct field aligns the two; a
    wrong but smooth one leaves them misaligned, which the endpoint measure
    cannot see. The two warps are one launch of the batched sampler."""
    v = _tensor(v)
    g = grid_coords(v.shape[0], v.shape[1], dtype=v.dtype, device=v.device)
    w0, w1 = bilinear_sample_batched(
        torch.stack([_tensor(i0, v.device), _tensor(i1, v.device)]), torch.stack([g - v, g + v])
    )
    sl = (slice(crop, -crop), slice(crop, -crop))
    s = 1.0 - torch.mean(dssim_map(w0[sl], w1[sl]))
    return {"ssim_halfway_agreement": round(float(s), 5)}
