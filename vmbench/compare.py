"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference computes from the same inputs."""

from __future__ import annotations

import math

import torch


def field_gap_px(v: torch.Tensor, v_ref: torch.Tensor) -> float:
    """The largest, over frames, of the median over pixels of the distance
    (px) between the program's halfway field and the reference's; ``v``
    (H, W, 2) or (T, H, W, 2)."""
    d = torch.linalg.vector_norm(v.float() - v_ref.float(), dim=-1)
    d = d.reshape(-1, d.shape[-2] * d.shape[-1]) if d.dim() == 3 else d.reshape(1, -1)
    return float(d.median(dim=1).values.max())


def frame_gap(frames: torch.Tensor, ref_frames: torch.Tensor) -> float:
    """The largest absolute difference of any value of any frame."""
    return float((frames.float() - ref_frames.float()).abs().max())




def rel_gap(value: float, ref: float) -> float:
    """|value - ref| / |ref| (NaN where either is not finite)."""
    if not (math.isfinite(value) and math.isfinite(ref)):
        return float("nan")
    return abs(value - ref) / abs(ref)


def worst(values) -> float:
    """The largest of the values; NaN if any is NaN."""
    values = list(values)
    return float("nan") if any(v != v for v in values) else max(values)
