"""The benchmark's inputs, made on the device from ``--seed``.

The clip formula is a frozen copy of the program's bench clips (a smoothed
texture, a horizontal gradient, a blob moving 2 px a frame from 0.45 w or
0.55 w); the texture is ``torch.rand`` of a ``torch.Generator`` on the
device. The user points are the reference bench's four pairs: ys evenly
from 0.3 h to 0.7 h, x at 0.45 w in image 0 and 0.55 w in image 1.
"""

from __future__ import annotations

import numpy as np
import torch


def item_seeds(seed: int, n: int) -> list:
    """``n`` distinct generator seeds for the pool items of one run's seed
    (any whole number, negative or past 64 bits too)."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), n])
    return [int(s) for s in ss.generate_state(n, np.uint64)]


def make_clips(t_len: int, h: int, w: int, seed: int, device) -> tuple:
    """A clip pair (t_len, h, w, 3) float32 in [0, 1] on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    tex = torch.rand((h, w, 3), generator=gen, device=dev)
    for _ in range(2):
        tex = 0.25 * (tex.roll(1, 0) + tex.roll(-1, 0) + tex.roll(1, 1) + tex.roll(-1, 1))
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    base = 0.3 + 0.4 * tex + 0.2 * (xx / w)[..., None]

    def clip(x0: float) -> torch.Tensor:
        frames = torch.empty((t_len, h, w, 3), dtype=torch.float32, device=dev)
        for k in range(t_len):
            d2 = (yy - h * 0.5) ** 2 + (xx - (x0 + k * 2.0)) ** 2
            blob = torch.exp(-0.5 * d2 / (h * 0.08) ** 2)[..., None]
            frames[k] = torch.clamp(base + 0.5 * blob, 0.0, 1.0)
        return frames

    return clip(w * 0.45), clip(w * 0.55)


def user_points(h: int, w: int, n: int) -> np.ndarray:
    """(n, 2, 2) float32 pairs [[y0, x0], [y1, x1]] (none for n = 0)."""
    ys = np.linspace(h * 0.3, h * 0.7, n)
    return np.stack(
        [np.stack([ys, np.full(n, w * 0.45)], -1), np.stack([ys, np.full(n, w * 0.55)], -1)], 1
    ).astype(np.float32).reshape(n, 2, 2)
