"""The synthetic clip pair of the reference's benchmark (``bench.py``).

A copy of ``bench._make_clips`` (numpy only), so that the port's checks
make the same inputs without importing the JAX benchmark harness.
"""

from __future__ import annotations

import numpy as np


def make_clips(t_len: int, h: int, w: int, seed: int = 0):
    """Two (T, H, W, 3) float32 clips in [0, 1]: a smoothed random texture
    with a horizontal gradient, and a Gaussian blob (sigma 0.08 h) on the
    middle row that moves 2 px a frame from x = 0.45 w (clip A) or
    x = 0.55 w (clip B)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    tex = rng.random((h, w, 3), dtype=np.float32)
    for _ in range(2):
        tex = 0.25 * (
            np.roll(tex, 1, 0) + np.roll(tex, -1, 0)
            + np.roll(tex, 1, 1) + np.roll(tex, -1, 1)
        )
    base = 0.3 + 0.4 * tex + 0.2 * (xx / w)[..., None]

    def blob(cy, cx, s):
        return np.exp(-0.5 * ((yy - cy) ** 2 + (xx - cx) ** 2) / s**2)[..., None]

    def clip(x0):
        frames = []
        for k in range(t_len):
            f = base + 0.5 * blob(h * 0.5, x0 + k * 2.0, h * 0.08)
            frames.append(np.clip(f, 0, 1))
        return np.stack(frames).astype(np.float32)

    return clip(w * 0.45), clip(w * 0.55)
