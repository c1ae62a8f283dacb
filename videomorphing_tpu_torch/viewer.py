"""Notebook and script preview helpers (port of ``videomorphing_tpu/viewer.py``).

The halfway-domain view, the direction-coded field colours and a morph
strip: the visual instruments of an interactive session. ``halfway_image``
samples through kernel 4 (``kernels.warp.bilinear_sample``) on the card;
the rest is numpy. matplotlib is optional: every function returns its
array, and draws it only where matplotlib imports.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from videomorphing_tpu_torch.device import pick_device
from videomorphing_tpu_torch.kernels.warp import bilinear_sample
from videomorphing_tpu_torch.ops.resample import grid_coords
from videomorphing_tpu_torch.utils.logging import _tensor


def _plt():
    try:
        import matplotlib.pyplot as plt  # type: ignore

        return plt
    except Exception:
        return None


def halfway_image(i0, i1, v, device=None) -> np.ndarray:
    """The halfway-domain view: I0(g - v) and I1(g + v), averaged, where
    correspondence errors show as ghosting. Takes numpy arrays or tensors
    and returns numpy; runs on ``device`` (default: ``v``'s card when it is
    a CUDA tensor, else the first card)."""
    dev = pick_device(device, v)
    i0, i1, v = _tensor(i0, dev), _tensor(i1, dev), _tensor(v, dev)
    g = grid_coords(v.shape[0], v.shape[1], v.dtype, dev)
    w0 = bilinear_sample(i0, g - v)
    w1 = bilinear_sample(i1, g + v)
    return (0.5 * (w0 + w1)).cpu().numpy()


def field_magnitude(v) -> np.ndarray:
    """|v| as a (H, W) array (for quick field inspection)."""
    v = np.asarray(v)
    return np.linalg.norm(v, axis=-1)


def field_color(v, max_mag: Optional[float] = None) -> np.ndarray:
    """Direction-coded field visualization (Middlebury-style colour wheel).

    Hue = direction of ``v`` (or a flow), saturation/value = magnitude
    scaled to ``max_mag`` (default: the field's own max). Smooth hue ramps
    are coherent motion, speckle is noise, hue discontinuities are motion
    boundaries. Returns (H, W, 3) in [0, 1].
    """
    v = np.asarray(v, np.float32)
    mag = np.linalg.norm(v, axis=-1)
    scale = float(max_mag) if max_mag else max(float(mag.max()), 1e-6)
    ang = np.arctan2(-v[..., 0], -v[..., 1])      # image convention: y down
    h = (ang / np.pi + 1.0) / 2.0                 # [0, 1)
    s = np.clip(mag / scale, 0.0, 1.0)
    # inline HSV->RGB (value=1): no per-pixel colorsys loop
    i = np.floor(h * 6.0).astype(int) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p, q, t = 1.0 - s, 1.0 - f * s, 1.0 - (1.0 - f) * s
    one = np.ones_like(s)
    lut = np.stack([
        np.stack([one, t, p], -1), np.stack([q, one, p], -1),
        np.stack([p, one, t], -1), np.stack([p, q, one], -1),
        np.stack([t, p, one], -1), np.stack([one, p, q], -1),
    ], 0)
    return np.take_along_axis(lut, i[None, ..., None], axis=0)[0]


def show_halfway(i0, i1, v, points: Optional[np.ndarray] = None, ax=None, device=None):
    """Render the halfway view (and the correspondence anchors) with
    matplotlib. Returns the image array; draws it when matplotlib is
    available."""
    img = halfway_image(i0, i1, v, device)
    plt = _plt()
    if plt is not None:
        if ax is None:
            _, ax = plt.subplots(figsize=(7, 7 * img.shape[0] / img.shape[1]))
        ax.imshow(np.clip(img, 0, 1))
        if points is not None and len(points):
            pts = np.asarray(points)
            anchors = 0.5 * (pts[:, 0] + pts[:, 1])
            ax.scatter(anchors[:, 1], anchors[:, 0], c="lime", s=30, marker="+")
        ax.set_title("halfway domain (ghosting = correspondence error)")
        ax.axis("off")
    return img


def show_morph_strip(frames, n: int = 6, ax=None) -> np.ndarray:
    """Horizontally concatenate ``n`` evenly spaced frames into one strip
    (``frames``: numpy or a tensor, copied down once)."""
    frames = frames.detach().cpu().numpy() if isinstance(frames, torch.Tensor) else np.asarray(frames)
    idx = np.linspace(0, frames.shape[0] - 1, min(n, frames.shape[0])).round().astype(int)
    strip = np.concatenate([frames[i] for i in idx], axis=1)
    plt = _plt()
    if plt is not None:
        if ax is None:
            _, ax = plt.subplots(figsize=(2 * len(idx), 2))
        ax.imshow(np.clip(strip, 0, 1))
        ax.axis("off")
    return strip
