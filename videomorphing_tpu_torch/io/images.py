"""Still-image I/O via PIL, imported only when an image is read or written.

A copy of ``videomorphing_tpu/io/images.py`` (numpy only).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def to_float(arr: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 [0, 1] (no-op for float input)."""
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    return arr.astype(np.float32)


def to_uint8(arr: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(arr), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def load_image(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Load an image as float32 (H, W, 3) in [0, 1]; optional (H, W) resize."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize((size[1], size[0]), Image.BILINEAR)
    return to_float(np.asarray(img))


def save_image(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(to_uint8(arr)).save(path)
