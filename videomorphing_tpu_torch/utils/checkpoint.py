"""Checkpoint / resume: the converged-field store (SURVEY.md section 6).

A copy of ``videomorphing_tpu/utils/checkpoint.py`` (numpy only); a store
written by either package reads in the other.

The reference caches converged halfway fields so rendering can rerun without
re-optimizing; long jobs resume at the last completed frame block. Same two
artifacts here: the project JSON (inputs/points/weights) plus this .npz
field store ``{v: (T,H,W,2), b: (T,H,W,2), done: (T,)}``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


class FieldStore:
    """Per-clip store of converged fields with frame-granular resume."""

    def __init__(self, path: str):
        self.path = path
        self._v: Optional[np.ndarray] = None
        self._b: Optional[np.ndarray] = None
        self._done: Optional[np.ndarray] = None
        if os.path.exists(path):
            with np.load(path) as z:
                self._v = z["v"]
                self._b = z["b"] if "b" in z else None
                self._done = z["done"]

    def init(self, t_len: int, h: int, w: int) -> None:
        if self._v is None or self._v.shape[:3] != (t_len, h, w):
            self._v = np.zeros((t_len, h, w, 2), np.float32)
            self._b = np.zeros((t_len, h, w, 2), np.float32)
            self._done = np.zeros((t_len,), bool)

    @property
    def done(self) -> np.ndarray:
        return self._done if self._done is not None else np.zeros((0,), bool)

    def first_pending(self) -> int:
        if self._done is None:
            return 0
        nz = np.flatnonzero(~self._done)
        return int(nz[0]) if len(nz) else int(len(self._done))

    def fields(self) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        return self._v, self._b

    def put(self, idx, v, b=None) -> None:
        idx = np.atleast_1d(np.asarray(idx))
        self._v[idx] = np.asarray(v, np.float32)
        if b is not None:
            self._b[idx] = np.asarray(b, np.float32)
        self._done[idx] = True

    def save(self) -> None:
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp.npz"
        np.savez_compressed(tmp, v=self._v, b=self._b, done=self._done)
        os.replace(tmp, self.path)
