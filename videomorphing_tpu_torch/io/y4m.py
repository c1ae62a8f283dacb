"""YUV4MPEG2 (.y4m) clip reader/writer — real video files without a codec.

A copy of ``videomorphing_tpu/io/y4m.py`` (numpy only).

The reference writes morphs through OpenCV's ``VideoWriter`` (SURVEY.md
section 3 "Video I/O"); this environment ships neither OpenCV nor ffmpeg,
so compressed formats are gated (io/clips.py). Y4M fills the product gap
honestly: a plain-text header plus raw YUV frames, universally playable
(mpv/VLC/ffmpeg all read it) and written/read here with vectorized NumPy
only. Exports default to 4:4:4 chroma (``C444`` — lossless up to the
BT.601 rounding, no subsampling pass needed); ``C420jpeg`` is available
for players/tools that insist on 4:2:0.

Color math: limited-range (studio-swing) BT.601, the assumed matrix for
headerless YUV streams. RGB in [0, 1] -> Y in [16, 235], U/V in [16, 240].
"""

from __future__ import annotations

import os
import re
from typing import Iterator, Optional, Tuple

import numpy as np

_MAGIC = b"YUV4MPEG2"

# limited-range BT.601 (rows: Y, U, V; cols: R, G, B), offsets (16, 128, 128)
_RGB2YUV = np.array(
    [
        [65.481, 128.553, 24.966],
        [-37.797, -74.203, 112.0],
        [112.0, -93.786, -18.214],
    ],
    dtype=np.float32,
)
_YUV_OFF = np.array([16.0, 128.0, 128.0], dtype=np.float32)
_YUV2RGB = np.linalg.inv(_RGB2YUV).astype(np.float32)


def _to_yuv(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) float RGB in [0,1] -> (H, W, 3) uint8 limited-range YUV."""
    yuv = rgb.astype(np.float32) @ _RGB2YUV.T + _YUV_OFF
    return np.clip(np.rint(yuv), 0, 255).astype(np.uint8)


def _to_rgb(yuv: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 limited-range YUV -> (H, W, 3) float32 RGB in [0,1]."""
    rgb = (yuv.astype(np.float32) - _YUV_OFF) @ _YUV2RGB.T
    return np.clip(rgb, 0.0, 1.0)


def _prep_rgb(frame: np.ndarray) -> np.ndarray:
    """Accept float [0,1] or uint8, gray or RGB(A); return float RGB."""
    f = frame.astype(np.float32) / 255.0 if frame.dtype == np.uint8 else frame
    if f.ndim == 2:
        f = f[..., None]
    if f.shape[-1] == 1:
        f = np.repeat(f, 3, axis=-1)
    return f[..., :3]


def _subsample_420(plane: np.ndarray) -> np.ndarray:
    """2x2 box average (the 'jpeg' chroma siting) of an even-sized plane."""
    h, w = plane.shape
    p = plane.astype(np.float32).reshape(h // 2, 2, w // 2, 2)
    return np.clip(np.rint(p.mean(axis=(1, 3))), 0, 255).astype(np.uint8)


def _upsample_420(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.repeat(np.repeat(plane, 2, axis=0), 2, axis=1)[:h, :w]


class Y4mWriter:
    """Incremental .y4m writer (streaming counterpart of io.clips.VmcWriter).

    Frames append one block at a time so a clip-morph export overlaps the
    device computing later blocks; the header is emitted on the first
    frame (Y4M needs W/H up front, nothing is back-patched).
    """

    def __init__(self, path: str, fps: Tuple[int, int] = (30, 1), chroma: str = "444"):
        if chroma not in ("444", "420jpeg"):
            raise ValueError(f"unsupported chroma mode: {chroma!r}")
        self._f = open(path, "wb")
        self._fps = fps
        self._chroma = chroma
        self._hw: Optional[Tuple[int, int]] = None

    def _write_header(self, h: int, w: int) -> None:
        if self._chroma == "420jpeg" and (h % 2 or w % 2):
            raise ValueError(f"C420jpeg needs even dimensions, got {h}x{w}")
        num, den = self._fps
        self._f.write(
            f"YUV4MPEG2 W{w} H{h} F{num}:{den} Ip A1:1 C{self._chroma}\n".encode()
        )
        self._hw = (h, w)

    def append(self, frames: np.ndarray) -> None:
        frames = np.asarray(frames)
        if frames.ndim == 3:
            frames = frames[None]
        for frame in frames:
            rgb = _prep_rgb(frame)
            h, w = rgb.shape[:2]
            if self._hw is None:
                self._write_header(h, w)
            elif (h, w) != self._hw:
                raise ValueError(f"frame size changed: {(h, w)} != {self._hw}")
            yuv = _to_yuv(rgb)
            self._f.write(b"FRAME\n")
            if self._chroma == "444":
                for c in range(3):
                    self._f.write(np.ascontiguousarray(yuv[..., c]).tobytes())
            else:
                self._f.write(np.ascontiguousarray(yuv[..., 0]).tobytes())
                self._f.write(_subsample_420(yuv[..., 1]).tobytes())
                self._f.write(_subsample_420(yuv[..., 2]).tobytes())
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_y4m(
    path: str,
    frames: np.ndarray,
    fps: Tuple[int, int] = (30, 1),
    chroma: str = "444",
) -> None:
    """Write (T, H, W, C) float [0,1] or uint8 frames as a .y4m video."""
    frames = np.asarray(frames)
    with Y4mWriter(path, fps=fps, chroma=chroma) as wr:
        if frames.ndim == 4 and frames.shape[0] == 0:
            # zero-frame clip: still emit a valid header (shape is known),
            # so the file round-trips like the npz/vmc formats do
            wr._write_header(frames.shape[1], frames.shape[2])
        else:
            wr.append(frames)


def read_y4m_header(path: str) -> Tuple[int, int, int, str, Tuple[int, int]]:
    """Return (T, H, W, chroma, fps).

    T comes from walking the frame markers with seeks (no payload reads):
    the spec allows per-frame parameters after ``FRAME``, so a fixed
    6-byte-marker size division would overcount third-party files."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        line = f.readline()
        if not line.startswith(_MAGIC):
            raise ValueError(f"{path} is not a YUV4MPEG2 stream")
        fields = line.decode("ascii", "replace").strip().split(" ")[1:]
        w = h = None
        chroma = "420jpeg"  # the spec's default when no C tag is present
        fps = (30, 1)
        for tok in fields:
            if tok.startswith("W"):
                w = int(tok[1:])
            elif tok.startswith("H"):
                h = int(tok[1:])
            elif tok.startswith("C"):
                chroma = tok[1:]
            elif tok.startswith("F"):
                m = re.match(r"F(\d+):(\d+)", tok)
                if m:
                    fps = (int(m.group(1)), int(m.group(2)))
        if w is None or h is None:
            raise ValueError(f"{path}: Y4M header missing W/H")
        fsz = _frame_bytes(h, w, chroma)
        t = 0
        while True:
            marker = f.readline()
            if not marker or not marker.startswith(b"FRAME"):
                break
            if f.seek(fsz, os.SEEK_CUR) > size:
                break  # truncated final frame
            t += 1
    return t, h, w, chroma, fps


def _frame_bytes(h: int, w: int, chroma: str) -> int:
    if chroma == "444":
        return 3 * h * w
    if chroma.startswith("420"):
        return h * w + 2 * ((h // 2) * (w // 2))
    raise ValueError(f"unsupported Y4M chroma mode: C{chroma}")


def iter_y4m(path: str) -> Iterator[np.ndarray]:
    """Yield float32 RGB (H, W, 3) frames one at a time (streaming read)."""
    t, h, w, chroma, _fps = read_y4m_header(path)
    fsz = _frame_bytes(h, w, chroma)
    with open(path, "rb") as f:
        f.readline()  # header
        while True:
            marker = f.readline()
            if not marker:
                return
            if not marker.startswith(b"FRAME"):
                raise ValueError(f"{path}: bad frame marker {marker[:16]!r}")
            raw = f.read(fsz)
            if len(raw) < fsz:
                return
            if chroma == "444":
                yuv = np.frombuffer(raw, np.uint8).reshape(3, h, w)
                yield _to_rgb(np.moveaxis(yuv, 0, -1))
            else:
                ysz, csz = h * w, (h // 2) * (w // 2)
                y = np.frombuffer(raw[:ysz], np.uint8).reshape(h, w)
                u = np.frombuffer(raw[ysz : ysz + csz], np.uint8).reshape(h // 2, w // 2)
                v = np.frombuffer(raw[ysz + csz :], np.uint8).reshape(h // 2, w // 2)
                yuv = np.stack(
                    [y, _upsample_420(u, h, w), _upsample_420(v, h, w)], axis=-1
                )
                yield _to_rgb(yuv)


def read_y4m(path: str) -> np.ndarray:
    """Read a whole .y4m clip as float32 (T, H, W, 3)."""
    frames = list(iter_y4m(path))
    if not frames:
        t, h, w, *_ = read_y4m_header(path)
        return np.zeros((0, h, w, 3), np.float32)
    return np.stack(frames)
