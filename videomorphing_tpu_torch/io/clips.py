"""Clip I/O: frame directories (PNG), .npz/.npy stacks, the raw .vmc frame
store, .y4m video and (gated) ffmpeg video files.

A copy of ``videomorphing_tpu/io/clips.py`` (numpy only) with its imports
pointed at this package. ``.vmc`` is a trivial raw frame store (16-byte
header + contiguous uint8 frames) made for mmap-based streaming.
``open_clip_reader`` returns a block iterator so long clips never need to
fit in host memory at once; it reads with numpy (the reference's native
prefetching reader waits for the port's batch runner, ROADMAP queue 1
item 16).
"""

from __future__ import annotations

import glob
import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

from videomorphing_tpu_torch.io.images import load_image, save_image, to_float, to_uint8

_VMC_MAGIC = b"VMC1"
_VMC_HEADER = struct.Struct("<4sIIII")  # magic, T, H, W, C  (uint8 frames)


def write_vmc(path: str, frames: np.ndarray) -> None:
    """Write (T, H, W, C) frames (float [0,1] or uint8) as a raw frame store."""
    arr = frames if frames.dtype == np.uint8 else to_uint8(frames)
    t, h, w, c = arr.shape
    with open(path, "wb") as f:
        f.write(_VMC_HEADER.pack(_VMC_MAGIC, t, h, w, c))
        f.write(np.ascontiguousarray(arr).tobytes())


class VmcWriter:
    """Incremental .vmc writer for streaming pipelines (config 5 encode side).

    Frames append block-by-block; the frame-count field of the header is
    back-patched on close, so a morph's output streams to disk while the
    device is still computing later blocks.
    """

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._t = 0
        self._hwc: Optional[Tuple[int, int, int]] = None
        self._f.write(_VMC_HEADER.pack(_VMC_MAGIC, 0, 0, 0, 0))

    def append(self, frames: np.ndarray) -> None:
        arr = frames if frames.dtype == np.uint8 else to_uint8(frames)
        if arr.ndim == 3:
            arr = arr[None]
        hwc = arr.shape[1:]
        if self._hwc is None:
            self._hwc = hwc
        elif hwc != self._hwc:
            raise ValueError(f"frame shape changed: {hwc} != {self._hwc}")
        self._f.write(np.ascontiguousarray(arr).tobytes())
        self._t += arr.shape[0]

    def close(self) -> None:
        if self._f is None:
            return
        h, w, c = self._hwc if self._hwc is not None else (0, 0, 0)
        self._f.seek(0)
        self._f.write(_VMC_HEADER.pack(_VMC_MAGIC, self._t, h, w, c))
        self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_vmc_header(path: str) -> Tuple[int, int, int, int]:
    with open(path, "rb") as f:
        magic, t, h, w, c = _VMC_HEADER.unpack(f.read(_VMC_HEADER.size))
    if magic != _VMC_MAGIC:
        raise ValueError(f"{path} is not a .vmc frame store")
    return t, h, w, c


def read_vmc(path: str, start: int = 0, count: Optional[int] = None) -> np.ndarray:
    """Read frames [start, start+count) as float32; mmap-backed, zero-copy
    until the float conversion."""
    t, h, w, c = read_vmc_header(path)
    count = t - start if count is None else min(count, t - start)
    frame_bytes = h * w * c
    mm = np.memmap(
        path, dtype=np.uint8, mode="r",
        offset=_VMC_HEADER.size + start * frame_bytes,
        shape=(count, h, w, c),
    )
    return to_float(np.asarray(mm))


def load_clip(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Load a whole clip as float32 (T, H, W, C) from any supported source."""
    if os.path.isdir(path):
        files = sorted(
            glob.glob(os.path.join(path, "*.png"))
            + glob.glob(os.path.join(path, "*.jpg"))
            + glob.glob(os.path.join(path, "*.jpeg"))
        )
        if not files:
            raise FileNotFoundError(f"no frames in {path}")
        return np.stack([load_image(f, size) for f in files])
    if path.endswith(".npz"):
        frames = np.load(path)["frames"]
        return to_float(frames)
    if path.endswith(".npy"):
        return to_float(np.load(path))
    if path.endswith(".vmc"):
        return read_vmc(path)
    if path.endswith(".y4m"):
        from videomorphing_tpu_torch.io.y4m import read_y4m

        return read_y4m(path)
    if path.endswith((".mp4", ".avi", ".mov", ".webm")):
        return _load_video_ffmpeg(path, size)
    raise ValueError(f"unsupported clip source: {path}")


def save_clip(path: str, frames: np.ndarray, fps: int = 30) -> None:
    """Save (T, H, W, C) float frames to a directory / .npz / .vmc / .y4m."""
    frames = np.asarray(frames)
    if path.endswith(".npz"):
        np.savez_compressed(path, frames=to_uint8(frames))
        return
    if path.endswith(".vmc"):
        write_vmc(path, frames)
        return
    if path.endswith(".y4m"):
        from videomorphing_tpu_torch.io.y4m import write_y4m

        write_y4m(path, frames, fps=(int(fps), 1))
        return
    os.makedirs(path, exist_ok=True)
    for k in range(frames.shape[0]):
        save_image(os.path.join(path, f"frame_{k:05d}.png"), frames[k])


def open_clip_reader(path: str, block: int = 8):
    """Iterate (start_index, frames_block) over a clip without loading it
    all (.vmc and .y4m; other sources load whole and are cut into blocks)."""
    if path.endswith(".vmc"):
        return _vmc_blocks(path, block)
    if path.endswith(".y4m"):
        return _y4m_blocks(path, block)
    clip = load_clip(path)

    def gen():
        for s in range(0, clip.shape[0], block):
            yield s, clip[s : s + block]

    return gen()


def _vmc_blocks(path: str, block: int) -> Iterator[Tuple[int, np.ndarray]]:
    t, _, _, _ = read_vmc_header(path)
    for s in range(0, t, block):
        yield s, read_vmc(path, s, block)


def _y4m_blocks(path: str, block: int) -> Iterator[Tuple[int, np.ndarray]]:
    from videomorphing_tpu_torch.io.y4m import iter_y4m

    buf, s = [], 0
    for frame in iter_y4m(path):
        buf.append(frame)
        if len(buf) == block:
            yield s, np.stack(buf)
            s += block
            buf = []
    if buf:
        yield s, np.stack(buf)


def _load_video_ffmpeg(path: str, size) -> np.ndarray:
    """Decode via an ffmpeg subprocess when one exists on PATH (gated: this
    image ships none — SURVEY.md section 2 L6)."""
    import shutil
    import subprocess

    ffmpeg = shutil.which("ffmpeg")
    ffprobe = shutil.which("ffprobe")
    if not ffmpeg or not ffprobe:
        raise RuntimeError(
            "ffmpeg not available in this environment; convert the clip to a "
            "frame directory, .npz, or .vmc store instead"
        )
    probe = subprocess.run(
        [ffprobe, "-v", "error", "-select_streams", "v:0",
         "-show_entries", "stream=width,height", "-of", "csv=p=0", path],
        capture_output=True, text=True, check=True,
    )
    w, h = (int(x) for x in probe.stdout.strip().split(","))
    if size is not None:
        h, w = size
    cmd = [ffmpeg, "-i", path, "-f", "rawvideo", "-pix_fmt", "rgb24"]
    if size is not None:
        cmd += ["-s", f"{w}x{h}"]
    cmd += ["-"]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    frames = np.frombuffer(raw, np.uint8).reshape(-1, h, w, 3)
    return to_float(frames)
