"""ctypes bindings to the native host streaming runtime (port of
``videomorphing_tpu/utils/native.py``).

``native/vmio.cpp`` mmaps a ``.vmc`` frame store and converts its uint8
frames to float32 blocks in producer threads, into a ring buffer that runs
ahead of the consumer (BASELINE.json config 5, "streaming decode").

The repo's ``native/libvmio.so`` was built with ``-march=native`` on
another host and may die on an illegal instruction here, so the port never
loads it and never writes under ``native/``: it compiles ``native/vmio.cpp``
with the flags of ``native/Makefile`` into
``build/vmio/<digest of the source, the flags and the host's instruction
set>/libvmio.so`` at the root of the checkout at first use, as ``kernels/build.py`` builds the CUDA
sources. Without a C++ compiler :func:`ensure_built` returns False (the
readers then use :func:`u8_to_f32_plain`, which rounds as the library
does); a failed compile raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "vmio.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "vmio"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared"]

# the library's conversion: the float32 product of the value and 1.0f / 255.0f
# (one float32 ulp from to_float's division on about half of the 256 values)
_RECIP_255 = np.float32(1.0) / np.float32(255.0)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_cxx() -> Optional[str]:
    """The C++ compiler: ``$CXX``, else ``g++`` or ``c++`` on ``PATH``."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = shutil.which(name) if name else None
        if found:
            return found
    return None


def _host_isa() -> bytes:
    """What ``-march=native`` compiles for: the machine and, on Linux, the
    CPU's feature flags, so a build directory copied to another host is
    not loaded there."""
    flags = b""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            flags = next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        pass
    return platform.machine().encode() + flags


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(_host_isa())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libvmio.so"


def ensure_built(quiet: bool = True) -> bool:
    """Build ``libvmio.so`` unless it is built; True when it exists, False
    when there is no C++ compiler. A failed compile raises with the
    compiler's output (printed as well unless ``quiet``)."""
    out = library_path()
    if out.is_file():
        return True
    cxx = find_cxx()
    if cxx is None:
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"libvmio.so.{os.getpid()}.tmp")
    cmd = [cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if not quiet:
        print(" ".join(cmd) + "\n" + proc.stdout + proc.stderr, file=sys.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return True


def load_lib() -> ctypes.CDLL:
    """The bound library, built at first use; ImportError without a C++
    compiler (as the reference's, when its library is missing)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not ensure_built():
            raise ImportError("no C++ compiler: native/vmio.cpp cannot be built")
        lib = ctypes.CDLL(str(library_path()))
        lib.vmio_open.restype = ctypes.c_void_p
        lib.vmio_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.vmio_info.restype = None
        lib.vmio_info.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int)] * 5
        lib.vmio_next.restype = ctypes.c_int
        lib.vmio_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)]
        lib.vmio_close.restype = None
        lib.vmio_close.argtypes = [ctypes.c_void_p]
        lib.vmio_u8_to_f32.restype = None
        lib.vmio_u8_to_f32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ]
        _lib = lib
        return lib


class VmcStream:
    """Iterator of ``(start_frame, float32 block (K, H, W, C))`` from the
    native prefetching ring buffer; ``kind`` is ``"native"``. The stream
    closes after its last block (or on :meth:`close`)."""

    kind = "native"

    def __init__(self, path: str, block: int = 8, n_threads: int = 4):
        self._lib = load_lib()
        self._h = self._lib.vmio_open(os.fsencode(path), block, n_threads)
        if not self._h:
            raise IOError(f"vmio_open failed for {path}")
        t, hh, ww, cc, bb = (ctypes.c_int() for _ in range(5))
        self._lib.vmio_info(self._h, t, hh, ww, cc, bb)
        self.shape: Tuple[int, int, int, int] = (t.value, hh.value, ww.value, cc.value)
        self.block = bb.value

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        _t, h, w, c = self.shape
        buf = np.empty((self.block, h, w, c), np.float32)
        start = ctypes.c_int()
        while self._h:
            n = self._lib.vmio_next(self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), start)
            if n == 0:
                break
            yield start.value, buf[:n].copy()
        self.close()

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.vmio_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def u8_to_f32_plain(arr: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [0, 1] with the native library's rounding."""
    return np.asarray(arr, np.uint8).astype(np.float32) * _RECIP_255


def u8_to_f32(arr: np.ndarray, n_threads: int = 4) -> np.ndarray:
    """Native row-parallel uint8 -> float32 [0, 1] conversion."""
    lib = load_lib()
    src = np.ascontiguousarray(arr, np.uint8)
    out = np.empty(src.shape, np.float32)
    lib.vmio_u8_to_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        src.size,
        n_threads,
    )
    return out
