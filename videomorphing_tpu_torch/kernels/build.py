"""Build and load the hand-written CUDA kernels of ``csrc/``.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
-fPIC -c`` compiles every ``csrc/*.cu`` (and nothing else), one nvcc per
source, all started together, and ``nvcc -shared`` links the objects into
one shared library with a plain C interface, bound here with ``ctypes``.
The library is built at first use into
``build/vmorph_kernels/<hash of sources>/libvmorph_kernels.so`` at the root
of the checkout, so a changed source builds anew and an unchanged one is
reused. A missing ``nvcc`` or a failed compile raises with the compiler's
output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "vmorph_kernels"
LIB_NAME = "libvmorph_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(list(CSRC_DIR.glob("*.cu")) + list(CSRC_DIR.glob("*.cuh")))


def find_nvcc() -> str:
    """``nvcc`` from ``PATH`` or ``$CUDA_HOME/bin`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file() and os.access(cand, os.X_OK):
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels of "
        "videomorphing_tpu_torch cannot be built"
    )


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _digest(sources()) / LIB_NAME


def build() -> Path:
    """Compile the library unless this exact source set is already built;
    the compiler's output (with ``-Xptxas -v``) goes to ``build.log`` beside
    it."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    jobs = []
    for src in (p for p in sources() if p.suffix == ".cu"):
        obj = out.with_name(f"{src.stem}.{os.getpid()}.o")  # nvcc links by the .o suffix
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log = ""
    failed = None
    for cmd, _obj, proc in jobs:
        log += proc.communicate()[0]
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd)
    if failed is None:
        cmd = [nvcc, NVCC_FLAGS[0], NVCC_FLAGS[1], "-shared", "-o", str(tmp),
               *(str(obj) for _cmd, obj, _proc in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed = (proc.returncode, cmd)
    for _cmd, obj, _proc in jobs:
        obj.unlink(missing_ok=True)
    if failed is not None:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{' '.join(failed[1])}\n{log}")
    (out.parent / "build.log").write_text(log)
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sigs = {
        "vm_halfway_warp": [P, P, P, P, I, I, I, I, I, I, P],
        "vm_bilinear_sample": [P, P, P, I, I, I, I, L, I, P],
        "vm_hs_sweep": [P] * 7 + [I, I, I, P],
        "vm_sweep_grad": [P] * 10 + [I, P, L] + [P] * 3,
        "vm_sweep_energy": [P] * 8 + [I, P, L] + [P] * 3,
        "vm_sweep_grad_bf16": [P] * 10 + [I, P, L] + [P] * 3,
        "vm_sweep_energy_bf16": [P] * 8 + [I, P, L] + [P] * 3,
        "vm_sweep_n_partials": [I, I, I, I],
        "vm_sweep_scratch_floats": [I, I, I, I],
        "vm_sweep_kernel_info": [I, I, I, P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = L if name == "vm_sweep_scratch_floats" else I
    return lib


def load() -> ctypes.CDLL:
    """The bound kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
