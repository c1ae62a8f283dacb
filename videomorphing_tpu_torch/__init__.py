"""videomorphing_tpu_torch — the image-pair and video morphs on PyTorch and CUDA.

A port of ``videomorphing_tpu`` (the JAX reference, which stays beside it)
to one NVIDIA Hopper GPU. Public functions keep the reference's layouts:
images ``(H, W, C)`` float32, clips ``(T, H, W, C)``, fields ``(H, W, 2)``
and flows ``(T-1, H, W, 2)`` in ``(y, x)`` order, correspondences
``(N, 2, 2)`` or a keyframe dict ``{frame: (N, 2, 2)}``. The reference's four Pallas kernels are
hand-written CUDA C++ for ``sm_90a`` (``csrc/``, bound in ``kernels/``).

Dispatch rule: a kernel wrapper runs its plain PyTorch version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
This package never imports ``jax``.
"""

from videomorphing_tpu_torch import device as _device  # noqa: F401  (TF32 off)
from videomorphing_tpu_torch.config import MorphParams, SynthParams, VideoParams

__version__ = "0.1.0"

__all__ = ["MorphParams", "SynthParams", "VideoParams", "__version__"]
