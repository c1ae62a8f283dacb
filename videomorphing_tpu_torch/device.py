"""Device selection and float32 policy.

Importing this module turns TF32 off for matrix products and convolutions:
the solver's descent directions and the DCT blends are float32 algorithms,
and TF32 keeps about three decimal digits.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def require_cuda() -> torch.device:
    """The first CUDA device; raises when there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return torch.device("cuda", 0)


def as_device(device) -> torch.device:
    """Normalize a ``device=`` argument; ``None`` means the first card (and
    raises without one): the CPU runs only when asked for."""
    if device is None:
        return require_cuda()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def pick_device(device, like=None) -> torch.device:
    """Where an entry point runs: ``device`` when given, else the card of
    ``like`` when it is a CUDA tensor, else the first card (raises without
    one)."""
    if device is None and isinstance(like, torch.Tensor) and like.device.type == "cuda":
        return like.device
    return as_device(device)
