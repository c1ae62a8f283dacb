"""The benchmark's plain reference of the pair and clip morphs.

A frozen copy of the program's plain PyTorch path (the solve, the flows and
tracking, the warm frame loop, the synthesis), float32 throughout, that
imports nothing of the program. The modules keep the program's
docstrings; where they speak of a kernel, this copy runs its plain
version (``vmbench.reference.kernels``). :func:`full_float32` turns TF32 off for
matrix products and convolutions, as the configurations state; importing
the package calls it, and every check calls it again before it computes.
"""

import torch


def full_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


full_float32()
