"""A device mesh of one process (port of ``videomorphing_tpu/parallel/mesh.py``).

A :class:`Mesh` holds a tuple of ``torch.device``s (repeats allowed), the
names of its axes and their sizes. ``make_mesh`` takes the reference's
arguments; by default it spans every visible card.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from videomorphing_tpu_torch.device import as_device, require_cuda


class Mesh:
    """Devices laid out over named axes (row-major, the last axis fastest)."""

    def __init__(self, devices: Sequence, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        self.devices: Tuple[torch.device, ...] = tuple(as_device(d) for d in devices)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        sizes = tuple(int(n) for n in axis_sizes)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"{len(sizes)} axis sizes for axes {self.axis_names}")
        if int(np.prod(sizes)) != len(self.devices):
            raise ValueError(f"axis sizes {sizes} do not hold {len(self.devices)} devices")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis`` of a 1-D mesh, in order."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r}; axes {self.axis_names}")
        if len(self.axis_names) != 1:
            raise NotImplementedError(
                "only 1-D meshes are ported (the 2-D batch x rows layout is ROADMAP queue 1 item 8)"
            )
        return self.devices

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.shape})"


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("batch",),
    devices=None,
) -> Mesh:
    """A mesh over ``devices`` (default: every visible card; raises without
    one). Pass ``devices=["cpu"] * n`` for an n-device CPU mesh, or one card
    repeated for row blocks on a single card. ``axis_sizes`` defaults to
    one axis over all the devices; the mesh takes the first
    ``prod(axis_sizes)`` of them."""
    if devices is None:
        require_cuda()
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if axis_sizes is None:
        axis_sizes = (len(devices),)
    n = int(np.prod(axis_sizes))
    if n > len(devices):
        raise ValueError(f"axis sizes {tuple(axis_sizes)} need {n} devices, {len(devices)} given")
    return Mesh(devices[:n], axis_sizes, axis_names)


def as_mesh(mesh) -> Mesh:
    """``mesh`` checked to be a :class:`Mesh`."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    return mesh
