"""Multi-process execution of batch workloads over ``torch.distributed``
(port of ``videomorphing_tpu/parallel/multihost.py``).

Every process runs the same program: :func:`initialize` joins the process
group, :func:`global_mesh` gives the mesh of this process's devices, and
pure data-parallel batch work shards by process through
:func:`process_shard`, with no communication at all: each process streams,
solves and encodes its share of a manifest.

``initialize`` reads the reference's variables (``JAX_COORDINATOR_ADDRESS``
as ``host:port``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), so one launch
script drives either package; the group uses NCCL when the process's
device is a card and gloo on the CPU.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from videomorphing_tpu_torch.device import as_device
from videomorphing_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> Tuple[int, int]:
    """Join the process group, or do nothing in a single-process run.

    The arguments default to ``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``; with fewer than two
    processes this is a no-op. ``device`` (default: the card, as every
    entry point) picks the backend: NCCL for a card, gloo for the CPU.
    Returns ``(process_id, num_processes)``.
    """
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address and num_processes and num_processes > 1 and not dist.is_initialized():
        if process_id is None:
            raise ValueError("a multi-process run needs JAX_PROCESS_ID (or process_id=)")
        dev = as_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes,
            rank=process_id,
        )
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(axis_name: str = "batch", devices=None) -> Mesh:
    """1-D mesh of this process's devices (default: every visible card).

    The reference's mesh spans every device of every process, because one
    JAX program drives them all. A torch process addresses only its own
    cards, and the data-parallel tier needs nothing more: each process
    runs its :func:`process_shard` of the jobs on its own mesh.
    """
    return make_mesh(axis_names=(axis_name,), devices=devices)


def process_shard(items: Sequence, process_id: Optional[int] = None,
                  num_processes: Optional[int] = None) -> List:
    """This process's contiguous share of a global work list: with ``n``
    processes, ``ceil(len / n)`` items each (the last ones fewer)."""
    joined = dist.is_available() and dist.is_initialized()
    pid = (dist.get_rank() if joined else 0) if process_id is None else process_id
    n = (dist.get_world_size() if joined else 1) if num_processes is None else num_processes
    per = -(-len(items) // n)
    return list(items[pid * per : (pid + 1) * per])
