"""Row-halo exchange between row blocks (port of
``videomorphing_tpu/parallel/halo.py``).

The reference exchanges a few rows with two ``lax.ppermute`` shifts; here
the blocks are tensors of one process, each on its device, and a halo is a
row copy from the neighbouring block to the block's device. The frame's top
and bottom receive zero rows, which reproduces the unsharded zero-padded
window sums.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def halo_exchange_rows(blocks: Sequence[torch.Tensor], halo: int) -> List[torch.Tensor]:
    """Extend each (bh, ...) block with ``halo`` rows from each neighbour:
    (bh + 2 halo, ...) blocks, zero rows beyond the first and last block."""
    n = len(blocks)
    out = []
    for i, blk in enumerate(blocks):
        zeros = blk.new_zeros((halo,) + tuple(blk.shape[1:]))
        top = blocks[i - 1][-halo:].to(blk.device) if i > 0 else zeros
        bottom = blocks[i + 1][:halo].to(blk.device) if i < n - 1 else zeros
        out.append(torch.cat([top, blk, bottom], 0))
    return out
