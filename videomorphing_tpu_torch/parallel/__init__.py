"""Distribution over the devices of one process (port of
``videomorphing_tpu/parallel``).

The reference's ``shard_map`` is one process driving every device of a
``Mesh``; so is this package. A :class:`mesh.Mesh` lists torch devices and
may repeat one, so ``[cuda:0] * 4`` is four row blocks on one card (the
counterpart of the reference's 8 virtual CPU devices in its tests).

- ``halo.py``: the row-halo exchange, a row copy between neighbouring
  block tensors;
- ``spatial.py``: the row-sharded level solve and the coarse-to-fine pair
  solve of one large frame; the ``psum`` of the energy partials is a
  fixed-order sum over the blocks;
- ``frames.py``: frames and pairs split over the devices;
- ``video_blocks.py``: the blocked clip solve;
- ``batch.py``: config 5's batch pipeline, pair jobs and streamed clip
  pairs in mesh-sized blocks;
- ``multihost.py``: one process per host over ``torch.distributed``, each
  taking its share of a batch.

Each device's share runs in turn from this process; across several cards
the launches overlap as far as the host issues them.
"""

from videomorphing_tpu_torch.parallel.mesh import make_mesh
from videomorphing_tpu_torch.parallel.halo import halo_exchange_rows
from videomorphing_tpu_torch.parallel.frames import (
    render_clip_sharded,
    optimize_pairs_batched,
)
from videomorphing_tpu_torch.parallel.spatial import make_spatial_level_solver

# Names of the reference's __all__ that are jax.sharding objects: not ported
# (a Mesh here lists torch devices, and each function places its own tensors).
NOT_PORTED = ("batch_sharding", "replicated_sharding")

__all__ = [
    "make_mesh",
    "halo_exchange_rows",
    "render_clip_sharded",
    "optimize_pairs_batched",
    "make_spatial_level_solver",
]
