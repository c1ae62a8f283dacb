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
- ``video_blocks.py``: the blocked clip solve.

Each device's share runs in turn from this process; across several cards
the launches overlap as far as the host issues them. The multi-process
tier (``batch.py``, ``multihost.py``) is not ported (ROADMAP item 16).
"""
