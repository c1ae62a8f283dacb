"""Hand-written CUDA kernels (``csrc/``): build, bindings and plain versions.

The kernel wrappers launch their kernel on CUDA tensors and run their plain
PyTorch version on CPU tensors:

- kernels 1 and 2, the sweep gradient and energy (``kernels.sweep``):
  ``sweep_grad``, ``sweep_energy`` and their row-shard forms
  ``sweep_grad_shard``, ``sweep_energy_shard``;
- kernel 3, the halfway warp (``kernels.warp``): ``halfway_warp`` and its
  row-offset form ``halfway_warp_rows``;
- kernel 4, the bilinear sampler: ``bilinear_sample`` and
  ``bilinear_sample_batched``;
- kernel 5, the flows' Horn-Schunck Jacobi sweep (``kernels.flow``):
  ``hs_sweep``, which has no counterpart in the reference's kernel layer.

Each wrapper counts its launches in its ``launches*`` attributes;
``COUNTED`` lists the wrappers, for the CUDA graphs' capture and replay
(``graphs.capture``).

``REFERENCE_COUNTERPARTS`` answers the reference's kernel layer
(``videomorphing_tpu/pallas/{__init__,sweep,warp}.py``): each of its public
names maps to the port function that computes the same thing, as a dotted
path, or to the reason the port has none (ROADMAP "Not ported").
"""

from videomorphing_tpu_torch.kernels.flow import hs_sweep
from videomorphing_tpu_torch.kernels.sweep import (
    combine_parts,
    shard_reach,
    sweep_energy,
    sweep_energy_shard,
    sweep_grad,
    sweep_grad_shard,
)
from videomorphing_tpu_torch.kernels.warp import (
    bilinear_sample,
    bilinear_sample_batched,
    halfway_warp,
    halfway_warp_rows,
)

__all__ = [
    "sweep_grad",
    "sweep_energy",
    "sweep_grad_shard",
    "sweep_energy_shard",
    "combine_parts",
    "shard_reach",
    "halfway_warp",
    "halfway_warp_rows",
    "bilinear_sample",
    "bilinear_sample_batched",
    "hs_sweep",
    "REFERENCE_COUNTERPARTS",
]

# the wrappers that count their launches
COUNTED = (sweep_grad, sweep_energy, sweep_grad_shard, sweep_energy_shard, halfway_warp, halfway_warp_rows,
           bilinear_sample, bilinear_sample_batched, hs_sweep)

_PORT = "videomorphing_tpu_torch."
_PACKING = ("not ported: the TPU packing (sweep._pack's column groups for Mosaic's 128-lane DMA); "
            "the port's sweeps read kernel 3's plane stack as it comes")
_SPLIT = "not ported: the split sweep mode, measured and rejected in the reference's round 3"
_PACKED_WARP = ("not ported: fused_warp_planes_packed and MorphParams.warp_into_pack, measured and rejected "
                "in the reference's round 3")
_WARP_DISPATCH = ("not ported: the pallas/warp.py dispatch machinery (WarpSource's row-phase copies, the "
                  "TPU tile geometry, the band fallback): the TPU has no texture units, a CUDA thread "
                  "gathers its own pixel")

# every public name of the reference's kernel layer -> the port's function
# (dotted path) or the reason it has none
REFERENCE_COUNTERPARTS = {
    # pallas/__init__.py and pallas/sweep.py
    "fused_total_energy": _PORT + "solver.energy.total_energy",
    "fused_total_energy_planes": _PORT + "solver.descent.total_energy_planes",
    "fused_value_grad_precond": _PORT + "solver.descent.energy_value_grad_precond",
    "fused_value_grad_precond_planes": _PORT + "solver.descent.value_grad_precond_planes",
    "fused_value_grad_precond_pack": _PORT + "kernels.sweep.sweep_grad",
    "fused_total_energy_pack": _PORT + "kernels.sweep.sweep_energy",
    "fused_grad_parts_shard": _PORT + "kernels.sweep.sweep_grad_shard",
    "fused_energy_parts_shard": _PORT + "kernels.sweep.sweep_energy_shard",
    "combine_energy_parts": _PORT + "kernels.sweep.combine_parts",
    "sweep_row_halo": _PORT + "kernels.sweep.shard_reach",
    "pallas_available": ("not ported: the port has no backend to probe; a wrapper launches its kernel for "
                         "CUDA tensors and runs its plain version for CPU tensors (kernels.warp.on_cuda)"),
    "LANE": _PACKING,
    "quantize_v_lin": _PORT + "kernels.sweep.quantize_v_lin",
    "make_sweep_pack": _PACKING,
    "make_sweep_pack_planes": _PACKING,
    "make_const_pack": _PACKING,
    "pack_v": _PACKING,
    "make_sweep_pack_shard": _PACKING,
    "pack_v_shard": _PACKING,
    "fused_value_grad_precond_split": _SPLIT,
    "fused_total_energy_split": _SPLIT,
    # pallas/warp.py
    "fused_warp_planes": _PORT + "kernels.warp.halfway_warp",
    "fused_warp_pair": _PORT + "solver.descent.warp_bundle_fused",
    "fused_sample": _PORT + "kernels.warp.bilinear_sample_batched",
    "packed_plane_geometry": _PACKED_WARP,
    "fused_warp_planes_packed": _PACKED_WARP,
    "WarpSource": _WARP_DISPATCH,
    "make_warp_source": _WARP_DISPATCH,
    **{name: _WARP_DISPATCH for name in ("TH", "TW", "D", "DX", "RW", "WC", "OFFY", "OFFX", "N_PHASE", "MY", "MX",
                                         "TH_S", "TW_S", "DX_SAMPLE", "N_FALLBACK_BANDS")},
}
