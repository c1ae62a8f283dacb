"""The halfway-domain correspondence solver: energy, descent, coarse to fine."""

from videomorphing_tpu_torch.solver.energy import (
    LevelData,
    make_level_data,
    total_energy,
    energy_terms,
    warp_pair,
)
from videomorphing_tpu_torch.solver.constraints import (
    rasterize_point_constraints,
    scale_points,
)
from videomorphing_tpu_torch.solver.descent import (
    boundary_mask,
    color_mask,
    foldover_scale,
    make_level_solver,
    LevelStats,
)
from videomorphing_tpu_torch.solver.ctf import optimize_pair, OptimizeResult

__all__ = [
    "LevelData",
    "make_level_data",
    "total_energy",
    "energy_terms",
    "warp_pair",
    "rasterize_point_constraints",
    "scale_points",
    "boundary_mask",
    "color_mask",
    "foldover_scale",
    "make_level_solver",
    "LevelStats",
    "optimize_pair",
    "OptimizeResult",
]
