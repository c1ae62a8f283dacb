"""Array primitives: sampling, windows, pyramids, SSIM statistics, Poisson."""

from videomorphing_tpu_torch.ops.resample import (
    bilinear_sample,
    grid_coords,
    image_gradients,
    sample_at,
    inside_mask,
)
from videomorphing_tpu_torch.ops.windows import (
    gaussian_kernel_1d,
    separable_filter,
    box_filter,
)
from videomorphing_tpu_torch.ops.pyramid import (
    downsample_2x,
    upsample_2x,
    upsample_field_2x,
    gaussian_pyramid,
    pyramid_shapes,
    auto_n_levels,
)
from videomorphing_tpu_torch.ops.ssim import (
    ssim_parts,
    dssim_map,
    dssim_value_and_grad_wrt_images,
)
from videomorphing_tpu_torch.ops.poisson import (
    dct2,
    idct2,
    screened_poisson_dct,
    poisson_solve_dct,
    pull_push_extend,
)

__all__ = [
    "bilinear_sample",
    "grid_coords",
    "image_gradients",
    "sample_at",
    "inside_mask",
    "gaussian_kernel_1d",
    "separable_filter",
    "box_filter",
    "downsample_2x",
    "upsample_2x",
    "upsample_field_2x",
    "gaussian_pyramid",
    "pyramid_shapes",
    "auto_n_levels",
    "ssim_parts",
    "dssim_map",
    "dssim_value_and_grad_wrt_images",
    "dct2",
    "idct2",
    "screened_poisson_dct",
    "poisson_solve_dct",
    "pull_push_extend",
]
