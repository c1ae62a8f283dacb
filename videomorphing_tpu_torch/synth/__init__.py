"""Morph synthesis: quadratic paths, path inversion, rendering, blending."""

from videomorphing_tpu_torch.synth.paths import bulge_field, rotation_angle_map
from videomorphing_tpu_torch.synth.render import (
    path_displacement,
    invert_path,
    render_frame,
    render_clip,
)
from videomorphing_tpu_torch.synth.blend import blend_extended

__all__ = [
    "bulge_field",
    "rotation_angle_map",
    "path_displacement",
    "invert_path",
    "render_frame",
    "render_clip",
    "blend_extended",
]
