"""Configured morph models."""

from videomorphing_tpu_torch.models.image_morph import (
    ImageMorpher,
    MorphArtifacts,
)
from videomorphing_tpu_torch.models.video_morph import VideoMorpher

__all__ = [
    "ImageMorpher",
    "MorphArtifacts",
    "VideoMorpher",
]
