"""Host-side I/O: images, clips, project files.

Copies of ``videomorphing_tpu/io`` (numpy only; PIL imported only when an
image is read or written), so the port loads nothing of the JAX package.
Decoding happens on the host; arrays move to the device in the API.
"""

from videomorphing_tpu_torch.io.images import load_image, save_image, to_float, to_uint8
from videomorphing_tpu_torch.io.clips import load_clip, save_clip, open_clip_reader
from videomorphing_tpu_torch.io.project import Project, load_project, save_project

__all__ = [
    "load_image",
    "save_image",
    "to_float",
    "to_uint8",
    "load_clip",
    "save_clip",
    "open_clip_reader",
    "Project",
    "load_project",
    "save_project",
]
