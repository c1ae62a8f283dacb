"""State carried across from the JAX package, read out as numpy arrays.

The parity tests use these to render from one field solved by the
reference in both packages, to run one level solve from identical inputs,
to run the warm frame loop and the video render from the reference's flows
and fields, and to render the layered morphs from its layered fields, so
that each part's parity is separated from drift upstream of it (solver and
flow). The configuration needs no conversion: ``config.py`` mirrors the
reference's dataclasses field for field.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from videomorphing_tpu_torch.device import as_device
from videomorphing_tpu_torch.models.image_morph import MorphArtifacts
from videomorphing_tpu_torch.models.layered import LayeredArtifacts
from videomorphing_tpu_torch.solver.energy import LevelData, make_level_data


def _t(x, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(as_device(device)).contiguous()


def artifacts_from_numpy(v, b=None, device=None) -> MorphArtifacts:
    """A reference ``MorphArtifacts`` (field ``v``, bulge ``b`` or None) as
    the port's, on ``device``; ``result`` stays None."""
    return MorphArtifacts(v=_t(v, device), b=_t(b, device), result=None)


def level_data_from_numpy(i0, i1, ui_w=None, ui_v=None, tc_w=None, tc_v=None, device=None) -> LevelData:
    """A reference ``LevelData`` (each field a numpy array or None) as the
    port's, on ``device``."""
    return make_level_data(*(_t(x, device) for x in (i0, i1, ui_w, ui_v, tc_w, tc_v)))


def flows_from_numpy(flows, device=None) -> dict:
    """The reference's flow dict (``fa_fwd``, ``fa_bwd``, ``fb_fwd``,
    ``fb_bwd``, each (T-1, H, W, 2)) as the port's, on ``device``."""
    return {k: _t(v, device) for k, v in flows.items()}


def fields_from_numpy(fields, device=None) -> torch.Tensor:
    """Reference fields (T, H, W, 2) (or one (H, W, 2)) as a tensor on
    ``device``."""
    return _t(fields, device)


def layered_artifacts_from_numpy(v_bg, b_bg, v_layers, b_layers, device=None) -> LayeredArtifacts:
    """A reference ``LayeredArtifacts`` (background field and bulge, the
    per-layer fields and bulges; a bulge may be None) as the port's."""
    return LayeredArtifacts(
        v_bg=_t(v_bg, device),
        b_bg=_t(b_bg, device),
        v_layers=tuple(_t(v, device) for v in v_layers),
        b_layers=tuple(_t(b, device) for b in b_layers),
    )


def layered_fields_from_numpy(fields_bg, fields_layers, device=None):
    """The reference's layered clip fields, ``fields_bg`` (T, H, W, 2) and
    one (T, H, W, 2) per layer, as ``(tensor, tuple of tensors)``."""
    return _t(fields_bg, device), tuple(_t(f, device) for f in fields_layers)
