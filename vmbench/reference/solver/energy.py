"""The morph energy E(v) on the halfway domain.

Port of ``videomorphing_tpu/solver/energy.py``:

    E(v) = mean_p E_SIM(p) + lambda_tps mean_p E_TPS(p)
           + gamma_ui mean_p w_ui |v - v_ui|^2 + beta_tc mean_p w_tc |v - v_tc|^2

with the halfway warps w0(p) = I0(p - v(p)), w1(p) = I1(p + v(p)).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from vmbench.reference.config import MorphParams


class LevelData(NamedTuple):
    """Per-pyramid-level inputs of the optimization (all on one device)."""

    i0: torch.Tensor    # (H, W, C) image 0 at this level
    i1: torch.Tensor    # (H, W, C) image 1
    ui_w: torch.Tensor  # (H, W, 1) user-constraint weight map
    ui_v: torch.Tensor  # (H, W, 2) user-constraint target field
    tc_w: torch.Tensor  # (H, W, 1) temporal-coherence weight map
    tc_v: torch.Tensor  # (H, W, 2) temporal-coherence target field


def make_level_data(i0, i1, ui_w=None, ui_v=None, tc_w=None, tc_v=None) -> LevelData:
    h, w = i0.shape[0], i0.shape[1]
    z1 = i0.new_zeros((h, w, 1))
    z2 = i0.new_zeros((h, w, 2))
    return LevelData(
        i0=i0.contiguous(),
        i1=i1.contiguous(),
        ui_w=z1 if ui_w is None else ui_w.contiguous(),
        ui_v=z2 if ui_v is None else ui_v.contiguous(),
        tc_w=z1 if tc_w is None else tc_w.contiguous(),
        tc_v=z2 if tc_v is None else tc_v.contiguous(),
    )


def tps_maps(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Second-difference maps (vxx, vxy, vyy), zero where the stencil leaves
    the domain. Each is (H, W, 2)."""
    vxx = torch.zeros_like(v)
    vxx[:, 1:-1] = v[:, 2:] - 2.0 * v[:, 1:-1] + v[:, :-2]
    vyy = torch.zeros_like(v)
    vyy[1:-1, :] = v[2:] - 2.0 * v[1:-1] + v[:-2]
    vxy = torch.zeros_like(v)
    vxy[1:-1, 1:-1] = 0.25 * (v[2:, 2:] - v[2:, :-2] - v[:-2, 2:] + v[:-2, :-2])
    return vxx, vxy, vyy


def tps_energy_map(v: torch.Tensor) -> torch.Tensor:
    """E_TPS(p) = |v_xx|^2 + 2 |v_xy|^2 + |v_yy|^2, (H, W)."""
    vxx, vxy, vyy = tps_maps(v)
    return torch.sum(vxx * vxx + 2.0 * vxy * vxy + vyy * vyy, dim=-1)


def quadratic_energies(v: torch.Tensor, data: LevelData, p: MorphParams):
    """(e_tps, e_ui, e_tc), each weight-multiplied."""
    e_tps = p.lambda_tps * torch.mean(tps_energy_map(v))
    dv_ui = v - data.ui_v
    e_ui = p.gamma_ui * torch.mean(data.ui_w * torch.sum(dv_ui * dv_ui, -1, keepdim=True))
    dv_tc = v - data.tc_v
    e_tc = p.beta_tc * torch.mean(data.tc_w * torch.sum(dv_tc * dv_tc, -1, keepdim=True))
    return e_tps, e_ui, e_tc
