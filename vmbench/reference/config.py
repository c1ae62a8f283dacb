"""Frozen configuration of the pair and video morphs, field for field the
JAX package's ``videomorphing_tpu.config`` dataclasses.

The port carries its own copy so that importing it loads nothing of the JAX
package; ``tests/test_torch_isolation.py`` holds every field name and
default to the reference, so the two cannot drift apart. The rationale of
each default is documented in ``videomorphing_tpu/config.py``.

Knobs that only steer TPU machinery are kept for signature parity and are
ignored by the port (the kernel runs whenever the tensors lie on the card):
``fused_warp``, ``warp_into_pack``, ``warp_prescreen``,
``SynthParams.fused_sampling``, and ``VideoParams``'s ``fused_occlusion``,
``fused_advect`` and ``fused_flow``. ``backend`` and ``pallas_min_pixels``
are read for one choice only: where ``pack_dtype="bfloat16"`` takes effect
(``solver.descent.pack_dtype_for``, the reference's ``_resolve_backend``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MorphParams:
    """Parameters of the halfway-domain correspondence optimization."""

    # energy weights
    lambda_tps: float = 0.005
    gamma_ui: float = 50.0
    beta_tc: float = 0.5
    ui_sigma: float = 4.0

    # SSIM data term
    ssim_window: int = 5
    ssim_sigma: float = 1.0
    ssim_c1: float = 1e-4
    ssim_c2: float = 9e-4
    ssim_use_luminance: bool = True

    # coarse-to-fine pyramid
    n_levels: int = 0
    min_level_size: int = 16
    iters_coarse: int = 200
    iters_fine: int = 30
    tol: float = 1e-7

    # descent / line search
    n_colors: int = 2
    init_step: float = 1.0
    step_grow: float = 1.25
    step_shrink: float = 0.5
    max_backtracks: int = 10
    armijo_c: float = 1e-4
    min_step: float = 1e-8

    # constraints
    fold_margin: float = 0.45
    boundary_lock: bool = True

    # numerics
    dtype: str = "float32"
    precond_eps: float = 1e-3

    # execution
    backend: str = "auto"
    relin_every: int = 8
    pallas_min_pixels: int = 16384
    fused_warp: bool = True
    pack_dtype: str = "float32"
    warp_into_pack: bool = False
    warp_prescreen: bool = False
    relin_median: bool = True

    def iters_for_level(self, level: int, n_levels: int) -> int:
        """Iteration budget per level; geometric from coarse to fine.

        ``level`` counts 0 = finest .. n_levels-1 = coarsest.
        """
        if n_levels <= 1:
            return self.iters_coarse
        frac = level / (n_levels - 1)
        it = self.iters_fine * (self.iters_coarse / self.iters_fine) ** frac
        return max(1, int(round(it)))


@dataclasses.dataclass(frozen=True)
class SynthParams:
    """Parameters of morph synthesis (paths, warps, blending)."""

    quadratic_paths: bool = True
    path_smooth_mu: float = 25.0
    max_bulge: float = 32.0

    invert_iters: int = 6
    invert_multiscale: bool = True
    fused_sampling: bool = True
    sampling: str = "bilinear"

    blend_mode: str = "poisson"
    blend_screen_lambda: float = 0.1
    extend_levels: int = 0
    occlusion_weighting: bool = True

    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class VideoParams:
    """Parameters of the video pipeline [EGSR14]: flow, occlusion, temporal
    propagation and the warm-solve schedule. ``fused_occlusion``,
    ``fused_advect`` and ``fused_flow`` only steer the reference's TPU
    sampler; the port keeps them for signature parity and ignores them
    (every sample on the card runs through kernel 4)."""

    # optical flow (pyramid Horn-Schunck, or the robust Brox-class solve)
    flow_alpha: float = 12.0
    flow_iters: int = 40
    flow_levels: int = 0
    flow_warps: int = 2
    flow_clamp: float = 1.0
    flow_robust: bool = False
    flow_alpha_robust: float = 6.0
    flow_irls: int = 5
    flow_gamma: float = 10.0
    flow_eps: float = 3.0
    flow_eps_s: float = 0.5
    flow_hp_sigma: float = 6.0
    flow_scale: float = 0.5

    # occlusion detection
    occlusion_thresh: float = 1.0
    occlusion_soft: float = 0.5
    fused_occlusion: bool = True
    fused_advect: bool = True
    fused_flow: bool = True

    # temporal propagation and the warm solve
    propagate: bool = True
    tc_fill_thresh: float = 0.25
    advect_invert_iters: int = 3
    advect_residual: float = 0.75
    advect_scale: float = 0.5
    warm_iters_mid: int = 20
    warm_iters_fine: int = 12
    warm_levels: int = 0
    warm_relin_every: int = 12

    dtype: str = "float32"


def exact_configs() -> tuple[MorphParams, SynthParams, VideoParams]:
    """The "paper-exact" slow configuration, the in-repo oracle (port of
    ``videomorphing_tpu.config.exact_configs``): every speed default that
    trades work for fidelity reverted to its exact setting. Re-warp every
    iteration with no relinearization median, full iteration budgets,
    full-resolution path inversion, flow and advection, exact warm warps
    with the half-resolution warm level. The backend and ``fused_*`` flags
    are set as the reference sets them; the port ignores them."""
    mp = MorphParams(
        backend="jnp",
        fused_warp=False,
        relin_every=1,
        relin_median=False,
        pack_dtype="float32",
        iters_coarse=200,
        iters_fine=50,
    )
    sp = SynthParams(
        invert_multiscale=False,
        fused_sampling=False,
        invert_iters=10,
    )
    vp = VideoParams(
        flow_iters=60,
        flow_warps=3,
        flow_scale=1.0,
        advect_scale=1.0,
        warm_iters_mid=30,
        warm_iters_fine=20,
        warm_relin_every=1,
        warm_levels=2,
        fused_occlusion=False,
        fused_advect=False,
        fused_flow=False,
    )
    return mp, sp, vp
