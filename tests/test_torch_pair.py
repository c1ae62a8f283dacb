"""Port parity: paths, path inversion, rendering and ``api.morph_pair``.

The synthesis half is compared on one field solved by the JAX reference and
carried across with ``interop.artifacts_from_numpy``, so render parity is
separated from solver drift; then ``api.morph_pair`` runs end to end in both
packages. 128 x 160 takes the half-resolution path inversion; a 256 x 264
case takes the quarter-resolution one.

Tolerances: max abs <= 1e-4 for everything rendered from the same field
(pixel values in [0, 1]; coordinates and bulge in px; the DCT blend sums
over whole rows and columns in float32); <= 1e-3 end to end, where the
solver's float32 trajectory differs slightly between the packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from videomorphing_tpu import api as jax_api
from videomorphing_tpu.config import MorphParams as JaxMorphParams
from videomorphing_tpu.config import SynthParams as JaxSynthParams
from videomorphing_tpu.synth import paths as jpaths
from videomorphing_tpu.synth import render as jrender
from videomorphing_tpu_torch import api
from videomorphing_tpu_torch.config import MorphParams, SynthParams
from videomorphing_tpu_torch.interop import artifacts_from_numpy
from videomorphing_tpu_torch.synth import paths as tpaths
from videomorphing_tpu_torch.synth import render as trender

torch.set_num_threads(2)
H, W = 128, 160
ATOL = 1e-4
JMP = JaxMorphParams(iters_coarse=8, iters_fine=4)
TS = np.linspace(0.0, 1.0, 3).astype(np.float32)


def _port(p):
    cls = MorphParams if isinstance(p, JaxMorphParams) else SynthParams
    return cls(**dataclasses.asdict(p))


def _maxabs(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b.detach().numpy() if isinstance(b, torch.Tensor) else b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


@pytest.fixture(scope="module")
def pair():
    clip_a, clip_b = bench._make_clips(1, H, W, seed=0)
    pts = np.array(
        [[[H * 0.4, W * 0.45], [H * 0.4, W * 0.55]], [[H * 0.6, W * 0.45], [H * 0.6, W * 0.55]]],
        np.float32,
    )
    return clip_a[0], clip_b[0], pts


@pytest.fixture(scope="module")
def solved(pair):
    i0, i1, pts = pair
    art = jax_api.solve_pair(i0, i1, pts, JMP, JaxSynthParams())
    return np.array(art.v), np.array(art.b)


def test_bulge_field(solved):
    v, b = solved
    assert np.abs(v).max() > 1.0  # a real field, not the zero start
    assert _maxabs(b, tpaths.bulge_field(torch.from_numpy(v))) <= ATOL
    theta_ref = jpaths.rotation_angle_map(jnp.asarray(v))
    assert _maxabs(theta_ref, tpaths.rotation_angle_map(torch.from_numpy(v))) <= ATOL


@pytest.mark.parametrize("t,multiscale", [(0.25, True), (0.7, True), (0.6, False)])
def test_invert_path(solved, t, multiscale):
    v, b = solved
    jv, jb, jt = jnp.asarray(v), jnp.asarray(b), jnp.float32(t)
    art = artifacts_from_numpy(v, b)
    p_ref, vp_ref = jrender.invert_path_with_field(jv, jb, jt, 6, multiscale=multiscale)
    p_got, vp_got = trender.invert_path_with_field(art.v, art.b, t, 6, multiscale=multiscale)
    assert _maxabs(p_ref, p_got) <= ATOL
    assert _maxabs(vp_ref, vp_got) <= ATOL
    p_ref = jrender.invert_path(jv, jb, jt, 6, multiscale=multiscale)
    assert _maxabs(p_ref, trender.invert_path(art.v, art.b, t, 6, multiscale=multiscale)) <= ATOL


def test_multiscale_start_quarter_resolution():
    h, w = 256, 264
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disp = np.stack([6 * np.sin(yy / 37.0 + 0.3), 5 * np.cos(xx / 29.0)], -1).astype(np.float32)
    ref = jrender._multiscale_start(jnp.asarray(disp), h, w, 6, False)
    got = trender._multiscale_start(torch.from_numpy(disp), h, w, 6)
    assert _maxabs(ref, got) <= ATOL


@pytest.mark.parametrize("blend_mode", ["poisson", "linear"])
def test_render_clip_from_reference_field(pair, solved, blend_mode):
    i0, i1, _ = pair
    v, b = solved
    jsp = JaxSynthParams(blend_mode=blend_mode)
    ref = jrender.jitted_render_clip(jsp)(
        jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(v), jnp.asarray(b), jnp.asarray(TS)
    )
    art = artifacts_from_numpy(v, b)
    got = trender.render_clip(torch.from_numpy(i0), torch.from_numpy(i1), art.v, art.b, TS, _port(jsp))
    assert got.shape == (3, H, W, 3)
    assert _maxabs(ref, got) <= ATOL


def test_render_frame_bicubic(pair, solved):
    i0, i1, _ = pair
    v, b = solved
    jsp = JaxSynthParams(sampling="bicubic", blend_mode="linear")
    ref = jrender.render_frame(jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(v), jnp.asarray(b), 0.4, jsp)
    art = artifacts_from_numpy(v, b)
    got = trender.render_frame(torch.from_numpy(i0), torch.from_numpy(i1), art.v, art.b, 0.4, _port(jsp))
    assert _maxabs(ref, got) <= ATOL


def test_morph_pair_end_to_end(pair):
    i0, i1, pts = pair
    ref = jax_api.morph_pair(i0, i1, pts, n_frames=3, mp=JMP, sp=JaxSynthParams())
    got = api.morph_pair(i0, i1, pts, n_frames=3, mp=_port(JMP), sp=SynthParams(), device="cpu")
    assert got.shape == (3, H, W, 3) and got.dtype == torch.float32
    assert _maxabs(ref, got) <= 1e-3
