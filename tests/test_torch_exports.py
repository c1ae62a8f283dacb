"""The port's package surface against the reference's.

- every name in the ``__all__`` of each reference subpackage (``ops``,
  ``solver``, ``synth``, ``video``, ``models``, ``parallel``, ``utils``)
  imports from the port's subpackage of the same name, in the same
  ``__all__`` order, unless the port lists it in ``NOT_PORTED`` (the
  JAX-only ``jax.sharding`` objects and the XLA compile cache);
- the functions that export brought into the port, each against the
  reference on the CPU with numpy-seeded inputs;
- ``utils.synthetic.make_clips`` equals the reference benchmark's
  ``bench._make_clips``.

Tolerances: sampling, gradients and box filters are the same float32
operations in the same order as the reference's, so 1e-6 of max|ref|;
the DCT solve, SSIM, energy terms and the render sum in other orders,
so 1e-5 of max|ref| (1e-4 absolute for rendered pixels in [0, 1]).
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from videomorphing_tpu.config import MorphParams as JaxMorphParams
from videomorphing_tpu.config import SynthParams as JaxSynthParams
from videomorphing_tpu.ops import poisson as jpo
from videomorphing_tpu.ops import resample as jre
from videomorphing_tpu.ops import ssim as jss
from videomorphing_tpu.ops import windows as jwi
from videomorphing_tpu.solver import energy as jen
from videomorphing_tpu.synth import render as jrender
from videomorphing_tpu_torch.config import MorphParams, SynthParams
from videomorphing_tpu_torch.interop import level_data_from_numpy
from videomorphing_tpu_torch.utils.synthetic import make_clips

torch.set_num_threads(1)

SUBPACKAGES = ("ops", "solver", "synth", "video", "models", "parallel", "utils")
JAX_ONLY = {"batch_sharding", "replicated_sharding", "enable_compile_cache"}


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.max(np.abs(ref - got)) / (np.max(np.abs(ref)) + 1e-30))


def _img(seed, h=37, w=53, c=3):
    return np.random.default_rng(seed).random((h, w, c), dtype=np.float32)


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_subpackage_exports_the_reference_names(name):
    ref = importlib.import_module(f"videomorphing_tpu.{name}")
    port = importlib.import_module(f"videomorphing_tpu_torch.{name}")
    not_ported = set(getattr(port, "NOT_PORTED", ()))
    assert not_ported <= JAX_ONLY
    missing = [n for n in ref.__all__ if not hasattr(port, n) and n not in not_ported]
    assert not missing, f"videomorphing_tpu_torch.{name} lacks {missing}"
    assert port.__all__ == [n for n in ref.__all__ if n not in not_ported]
    assert all(not hasattr(port, n) for n in not_ported)


def test_sample_at():
    img = _img(1)
    rng = np.random.default_rng(2)
    base = np.stack(np.mgrid[0:37, 0:53], -1).astype(np.float32)
    off = (5.0 * rng.standard_normal((37, 53, 2))).astype(np.float32)  # some leave the image
    from videomorphing_tpu_torch.ops import sample_at

    ref = jre.sample_at(jnp.asarray(img), jnp.asarray(base), jnp.asarray(off))
    assert _rel(ref, sample_at(_t(img), _t(base), _t(off))) <= 1e-6


@pytest.mark.parametrize("shape", [(37, 53, 3), (37, 53)])
def test_image_gradients(shape):
    img = np.random.default_rng(3).random(shape, dtype=np.float32)
    from videomorphing_tpu_torch.ops import image_gradients

    assert _rel(jre.image_gradients(jnp.asarray(img)), image_gradients(_t(img))) <= 1e-6


@pytest.mark.parametrize("size,mode", [(3, "same_zero"), (5, "same_zero"), (5, "same_edge")])
def test_box_filter(size, mode):
    img = _img(4)
    from videomorphing_tpu_torch.ops import box_filter

    ref = jwi.box_filter(jnp.asarray(img), size, mode)
    assert _rel(ref, box_filter(_t(img), size, mode)) <= 1e-6


@pytest.mark.parametrize("shape", [(32, 40), (32, 40, 3)])
def test_poisson_solve_dct(shape):
    rhs = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    from videomorphing_tpu_torch.ops import poisson_solve_dct

    ref = jpo.poisson_solve_dct(jnp.asarray(rhs), 0.25)
    assert _rel(ref, poisson_solve_dct(_t(rhs), 0.25)) <= 1e-5


@pytest.mark.parametrize("use_luminance", [True, False])
def test_dssim_value_and_grad_wrt_images(use_luminance):
    w0, w1 = _img(6), _img(7)
    from videomorphing_tpu_torch.ops import dssim_value_and_grad_wrt_images

    ref = jss.dssim_value_and_grad_wrt_images(jnp.asarray(w0), jnp.asarray(w1), use_luminance=use_luminance)
    got = dssim_value_and_grad_wrt_images(_t(w0), _t(w1), use_luminance=use_luminance)
    assert len(got) == 4
    assert abs(float(got[0]) - float(ref[0])) <= 1e-5 * abs(float(ref[0]))
    for r, g in zip(ref[1:], got[1:]):
        assert _rel(r, g) <= 1e-5


def test_energy_terms():
    h, w = 37, 53
    rng = np.random.default_rng(8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    v = np.stack([2.0 * np.sin(yy / 7.0), 1.5 * np.cos(xx / 9.0)], -1).astype(np.float32)
    arrs = dict(
        i0=_img(9), i1=_img(10),
        ui_w=rng.random((h, w, 1), dtype=np.float32),
        ui_v=(v + 0.3 * rng.standard_normal((h, w, 2))).astype(np.float32),
        tc_w=rng.random((h, w, 1), dtype=np.float32),
        tc_v=(v + 0.5 * rng.standard_normal((h, w, 2))).astype(np.float32),
    )
    from videomorphing_tpu_torch.solver import energy_terms, total_energy

    jp = JaxMorphParams()
    ref = jen.energy_terms(jnp.asarray(v), jen.make_level_data(*(jnp.asarray(arrs[k]) for k in arrs)), jp)
    data = level_data_from_numpy(**arrs)
    got = energy_terms(_t(v), data, MorphParams(**dataclasses.asdict(jp)))
    assert sorted(got) == sorted(ref) == ["sim", "tc", "tps", "ui"]
    for k in ref:
        assert abs(float(got[k]) - float(ref[k])) <= 1e-5 * abs(float(ref[k])), k
    assert float(total_energy(_t(v), data, MorphParams())) == float(sum(got[k] for k in ("sim", "tps", "ui", "tc")))


def test_render_frame_with_aux():
    h, w = 24, 32
    clip_a, clip_b = bench._make_clips(1, h, w, seed=3)
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    v = np.stack([1.5 * np.sin(yy / 5.0), 3.0 + np.cos(xx / 6.0)], -1).astype(np.float32)
    b = (0.3 * rng.standard_normal((h, w, 2))).astype(np.float32)
    from videomorphing_tpu_torch.synth import render_frame
    from videomorphing_tpu_torch.synth.render import FrameAux

    ref, ref_aux = jrender.render_frame(jnp.asarray(clip_a[0]), jnp.asarray(clip_b[0]), jnp.asarray(v),
                                        jnp.asarray(b), 0.3, JaxSynthParams(), with_aux=True)
    got, aux = render_frame(_t(clip_a[0]), _t(clip_b[0]), _t(v), _t(b), 0.3, SynthParams(), with_aux=True)
    assert isinstance(aux, FrameAux) and aux._fields == ref_aux._fields
    assert float(np.max(np.abs(np.asarray(ref) - got.numpy()))) <= 1e-4
    assert np.array_equal(np.asarray(ref_aux.mask0), aux.mask0.numpy())
    assert np.array_equal(np.asarray(ref_aux.mask1), aux.mask1.numpy())
    assert float(np.max(np.abs(np.asarray(ref_aux.inv_residual) - aux.inv_residual.numpy()))) <= 1e-5
    plain = render_frame(_t(clip_a[0]), _t(clip_b[0]), _t(v), _t(b), 0.3, SynthParams())
    assert torch.equal(plain, got)


def test_make_clips_is_the_bench_copy():
    ref_a, ref_b = bench._make_clips(3, 24, 32, seed=4)
    got_a, got_b = make_clips(3, 24, 32, seed=4)
    assert got_a.dtype == ref_a.dtype and got_a.shape == (3, 24, 32, 3)
    assert np.array_equal(got_a, ref_a) and np.array_equal(got_b, ref_b)
