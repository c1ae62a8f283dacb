"""The port's package surface against the reference's.

- every name in the ``__all__`` of each reference subpackage (``ops``,
  ``solver``, ``synth``, ``video``, ``models``, ``parallel``, ``utils``)
  imports from the port's subpackage of the same name, in the same
  ``__all__`` order, unless the port lists it in ``NOT_PORTED`` (the
  JAX-only ``jax.sharding`` objects and the XLA compile cache);
- the functions that export brought into the port, each against the
  reference on the CPU with numpy-seeded inputs;
- every public function and class of each reference subpackage (its
  ``__all__`` and every module of it that the port mirrors) and of
  ``api`` accepts, in the port, every parameter name of the reference's,
  but for the documented exceptions of ``SIGNATURE_EXCEPTIONS``;
- ``utils.synthetic.make_clips`` equals the reference benchmark's
  ``bench._make_clips``;
- the kernel layer: every public name of the reference's
  ``pallas/{__init__,sweep,warp}.py`` maps, in
  ``kernels.REFERENCE_COUNTERPARTS``, to a port function that exists or to
  a reason from ROADMAP "Not ported"; ``solver.descent.warp_bundle_fused``,
  ``synth.paths.jitted_bulge_field`` and ``synth.render.jitted_render_clip``
  against the reference's on one small case.

Tolerances: sampling, gradients and box filters are the same float32
operations in the same order as the reference's, so 1e-6 of max|ref|;
the DCT solve, SSIM, energy terms and the render sum in other orders,
so 1e-5 of max|ref| (1e-4 absolute for rendered pixels in [0, 1]).
"""

import dataclasses
import importlib
import inspect
import pkgutil

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


# reference functions whose parameters the port does not take, with the reason
SIGNATURE_EXCEPTIONS = {
    "videomorphing_tpu.parallel.halo.halo_exchange_rows":
        "x and axis_name are a shard_map collective's arguments; the port exchanges the rows of a "
        "list of per-device blocks (blocks, halo)",
}


def _public_callables(mod):
    """Public functions and classes defined in ``mod`` itself."""
    return {n: o for n, o in vars(mod).items()
            if not n.startswith("_") and (inspect.isfunction(o) or inspect.isclass(o))
            and getattr(o, "__module__", None) == mod.__name__}


def _parameter_names(obj):
    try:
        params = inspect.signature(obj).parameters.values()
    except (TypeError, ValueError):  # a builtin or a class without a Python signature
        return None
    if any(p.kind == p.VAR_KEYWORD for p in params):
        return None  # takes any keyword
    return {p.name for p in params if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}


@pytest.mark.parametrize("name", SUBPACKAGES + ("api",))
def test_functions_accept_the_reference_parameters(name):
    """A caller written against the reference passes the port every
    parameter name the reference's function takes: the names of the
    subpackage's ``__all__`` and the public functions of each of its
    modules that the port mirrors (for ``api``, its public functions)."""
    ref_pkg = importlib.import_module(f"videomorphing_tpu.{name}")
    pairs = []  # (qualified reference name, reference object, port object)
    port_pkg = importlib.import_module(f"videomorphing_tpu_torch.{name}")
    for n in getattr(ref_pkg, "__all__", ()):
        if hasattr(port_pkg, n):
            obj = getattr(ref_pkg, n)
            pairs.append((f"{getattr(obj, '__module__', ref_pkg.__name__)}.{n}", obj, getattr(port_pkg, n)))
    mods = [ref_pkg] + [importlib.import_module(m.name)
                        for m in pkgutil.walk_packages(getattr(ref_pkg, "__path__", []), ref_pkg.__name__ + ".")]
    for mod in mods:
        try:
            port_mod = importlib.import_module(mod.__name__.replace("videomorphing_tpu", "videomorphing_tpu_torch", 1))
        except ModuleNotFoundError:
            continue
        pairs += [(f"{mod.__name__}.{n}", o, getattr(port_mod, n))
                  for n, o in _public_callables(mod).items() if hasattr(port_mod, n)]
    assert pairs
    missing = {}
    for qual, ref, port in pairs:
        ref_names, port_names = _parameter_names(ref), _parameter_names(port)
        if ref_names is None or port_names is None or qual in SIGNATURE_EXCEPTIONS:
            continue
        if ref_names - port_names:
            missing[qual] = sorted(ref_names - port_names)
    assert not missing, f"the port rejects the reference's parameters: {missing}"


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


def _public_names(mod):
    """Functions, classes and constants a module defines, without a
    leading underscore (imported modules and names excluded)."""
    import inspect

    names = set(getattr(mod, "__all__", ()))
    for name, obj in vars(mod).items():
        if name.startswith("_") or name == "annotations" or inspect.ismodule(obj):
            continue
        if getattr(obj, "__module__", mod.__name__) == mod.__name__ or not callable(obj):
            names.add(name)
    return names


def test_kernel_layer_names_have_counterparts():
    """Each public name of the reference's kernel layer has a port function
    (a dotted path that resolves to a callable) or a stated reason from
    ROADMAP "Not ported"; the port's kernel package exports its wrappers."""
    import pathlib

    import videomorphing_tpu.pallas as jpallas
    import videomorphing_tpu.pallas.sweep as jsweep
    import videomorphing_tpu.pallas.warp as jwarp
    import videomorphing_tpu_torch.kernels as tk

    ref = set().union(*(_public_names(m) for m in (jpallas, jsweep, jwarp)))
    assert {"fused_value_grad_precond", "fused_sample", "WarpSource", "LANE"} <= ref
    assert ref == set(tk.REFERENCE_COUNTERPARTS)
    roadmap = (pathlib.Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()
    not_ported = roadmap[roadmap.index("**Not ported: code the port does not need.**"):]
    for name, target in tk.REFERENCE_COUNTERPARTS.items():
        if target.startswith("videomorphing_tpu_torch."):
            mod, _, attr = target.rpartition(".")
            assert callable(getattr(importlib.import_module(mod), attr)), (name, target)
        else:
            assert target.startswith("not ported: "), (name, target)
    for key in ("pallas_available", "the split sweep mode", "fused_warp_planes_packed", "WarpSource", "sweep._pack"):
        assert key in not_ported, key
    assert tk.REFERENCE_COUNTERPARTS["fused_value_grad_precond"].endswith("solver.descent.energy_value_grad_precond")
    assert tk.REFERENCE_COUNTERPARTS["fused_sample"].endswith("kernels.warp.bilinear_sample_batched")
    for name in tk.__all__:
        assert getattr(tk, name) is not None
    assert tk.sweep_grad.launches == 0 and tk.halfway_warp is importlib.import_module(
        "videomorphing_tpu_torch.kernels.warp").halfway_warp


def test_warp_bundle_fused():
    """The port's ``warp_bundle_fused`` (kernel 3's plain version here)
    against the reference's (its Pallas warp, interpret mode on the CPU):
    the bundle's warps and derivatives within 1e-5 of max|ref|."""
    from videomorphing_tpu.solver import descent as jde
    from videomorphing_tpu_torch.solver import descent as tde

    i0, i1 = _img(20, h=24, w=40), _img(21, h=24, w=40)
    rng = np.random.default_rng(22)
    v = (1.5 * rng.standard_normal((24, 40, 2))).astype(np.float32)
    ref = jde.warp_bundle_fused(jnp.asarray(v), jnp.asarray(i0), jnp.asarray(i1))
    got = tde.warp_bundle_fused(_t(v), _t(i0), _t(i1))
    assert torch.equal(got.v_lin, _t(v))
    for name in ("w0", "dw0", "w1", "dw1"):
        assert _rel(getattr(ref, name), getattr(got, name)) <= 1e-5, name


def test_jitted_bulge_field_and_render_clip():
    """``synth.paths.jitted_bulge_field(sp)`` and
    ``synth.render.jitted_render_clip(sp)`` are cached plain callables that
    give the reference's jitted results (1e-5 of max|ref|; rendered pixels
    1e-4 absolute)."""
    from videomorphing_tpu.synth import paths as jpaths
    from videomorphing_tpu_torch.synth import paths as tpaths
    from videomorphing_tpu_torch.synth import render as trender

    sp, jsp = SynthParams(), JaxSynthParams()
    rng = np.random.default_rng(23)
    v = (2.0 * rng.standard_normal((20, 28, 2))).astype(np.float32)
    assert tpaths.jitted_bulge_field(sp) is tpaths.jitted_bulge_field(SynthParams())
    b_ref = jpaths.jitted_bulge_field(jsp)(jnp.asarray(v))
    b = tpaths.jitted_bulge_field(sp)(_t(v))
    assert _rel(b_ref, b) <= 1e-5
    i0, i1 = _img(24, h=20, w=28), _img(25, h=20, w=28)
    ts = np.array([0.0, 0.4, 1.0], np.float32)
    assert trender.jitted_render_clip(sp) is trender.jitted_render_clip(SynthParams())
    ref = jrender.jitted_render_clip(jsp)(jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(v), b_ref, jnp.asarray(ts))
    got = trender.jitted_render_clip(sp)(_t(i0), _t(i1), _t(v), b, ts)
    assert got.shape == (3, 20, 28, 3)
    assert float(np.max(np.abs(np.asarray(ref) - got.numpy()))) <= 1e-4
