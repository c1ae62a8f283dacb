"""Port parity: sampling and the plain versions of kernels 3 and 4.

Each case runs the same numpy inputs (made from a seed) through the JAX
reference and its PyTorch counterpart on the CPU. Tolerance: max abs
<= 1e-6 (inputs in [0, 1]; both sides compute the same float32 operations,
the slack covers XLA's fused multiply-adds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videomorphing_tpu.ops import resample as jr
from videomorphing_tpu_torch.kernels import warp as kw
from videomorphing_tpu_torch.ops import resample as tr

torch.set_num_threads(2)
ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _maxabs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _coords(rng, h, w, shape):
    """Coordinates inside, on the edges of, and off the frame, with some
    exact integers (the clamp and derivative-mask boundaries)."""
    c = np.stack(
        [rng.uniform(-4.0, h + 3.0, shape), rng.uniform(-4.0, w + 3.0, shape)], -1
    ).astype(np.float32)
    flat = c.reshape(-1, 2)
    flat[:6] = [[0, 0], [h - 1, w - 1], [0, w - 1], [h - 1, 0], [2, 3], [-1, w]]
    return c


@pytest.mark.parametrize("c", [1, 3, 4])
def test_bilinear_sample(c):
    rng = np.random.default_rng(c)
    h, w = 23, 31
    img = rng.random((h, w, c), dtype=np.float32)
    co = _coords(rng, h, w, (17, 19))
    ref = jr.bilinear_sample(jnp.asarray(img), jnp.asarray(co))
    got = tr.bilinear_sample(_t(img), _t(co))
    assert got.shape == tuple(ref.shape)
    assert _maxabs(ref, got) <= ATOL


def test_bilinear_sample_2d_image():
    rng = np.random.default_rng(7)
    img = rng.random((12, 9), dtype=np.float32)
    co = _coords(rng, 12, 9, (5, 6))
    ref = jr.bilinear_sample(jnp.asarray(img), jnp.asarray(co))
    got = tr.bilinear_sample(_t(img), _t(co))
    assert got.shape == tuple(ref.shape)
    assert _maxabs(ref, got) <= ATOL


@pytest.mark.parametrize("c", [1, 3])
def test_bilinear_sample_with_grad(c):
    rng = np.random.default_rng(10 + c)
    h, w = 21, 26
    img = rng.random((h, w, c), dtype=np.float32)
    co = _coords(rng, h, w, (h, w))
    rv, rd = jr.bilinear_sample_with_grad(jnp.asarray(img), jnp.asarray(co))
    gv, gd = tr.bilinear_sample_with_grad(_t(img), _t(co))
    assert gd.shape == tuple(rd.shape) == (h, w, c, 2)
    assert _maxabs(rv, gv) <= ATOL
    assert _maxabs(rd, gd) <= ATOL
    # clamped coordinates have zero derivative on both sides
    off = (co[..., 0] <= 0) | (co[..., 0] >= h - 1)
    assert off.any() and np.all(gd.numpy()[off][..., 0] == 0.0)


def test_bicubic_sample():
    rng = np.random.default_rng(3)
    h, w = 19, 24
    img = rng.random((h, w, 3), dtype=np.float32)
    co = _coords(rng, h, w, (9, 11))
    ref = jr.bicubic_sample(jnp.asarray(img), jnp.asarray(co))
    got = tr.bicubic_sample(_t(img), _t(co))
    assert _maxabs(ref, got) <= 1e-5  # 16 weighted taps: a few ulps of slack


def test_inside_mask_and_grid():
    rng = np.random.default_rng(4)
    co = _coords(rng, 10, 14, (8, 9))
    for margin in (0.0, 1.5):
        ref = jr.inside_mask(jnp.asarray(co), 10, 14, margin)
        got = tr.inside_mask(_t(co), 10, 14, margin)
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    np.testing.assert_array_equal(np.asarray(jr.grid_coords(5, 7)), tr.grid_coords(5, 7).numpy())


def _smooth_field(h, w, amp, seed):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 2 * np.pi, 2)
    return np.stack(
        [amp * np.sin(yy / 17.0 + ph[0]), amp * np.cos(xx / 23.0 + ph[1])], -1
    ).astype(np.float32)


def test_halfway_warp_plain_matches_fused_warp_planes():
    """Kernel 3's plain version against the Pallas warp kernel run in
    interpret mode: same values, derivatives and plane order."""
    from videomorphing_tpu.pallas.warp import fused_warp_planes

    rng = np.random.default_rng(0)
    h, w, c = 64, 256, 3
    i0 = rng.random((h, w, c), dtype=np.float32)
    i1 = rng.random((h, w, c), dtype=np.float32)
    v = _smooth_field(h, w, 2.5, 1)
    ref = fused_warp_planes(jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(v), interpret=True)
    got = kw.halfway_warp(_t(i0), _t(i1), _t(v))
    assert got.shape == tuple(ref.shape) == (6 * c, h, w)
    assert _maxabs(ref, got) <= ATOL
    assert kw.halfway_warp.launches == 0


@pytest.mark.parametrize("c", [1, 3, 4])
def test_sampler_plain_matches_reference(c):
    """Kernel 4's plain version against the reference bilinear_sample on an
    arbitrary smooth coordinate map running off the frame."""
    rng = np.random.default_rng(20 + c)
    h, w = 40, 72
    img = rng.random((h, w, c), dtype=np.float32)
    g = np.stack(np.mgrid[0:h, 0:w], -1).astype(np.float32)
    co = g + _smooth_field(h, w, 9.0, c)
    ref = jr.bilinear_sample(jnp.asarray(img), jnp.asarray(co))
    got = kw.bilinear_sample(_t(img), _t(co))
    assert _maxabs(ref, got) <= ATOL
    assert kw.bilinear_sample.launches == 0


@pytest.mark.parametrize(
    "img_shape,co_shape",
    [((12, 9), (5, 6)), ((12, 9, 3), (4,)), ((12, 9), (0,)), ((12, 9, 2), (7, 5)), ((12, 9, 3), (2, 3, 4)),
     ((12, 9, 5), (7, 5))],
    ids=["2d-image", "points-n4", "points-n0", "map", "3d-coords", "c5-map"],
)
def test_sampler_shape_contract(img_shape, co_shape):
    """Kernel 4's wrapper takes what ``resample.bilinear_sample`` takes: an
    (H, W) or (H, W, C) image and (..., 2) coordinates, reshaped to the
    kernel's (H, W, C) x (1, M, 2) contract and back before the dispatch.
    Bitwise against the plain version and the reference."""
    rng = np.random.default_rng(len(img_shape) + sum(co_shape))
    img = rng.random(img_shape, dtype=np.float32)
    h, w = img_shape[0], img_shape[1]
    if int(np.prod(co_shape)) >= 6:
        co = _coords(rng, h, w, co_shape)
    else:  # a few points, off the frame too
        co = np.stack([rng.uniform(-2.0, h + 1.0, co_shape), rng.uniform(-2.0, w + 1.0, co_shape)], -1)
        co = co.astype(np.float32)
    got = kw.bilinear_sample(_t(img), _t(co))
    ref = jr.bilinear_sample(jnp.asarray(img), jnp.asarray(co))
    assert got.shape == tuple(ref.shape) == co_shape + img_shape[2:]
    assert torch.equal(got, tr.bilinear_sample(_t(img), _t(co)))
    if got.numel():
        assert _maxabs(ref, got) <= ATOL
    assert kw.bilinear_sample.launches == 0


def test_sampler_rejects_bad_shapes():
    img = torch.zeros((6, 7, 3))
    for bad_img, bad_co in (
        (torch.zeros((2, 6, 7, 3)), torch.zeros((4, 2))),
        (img, torch.zeros((4, 3))),
        (torch.zeros(6), torch.zeros((4, 2))),
    ):
        with pytest.raises(ValueError):
            kw.bilinear_sample(bad_img, bad_co)
    with pytest.raises(ValueError):
        kw.bilinear_sample_batched(torch.zeros((2, 6, 7)), torch.zeros((2, 3, 3, 2)))
    with pytest.raises(ValueError):
        kw.bilinear_sample_batched(torch.zeros((2, 6, 7, 3)), torch.zeros((3, 3, 3, 2)))


@pytest.mark.parametrize("c", [1, 2, 4, 5])
def test_batched_sampler_plain_matches_per_image(c):
    """Kernel 4's batched form: n images of one shape, each at its own map,
    bitwise equal to a loop of single samples, and within 1e-6 of the
    reference's per-image ``bilinear_sample``."""
    rng = np.random.default_rng(30 + c)
    n, h, w = 5, 19, 26
    imgs = rng.random((n, h, w, c), dtype=np.float32)
    co = _coords(rng, h, w, (n, 11, 13))
    got = kw.bilinear_sample_batched(_t(imgs), _t(co))
    assert got.shape == (n, 11, 13, c)
    for k in range(n):
        assert torch.equal(got[k], kw.bilinear_sample(_t(imgs[k]), _t(co[k])))
        assert _maxabs(jr.bilinear_sample(jnp.asarray(imgs[k]), jnp.asarray(co[k])), got[k]) <= ATOL
    assert kw.bilinear_sample_batched.launches == 0


# (C, n, M, image, coordinate and output byte offsets from a 16-byte
# boundary) -> whether kernel 4 takes its vector instantiation; the scalar
# instantiation of the same C (the generic one for C = 5) otherwise
VECTOR_CHOICES = [
    (1, 1, 1000, 0, 0, 0, True),
    (1, 1, 999, 4, 0, 0, True),       # a grey image needs 4-byte alignment only; M may be odd with n = 1
    (1, 1, 1000, 0, 8, 0, False),     # two coordinate pairs per float4
    (1, 1, 1000, 0, 0, 4, False),     # four outputs per float4
    (1, 58, 518400, 0, 0, 0, True),   # the flow warps' batch
    (1, 3, 1002, 0, 0, 0, False),     # image k's coordinates start unaligned
    (2, 1, 1000, 8, 0, 0, True),      # corners as float2
    (2, 1, 1000, 4, 0, 0, False),
    (2, 29, 1001, 0, 0, 0, False),
    (2, 29, 1002, 0, 0, 0, True),
    (3, 2, 2073600, 4, 0, 0, True),   # the render's colour samples
    (3, 2, 2073602, 0, 0, 0, False),
    (3, 1, 7, 0, 4, 0, False),
    (4, 1, 1048576, 0, 0, 0, True),   # the path inversion's stacked [disp, v]
    (4, 1, 1048576, 8, 0, 0, False),  # corners as float4
    (4, 3, 7, 0, 8, 0, True),         # one coordinate pair per float2
    (4, 1, 7, 0, 4, 0, False),
    (4, 1, 7, 0, 0, 8, False),
    (5, 1, 1000, 0, 0, 0, False),     # no vector form beyond C = 4
    (6, 2, 1000, 0, 0, 0, False),
]


@pytest.mark.parametrize("c,n,m,img_off,co_off,out_off,vector", VECTOR_CHOICES)
def test_sampler_instantiation_choice(c, n, m, img_off, co_off, out_off, vector):
    """Kernel 4's wrapper picks the vector instantiation from C, the batch
    and the pointers' alignment alone (a pure function, here on the CPU)."""
    base = 1 << 20
    assert kw.sample_vectorized(c, n, m, base + img_off, base + 64 + co_off, base + 128 + out_off) is vector


def test_sampler_views_with_a_storage_offset():
    """A contiguous view one float into its storage (as one image of a
    stack can be) is misaligned for the vector loads; the wrapper's choice
    sees it, and the plain path is unaffected by the offset."""
    rng = np.random.default_rng(40)
    img = _t(rng.random((9, 11, 4), dtype=np.float32))
    co = _t(_coords(rng, 9, 11, (6, 7)))
    buf = torch.empty(img.numel() + 1)
    view = buf[1:].view(img.shape)
    view.copy_(img)
    assert view.is_contiguous() and view.data_ptr() % 16 == (img.data_ptr() + 4) % 16 == 4
    assert kw.sample_vectorized(4, 1, 42, img.data_ptr(), co.data_ptr(), 0)
    assert not kw.sample_vectorized(4, 1, 42, view.data_ptr(), co.data_ptr(), 0)
    assert torch.equal(kw.bilinear_sample(view, co), kw.bilinear_sample(img, co))
    assert kw.bilinear_sample.launches == 0
