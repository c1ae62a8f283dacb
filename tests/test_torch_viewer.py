"""Port parity: the viewer instruments (``videomorphing_tpu_torch/viewer.py``
against ``videomorphing_tpu/viewer.py``), on the same seeded numpy inputs.

- ``field_color`` and ``field_magnitude``: numpy copies, equal exactly;
- ``halfway_image``: within 1e-6 of the reference's (its two samples go
  through kernel 4's plain version on the CPU), on random 8 x 10 x 3 images
  with a zero field and on a smooth 40 x 56 field of a few pixels;
- ``show_morph_strip``: equal exactly, from numpy frames and from a tensor.
"""

import numpy as np
import pytest
import torch

from videomorphing_tpu import viewer as jv
from videomorphing_tpu_torch import viewer as tv

torch.set_num_threads(2)


def _smooth_field(h, w, amp, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = np.stack([np.sin(yy / 7.0 + rng.uniform(0, 6)), np.cos(xx / 9.0 + rng.uniform(0, 6))], -1)
    return (amp * f + 0.3 * rng.standard_normal((h, w, 2))).astype(np.float32)


@pytest.mark.parametrize("max_mag", [None, 2.0, 50.0])
def test_field_color_and_magnitude_equal_reference(max_mag):
    v = _smooth_field(12, 16, 3.0, 1)
    v[0, 0] = 0.0
    np.testing.assert_array_equal(tv.field_color(v, max_mag), jv.field_color(v, max_mag))
    np.testing.assert_array_equal(tv.field_magnitude(v), jv.field_magnitude(v))
    zero = np.zeros((6, 8, 2), np.float32)
    np.testing.assert_array_equal(tv.field_color(zero), jv.field_color(zero))


@pytest.mark.parametrize("case", ["zero_field", "smooth_field"])
def test_halfway_image_matches_reference(case):
    rng = np.random.default_rng(0)
    h, w = (8, 10) if case == "zero_field" else (40, 56)
    i0 = rng.random((h, w, 3)).astype(np.float32)
    i1 = rng.random((h, w, 3)).astype(np.float32)
    v = np.zeros((h, w, 2), np.float32) if case == "zero_field" else _smooth_field(h, w, 4.0, 2)
    ref = jv.halfway_image(i0, i1, v)
    got = tv.halfway_image(i0, i1, v, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == (h, w, 3)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    if case == "zero_field":
        np.testing.assert_allclose(got, 0.5 * (i0 + i1), atol=1e-6)
    # tensors in, numpy out; a CPU field runs where asked
    got_t = tv.halfway_image(torch.from_numpy(i0), torch.from_numpy(i1), torch.from_numpy(v), device="cpu")
    np.testing.assert_array_equal(got_t, got)


def test_halfway_image_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros((4, 4, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.halfway_image(z, z, np.zeros((4, 4, 2), np.float32))


@pytest.mark.parametrize("n", [1, 3, 6, 9])
def test_show_morph_strip_matches_reference(n):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    frames = np.random.default_rng(3).random((7, 6, 5, 3)).astype(np.float32)
    ref = jv.show_morph_strip(frames, n)
    np.testing.assert_array_equal(tv.show_morph_strip(frames, n), ref)
    np.testing.assert_array_equal(tv.show_morph_strip(torch.from_numpy(frames), n), ref)
    plt.close("all")
