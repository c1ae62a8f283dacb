"""The frozen copies of the yardstick, pinned to fixed numbers (not to the
program's source, so that a change to the program cannot move them)."""

import pytest
import torch

from vmbench import inputs, roofline


def test_clip_formula_pinned():
    a, b = inputs.make_clips(2, 8, 12, 12345, "cpu")
    assert a.shape == b.shape == (2, 8, 12, 3) and a.dtype == torch.float32
    assert a.sum().item() == pytest.approx(340.9150085449219, rel=1e-6)
    assert b.sum().item() == pytest.approx(340.876953125, rel=1e-6)
    assert a[1, 3, 5].tolist() == pytest.approx([0.614748477935791, 0.5506190657615662, 0.6491065621376038], rel=1e-6)
    assert b[0, 7, 11].tolist() == pytest.approx([0.6632108092308044, 0.7595215439796448, 0.6988880038261414], rel=1e-6)


def test_clip_formula_clips_differ_only_by_the_blob():
    a, b = inputs.make_clips(2, 64, 200, 1, "cpu")
    d = (a[0] - b[0]).abs().amax(-1)
    assert d[:, :40].max() < 1e-6 and d[:, -40:].max() < 1e-6  # the texture is shared
    assert d[32].max() > 0.1  # the blobs 20 px apart


def test_item_seeds_distinct_and_fixed():
    assert inputs.item_seeds(7, 3) == [5061563556724077661, 9433490490806083541, 13310695785968920259]
    assert inputs.item_seeds(-1, 2)[0] == 12859645445789163360
    assert inputs.item_seeds(2**70, 1) == [5836529245451711556]
    assert len(set(inputs.item_seeds(3141592653, 8))) == 8


def test_user_points_pinned():
    p = inputs.user_points(1024, 1024, 4)
    assert p.shape == (4, 2, 2)
    assert p[:, 0, 0].tolist() == pytest.approx([307.2, 443.7333, 580.2667, 716.8], rel=1e-6)
    assert p[:, 0, 1].tolist() == pytest.approx([460.8] * 4)
    assert p[:, 1, 1].tolist() == pytest.approx([563.2] * 4)
    assert inputs.user_points(10, 10, 0).shape == (0, 2, 2)


def test_sweep_arithmetic_pinned():
    assert roofline.sweep_bytes(3, True, 4) == 128
    assert roofline.sweep_bytes(3, False, 2) == 64
    assert roofline.sweep_ops_per_pixel(3, 5, True) == 937
    assert roofline.sweep_ops_per_pixel(3, 5, False) == 453
    # 1024^2 at window 5: bound by bytes, 128 B x 2^20 / 3.35 TB/s
    assert roofline.sweep_grad_bound_s(1024, 1024, 3, 5) == pytest.approx(4.006499343283582e-05, rel=1e-12)
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)


def test_pyramid_and_rate_pinned():
    assert roofline.auto_n_levels(1024, 1024, 16) == 7
    assert roofline.pyramid_shapes(1080, 1920, roofline.auto_n_levels(1080, 1920, 16)) == [
        (1080, 1920), (540, 960), (270, 480), (135, 240), (68, 120), (34, 60), (17, 30)]
    assert roofline.iters_per_s_per_mpix(600, 0.5, 1024, 1024) == pytest.approx(1144.4091796875)
