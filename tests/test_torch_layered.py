"""Port parity: the layered image-pair and clip-pair morphs.

The same seeded numpy inputs go through the JAX reference and the port.
The pair parts run at 128 x 160 (the half-resolution path inversion) on a
textured background with a blob that moves 16 px, one layer on the blob.
One JAX ``solve_clip_fields_layered`` (module fixture, T = 4, 40 x 56, two
layers moving in opposite directions) gives layered fields and the full
clips' flows, carried across with ``interop``.

Tolerances:

- ``neutralize``: max abs <= 1e-6 (values in [0, 1]; the mask sums run in
  another order);
- ``_warp_layer`` from identical (v, b, masks, t): frame and alpha within
  1e-5 (the same sampler arithmetic; the linear blend);
- ``render_layered`` from carried-across ``LayeredArtifacts``: max abs
  <= 1e-4 with both blend modes, as the pair render (the DCT blend sums
  over whole rows and columns in float32);
- the clip composite from the reference's layered fields and flows: <= 1e-4
  (the render tolerance; well inside the 2e-3 of the video pipeline);
- end to end, the bound is the reference's own sensitivity. A layer solves
  on neutralized images, flat outside the mask, where the SSIM statistics
  cancel (var = E[x^2] - E[x]^2 of a constant); float32 summation order
  then flips an Armijo decision, and a layer field moves by up to 0.5 px
  (ROADMAP section 3). The reference moves its OWN frames as far when one
  input gets 1-ulp noise: on the pair case by 0.051-0.075 max abs
  (mostly border rows, where the validity test flips) and 0.7e-5 to
  1.3e-5 mean abs; on the clip case by 5.2e-3 max abs, 3.3e-6 mean abs.
  ``morph_pair_layered``: max abs <= 0.1 and mean abs <= 5e-5;
  ``morph_clips_layered``: max abs <= 1e-2 and mean abs <= 1e-5. The
  background alone agrees within the pair and video tolerances
  (``test_torch_pair.py``, ``test_torch_video_pipeline.py``).

The behavioural checks of ``tests/test_layered.py`` (a layer that follows
its own motion, crossing video layers, keyframed layer points, endpoints)
then run on the port at the same sizes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videomorphing_tpu import api as jax_api
from videomorphing_tpu.config import MorphParams as JaxMorphParams
from videomorphing_tpu.config import SynthParams as JaxSynthParams
from videomorphing_tpu.config import VideoParams as JaxVideoParams
from videomorphing_tpu.models import layered as jl
from videomorphing_tpu.video import layered as jvl
from videomorphing_tpu.video import pipeline as jp
from videomorphing_tpu_torch import api
from videomorphing_tpu_torch.config import MorphParams, SynthParams, VideoParams
from videomorphing_tpu_torch.interop import (
    flows_from_numpy,
    layered_artifacts_from_numpy,
    layered_fields_from_numpy,
)
from videomorphing_tpu_torch.models import layered as tl
from videomorphing_tpu_torch.video import layered as tvl

torch.set_num_threads(2)
H, W = 128, 160
JMP = JaxMorphParams(iters_coarse=8, iters_fine=4)
JVP = JaxVideoParams(flow_iters=20)
TS = np.linspace(0.0, 1.0, 3).astype(np.float32)
T_LEN, VH, VW = 4, 40, 56


def _port(p):
    cls = {JaxMorphParams: MorphParams, JaxSynthParams: SynthParams, JaxVideoParams: VideoParams}[type(p)]
    return cls(**dataclasses.asdict(p))


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _absdiff(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b.detach().numpy() if isinstance(b, torch.Tensor) else b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b)


def _maxabs(a, b):
    return float(np.max(_absdiff(a, b)))


def _scene(rng, h=48, w=64, blob_x=20.0):
    """Textured background + a bright blob at x = blob_x: (img, mask)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    tex = rng.random((h, w, 3), dtype=np.float32)
    for _ in range(2):
        tex = 0.25 * (np.roll(tex, 1, 0) + np.roll(tex, -1, 0) + np.roll(tex, 1, 1) + np.roll(tex, -1, 1))
    bg = 0.2 + 0.3 * tex
    d2 = (yy - h / 2) ** 2 + (xx - blob_x) ** 2
    blob = np.exp(-0.5 * d2 / 5.0**2)
    img = np.clip(bg + np.stack([0.8 * blob, 0.7 * blob, 0.2 * blob], -1), 0, 1)
    return img.astype(np.float32), (blob > 0.05).astype(np.float32)


def _blob(yy, xx, cy, cx, col):
    g = np.exp(-0.5 * ((yy - cy) ** 2 + (xx - cx) ** 2) / 4.0**2)
    return np.stack([c * g for c in col], -1).astype(np.float32)


def _bg(h, w):
    tex = np.random.default_rng(7).random((h, w, 3), dtype=np.float32)
    for _ in range(2):
        tex = 0.25 * (np.roll(tex, 1, 0) + np.roll(tex, -1, 0) + np.roll(tex, 1, 1) + np.roll(tex, -1, 1))
    return 0.15 + 0.2 * tex


def _crossing_clip(x1_start, x2_start):
    """Layer 1 (red, top) moves +2 px/frame, layer 2 (blue, bottom) -2
    px/frame over a static textured background: (clip, masks 1, masks 2)."""
    yy, xx = np.mgrid[0:VH, 0:VW].astype(np.float32)
    bg = _bg(VH, VW)
    frames, m1s, m2s = [], [], []
    for k in range(T_LEN):
        x1, x2 = x1_start + 2.0 * k, x2_start - 2.0 * k
        frames.append(np.clip(bg + _blob(yy, xx, 10, x1, (0.9, 0.2, 0.1)) + _blob(yy, xx, 30, x2, (0.1, 0.2, 0.9)), 0, 1))
        m1s.append((np.hypot(yy - 10, xx - x1) < 8).astype(np.float32))
        m2s.append((np.hypot(yy - 30, xx - x2) < 8).astype(np.float32))
    return np.stack(frames).astype(np.float32), np.stack(m1s), np.stack(m2s)


@pytest.fixture(scope="module")
def pair():
    i0, m0 = _scene(np.random.default_rng(0), H, W, blob_x=72.0)
    i1, m1 = _scene(np.random.default_rng(0), H, W, blob_x=88.0)
    pts = np.asarray([[[H / 2, 72.0], [H / 2, 88.0]]], np.float32)
    return i0, i1, m0, m1, pts


@pytest.fixture(scope="module")
def jax_art(pair):
    """The reference's layered artifacts (default synthesis: bulges on)."""
    i0, i1, m0, m1, pts = pair
    layer = jl.Layer(jnp.asarray(m0), jnp.asarray(m1), jnp.asarray(pts))
    art = jl.solve_layered(jnp.asarray(i0), jnp.asarray(i1), [layer], None, JMP, JaxSynthParams())
    return (np.asarray(art.v_bg), np.asarray(art.b_bg),
            [np.asarray(v) for v in art.v_layers], [np.asarray(b) for b in art.b_layers])


@pytest.fixture(scope="module")
def layered_clip():
    """One reference layered clip solve: fields, flows and its composite."""
    ca, m1a, m2a = _crossing_clip(16.0, 40.0)
    cb, m1b, m2b = _crossing_clip(22.0, 34.0)
    masks = [(m1a, m1b), (m2a, m2b)]
    jlayers = [jvl.VideoLayer(jnp.asarray(a), jnp.asarray(b)) for a, b in masks]
    fields_bg, fields_layers, flows = jvl.solve_clip_fields_layered(
        jnp.asarray(ca), jnp.asarray(cb), jlayers, None, JMP, JVP
    )
    jsp = JaxSynthParams()
    times = jnp.linspace(0.0, 1.0, T_LEN, dtype=jnp.float32)
    b_bg = jp.render_video(jnp.asarray(ca), jnp.asarray(cb), fields_bg, times=times, sp=jsp, vp=JVP,
                           flows=flows, render=False).bulges
    conf_a = jp._clip_confidences(flows["fa_fwd"], flows["fa_bwd"], T_LEN, JVP)
    conf_b = jp._clip_confidences(flows["fb_fwd"], flows["fb_bwd"], T_LEN, JVP)
    layer_xs = tuple(
        (jnp.asarray(a), jnp.asarray(b), f, jp._jitted_bulges(jsp)(f)) for (a, b), f in zip(masks, fields_layers)
    )
    frames = jvl._jitted_layered_render(jsp, 2)(
        jnp.asarray(ca), jnp.asarray(cb), fields_bg, b_bg, times, conf_a, conf_b, layer_xs
    )
    return dict(
        ca=ca, cb=cb, masks=masks, fields_bg=np.asarray(fields_bg),
        fields_layers=[np.asarray(f) for f in fields_layers],
        flows={k: np.asarray(v) for k, v in flows.items()}, frames=np.asarray(frames),
    )


def test_neutralize(pair, layered_clip):
    i0, _, m0, _, _ = pair
    ref = jl.neutralize(jnp.asarray(i0), jnp.asarray(m0))
    assert _maxabs(ref, tl.neutralize(_t(i0), _t(m0))) <= 1e-6
    ca, (m1a, _) = layered_clip["ca"], layered_clip["masks"][0]
    ref = jax.vmap(jl.neutralize)(jnp.asarray(ca), jnp.asarray(m1a))
    assert _maxabs(ref, tl.neutralize(_t(ca), _t(m1a))) <= 1e-6
    empty = tl.neutralize(_t(i0), torch.zeros(H, W))
    assert torch.equal(empty, torch.zeros_like(empty))


@pytest.mark.parametrize("t", [0.0, 0.35, 1.0])
def test_warp_layer_from_reference_field(pair, jax_art, t):
    i0, i1, m0, m1, _ = pair
    _, _, v_layers, b_layers = jax_art
    jsp = JaxSynthParams(blend_mode="linear")
    f_ref, a_ref = jl._warp_layer(
        jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(m0), jnp.asarray(m1),
        jnp.asarray(v_layers[0]), jnp.asarray(b_layers[0]), jnp.float32(t), jsp,
    )
    f_got, a_got = tl._warp_layer(_t(i0), _t(i1), _t(m0), _t(m1), _t(v_layers[0]), _t(b_layers[0]), t, _port(jsp))
    assert float(a_got.max()) > 0.5  # the layer is in the frame
    assert _maxabs(f_ref, f_got) <= 1e-5
    assert _maxabs(a_ref, a_got) <= 1e-5


@pytest.mark.parametrize("blend_mode", ["poisson", "linear"])
def test_render_layered_from_reference_artifacts(pair, jax_art, blend_mode):
    i0, i1, m0, m1, _ = pair
    jsp = JaxSynthParams(blend_mode=blend_mode)
    v_bg, b_bg, v_layers, b_layers = jax_art
    jart = jl.LayeredArtifacts(jnp.asarray(v_bg), jnp.asarray(b_bg),
                               tuple(map(jnp.asarray, v_layers)), tuple(map(jnp.asarray, b_layers)))
    ref = jl.render_layered(jnp.asarray(i0), jnp.asarray(i1), [jl.Layer(jnp.asarray(m0), jnp.asarray(m1))],
                            jart, jnp.asarray(TS), jsp)
    art = layered_artifacts_from_numpy(v_bg, b_bg, v_layers, b_layers)
    got = tl.render_layered(_t(i0), _t(i1), [tl.Layer(_t(m0), _t(m1))], art, TS, _port(jsp))
    assert got.shape == (3, H, W, 3)
    assert _maxabs(ref, got) <= 1e-4


def test_morph_pair_layered_end_to_end(pair):
    i0, i1, m0, m1, pts = pair
    layers = [dict(mask0=m0, mask1=m1, points=pts)]
    ref = jax_api.morph_pair_layered(i0, i1, layers, n_frames=3, mp=JMP, sp=JaxSynthParams())
    got = api.morph_pair_layered(i0, i1, layers, n_frames=3, mp=_port(JMP), sp=SynthParams(), device="cpu")
    assert got.shape == (3, H, W, 3) and got.dtype == torch.float32
    d = _absdiff(ref, got)
    assert d.max() <= 0.1 and d.mean() <= 5e-5


def test_clip_composite_from_reference_fields(layered_clip):
    c = layered_clip
    fields_bg, fields_layers = layered_fields_from_numpy(c["fields_bg"], c["fields_layers"])
    layers = [tvl.VideoLayer(_t(a), _t(b)) for a, b in c["masks"]]
    got = tvl.render_clips_layered(
        _t(c["ca"]), _t(c["cb"]), layers, fields_bg, fields_layers, flows_from_numpy(c["flows"]),
        sp=SynthParams(), vp=_port(JVP),
    )
    assert got.shape == (T_LEN, VH, VW, 3)
    assert _maxabs(c["frames"], got) <= 1e-4


def test_morph_clips_layered_end_to_end(layered_clip):
    c = layered_clip
    layers = [dict(mask0=a, mask1=b) for a, b in c["masks"]]
    res = api.morph_clips_layered(c["ca"], c["cb"], layers, mp=_port(JMP), vp=_port(JVP), device="cpu")
    assert res.frames.shape == (T_LEN, VH, VW, 3) and len(res.fields_layers) == 2
    d = _absdiff(c["frames"], res.frames)
    assert d.max() <= 1e-2 and d.mean() <= 1e-5


def test_static_mask_broadcasts_over_time():
    m = torch.rand(5, 7)
    mt = tvl._masks_t(m, 3)
    assert mt.shape == (3, 5, 7) and all(torch.equal(mt[k], m) for k in range(3))
    assert tvl._masks_t(mt, 3) is mt


# --- the behavioural checks of tests/test_layered.py, on the port ---------

BEHAVE_MP = MorphParams(n_levels=2, iters_coarse=30, iters_fine=15)
BEHAVE_SP = SynthParams(quadratic_paths=False, blend_mode="linear")


def _red_centroid(frame, xx):
    red = np.maximum(frame[..., 0] - frame[..., 2] - 0.1, 0)
    return float((xx * red).sum() / max(red.sum(), 1e-6))


def test_layer_follows_its_own_motion(rng):
    """A blob moves +12 px over a static background: the layered morph
    carries the blob monotonically and keeps the background fixed."""
    h, w = 48, 64
    i0, m0 = _scene(rng, h, w, blob_x=20.0)
    i1, m1 = _scene(np.random.default_rng(0), h, w, blob_x=32.0)
    pts = np.asarray([[[h / 2, 20.0], [h / 2, 32.0]]], np.float32)
    frames = api.morph_pair_layered(
        i0, i1, [dict(mask0=m0, mask1=m1, points=pts)], n_frames=5, mp=BEHAVE_MP, sp=BEHAVE_SP, device="cpu"
    ).numpy()
    assert frames.shape == (5, h, w, 3)
    xx = np.mgrid[0:h, 0:w][1]
    cxs = [_red_centroid(f, xx) for f in frames]
    assert abs(cxs[0] - 20.0) < 2.5 and abs(cxs[-1] - 32.0) < 2.5, cxs
    assert (np.diff(cxs) > 0).all(), cxs
    assert np.abs(frames[0][2:10, 44:62] - frames[-1][2:10, 44:62]).mean() < 0.04


def test_video_layers_track_opposite_motions():
    """Two video layers moving oppositely across a 4-frame clip: the
    composite tracks both (a single field cannot)."""
    clip_a, m1a, m2a = _crossing_clip(16.0, 40.0)
    clip_b, m1b, m2b = _crossing_clip(22.0, 34.0)
    res = api.morph_clips_layered(
        clip_a, clip_b, [dict(mask0=m1a, mask1=m1b), dict(mask0=m2a, mask1=m2b)],
        mp=BEHAVE_MP, sp=BEHAVE_SP, vp=VideoParams(flow_iters=20), device="cpu",
    )
    frames = res.frames.numpy()
    assert frames.shape == (T_LEN, VH, VW, 3) and np.isfinite(frames).all()
    xx = np.mgrid[0:VH, 0:VW][1].astype(np.float32)
    for k, t in enumerate(np.linspace(0, 1, T_LEN)):
        e1 = (1 - t) * (16 + 2 * k) + t * (22 + 2 * k)
        e2 = (1 - t) * (40 - 2 * k) + t * (34 - 2 * k)
        blue = np.maximum(frames[k, 20:, :, 2] - frames[k, 20:, :, 0] - 0.1, 0)
        c1 = _red_centroid(frames[k, :20], xx[:20])
        c2 = float((xx[20:] * blue).sum() / max(blue.sum(), 1e-6))
        assert abs(c1 - e1) < 2.5, (k, c1, e1)
        assert abs(c2 - e2) < 2.5, (k, c2, e2)


def test_endpoints_match_inputs(rng):
    i0, m0 = _scene(rng, blob_x=22.0)
    i1, m1 = _scene(np.random.default_rng(0), blob_x=28.0)
    frames = api.morph_pair_layered(
        i0, i1, [dict(mask0=m0, mask1=m1)], n_frames=3, mp=BEHAVE_MP, sp=BEHAVE_SP, device="cpu"
    ).numpy()
    assert np.abs(frames[0][2:-2, 2:-2] - i0[2:-2, 2:-2]).mean() < 0.02
    assert np.abs(frames[-1][2:-2, 2:-2] - i1[2:-2, 2:-2]).mean() < 0.02


def test_video_layer_keyframed_points():
    """Layer points in keyframe form (first and last frame, flow-tracked
    between on the neutralized clips): the layer's motion still resolves."""
    yy, xx = np.mgrid[0:VH, 0:VW].astype(np.float32)
    bg = _bg(VH, VW)

    def make_clip(x_start):
        frames, ms = [], []
        for k in range(T_LEN):
            x = x_start + 2.0 * k
            frames.append(np.clip(bg + _blob(yy, xx, 20, x, (0.9, 0.2, 0.1)), 0, 1))
            ms.append((np.hypot(yy - 20, xx - x) < 8).astype(np.float32))
        return np.stack(frames).astype(np.float32), np.stack(ms)

    clip_a, ma = make_clip(16.0)
    clip_b, mb = make_clip(22.0)

    def kp(k):
        return np.asarray([[[20.0, 16.0 + 2.0 * k], [20.0, 22.0 + 2.0 * k]]], np.float32)

    res = api.morph_clips_layered(
        clip_a, clip_b, [dict(mask0=ma, mask1=mb, points={0: kp(0), T_LEN - 1: kp(T_LEN - 1)})],
        mp=BEHAVE_MP, sp=BEHAVE_SP, vp=VideoParams(flow_iters=20), device="cpu",
    )
    frames = res.frames.numpy()
    assert frames.shape == (T_LEN, VH, VW, 3) and np.isfinite(frames).all()
    for k, t in enumerate(np.linspace(0, 1, T_LEN)):
        e = (1 - t) * (16 + 2 * k) + t * (22 + 2 * k)
        c = _red_centroid(frames[k], xx)
        assert abs(c - e) < 2.5, (k, c, e)
