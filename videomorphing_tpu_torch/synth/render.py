"""Frame rendering: invert the motion path, warp both sources, blend.

Port of ``videomorphing_tpu/synth/render.py``. Each output pixel q finds its
halfway point p with x_t(p) = q by a short fixed-point iteration (coarse to
fine), then both sources are sampled backward at p -/+ v(p) and blended.

Every bilinear sample here goes through kernel 4 (``kernels.warp.
bilinear_sample`` and its batched form), which launches the CUDA sampler
for tensors on the card and runs its plain version on the CPU. The
reference's ``SynthParams.fused_sampling`` and its TPU-only dispatch are
ignored: both paths compute the same numbers. ``sampling="bicubic"`` stays
plain PyTorch, as in the reference, which has no bicubic kernel.

On the card a frame is a fixed chain of about 1,300 launches on fixed
shapes, which the host takes longer to issue than the card to run, so
:func:`render_frame` captures the chain once per signature as a CUDA graph
and replays it: the inputs are copied into the graph's buffers and the
time enters as data, a device vector of :func:`time_values`, which the
eager body reads as well.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from videomorphing_tpu_torch.config import SynthParams
from videomorphing_tpu_torch.graphs import LRU, Captured, capture, replayable
from videomorphing_tpu_torch.kernels import COUNTED
from videomorphing_tpu_torch.kernels.warp import bilinear_sample, bilinear_sample_batched
from videomorphing_tpu_torch.ops.pyramid import downsample_2x, resize_bilinear
from videomorphing_tpu_torch.ops.resample import bicubic_sample, grid_coords, inside_mask
from videomorphing_tpu_torch.synth.blend import blend_weights_of, blend_with_weights
from videomorphing_tpu_torch.utils import profiling

f32 = np.float32


GRAPHS_KEPT = 4  # captured frame graphs kept; the least recently used is freed first


def time_values(t) -> Tuple[float, float, float, float]:
    """The numbers a frame at time ``t`` multiplies by: the path's
    coefficients (2t - 1) and 4t(1 - t), rounded to float32 step by step as
    the reference's float32 ``t`` rounds them, and the blend's factors
    1 - t and t of the float32 ``t``."""
    t = f32(t)
    return (float(f32(2.0) * t - f32(1.0)), float(f32(4.0) * t * (f32(1.0) - t)), 1.0 - float(t), float(t))


def _time_vector(t, like: torch.Tensor) -> torch.Tensor:
    """:func:`time_values` of ``t`` as a vector of ``like``'s dtype and device."""
    tv = torch.empty(4, dtype=like.dtype, device=like.device)
    _write_times(tv.unbind(), t)
    return tv


def _write_times(slots: Sequence[torch.Tensor], t) -> None:
    """Write :func:`time_values` of ``t`` into a time vector's 0-d views, in
    stream order (a host copy from pageable memory would wait on the card)."""
    for slot, x in zip(slots, time_values(t)):
        slot.fill_(x)


def _displacement(v: torch.Tensor, b: Optional[torch.Tensor], cv, cb) -> torch.Tensor:
    d = cv * v
    if b is not None:
        d = d + cb * b
    return d


def path_displacement(v: torch.Tensor, b: Optional[torch.Tensor], t) -> torch.Tensor:
    """Displacement field d_t(p) = x_t(p) - p = (2t-1) v + 4t(1-t) b, with
    the coefficients rounded to float32 step by step as the reference's
    float32 ``t`` rounds them."""
    cv, cb, _, _ = time_values(t)
    return _displacement(v, b, cv, cb)


def _coarse_fixed_point(disp_c: torch.Tensor, qc: torch.Tensor, n: int, p0=None) -> torch.Tensor:
    """``n`` fixed-point iterations ``p <- q - disp(p)`` at coarse resolution."""
    p = qc if p0 is None else p0
    for _ in range(n):
        p = qc - bilinear_sample(disp_c, p)
    return p


def _multiscale_start(disp: torch.Tensor, h: int, w: int, n_iters: int) -> torch.Tensor:
    """Coarse-to-fine fixed-point start: the full-resolution estimate of p.

    Quarter resolution runs all but two of the iterations when the frame
    is at least 256 px on its short side, half resolution polishes once;
    otherwise half resolution runs all but one.
    """
    dtype, dev = disp.dtype, disp.device
    hh, ww = -(-h // 2), -(-w // 2)
    disp_h = downsample_2x(disp) * 0.5
    qh = grid_coords(hh, ww, dtype=dtype, device=dev)
    if min(h, w) >= 256 and n_iters > 2:
        hq, wq = -(-hh // 2), -(-ww // 2)
        disp_q = downsample_2x(disp_h) * 0.5
        qq = grid_coords(hq, wq, dtype=dtype, device=dev)
        pq = _coarse_fixed_point(disp_q, qq, n_iters - 2)
        corr_q = resize_bilinear(pq - qq, (hh, ww))
        ph = _coarse_fixed_point(disp_h, qh, 1, p0=qh + corr_q * 2.0)
    else:
        ph = _coarse_fixed_point(disp_h, qh, n_iters - 1)
    q = grid_coords(h, w, dtype=dtype, device=dev)
    corr = resize_bilinear(ph - qh, (h, w))
    return q + corr * 2.0


def invert_path(
    v: torch.Tensor,
    b: Optional[torch.Tensor],
    t,
    n_iters: int = 6,
    multiscale: bool = True,
    use_fused: Optional[bool] = None,
) -> torch.Tensor:
    """Halfway coordinates p(q) (H, W, 2) with x_t(p) = q for every output q.

    ``use_fused`` is the reference's TPU dispatch knob, accepted and
    ignored (as ``SynthParams.fused_sampling``): the samples run kernel 4
    whenever the field lies on the card, and the result does not depend on
    it."""
    h, w = v.shape[0], v.shape[1]
    q = grid_coords(h, w, dtype=v.dtype, device=v.device)
    disp = path_displacement(v, b, t)
    if multiscale and min(h, w) >= 128 and n_iters > 1:
        p = _multiscale_start(disp, h, w, n_iters)
        return q - bilinear_sample(disp, p)
    return _coarse_fixed_point(disp, q, n_iters)


def invert_path_with_field(
    v: torch.Tensor,
    b: Optional[torch.Tensor],
    t,
    n_iters: int = 6,
    multiscale: bool = True,
    use_fused: Optional[bool] = None,
):
    """:func:`invert_path` that also returns ``v(p)``: the last sample reads
    the stacked planes ``[d_t, v]`` in one 4-channel gather, with ``v`` at
    the penultimate iterate. Returns ``(p, v_at_p)``. ``use_fused`` is
    accepted and ignored, as in :func:`invert_path`."""
    return _invert_with_field(v, path_displacement(v, b, t), n_iters, multiscale)


def _invert_with_field(v: torch.Tensor, disp: torch.Tensor, n_iters: int, multiscale: bool):
    h, w = v.shape[0], v.shape[1]
    q = grid_coords(h, w, dtype=v.dtype, device=v.device)
    stacked = torch.cat([disp, v], dim=-1)
    if multiscale and min(h, w) >= 128 and n_iters > 1:
        p = _multiscale_start(disp, h, w, n_iters)
    else:
        p = _coarse_fixed_point(disp, q, max(n_iters - 1, 0))
    s = bilinear_sample(stacked, p)
    return q - s[..., :2], s[..., 2:].contiguous()


class FrameAux(NamedTuple):
    mask0: torch.Tensor         # (H, W) validity of the I0 sample
    mask1: torch.Tensor         # (H, W) validity of the I1 sample
    inv_residual: torch.Tensor  # (H, W) |x_t(p(q)) - q|, the path inversion's error


def render_frame(
    i0: torch.Tensor,
    i1: torch.Tensor,
    v: torch.Tensor,
    b: Optional[torch.Tensor],
    t,
    sp: SynthParams = SynthParams(),
    conf0: Optional[torch.Tensor] = None,
    conf1: Optional[torch.Tensor] = None,
    with_aux: bool = False,
    srcs0=None,
    srcs1=None,
):
    """Synthesize the morph frame at time ``t`` in [0, 1]:
    c_t(q) = (1-t) I0(phi0(p(q))) + t I1(phi1(p(q))), Poisson-extended and,
    with the per-source visibility maps ``conf0``/``conf1`` (H, W) of the
    video pipeline, occlusion-aware.

    Each confidence rides along as a 4th image channel through the colour
    samples and is clipped to [0, 1] after sampling (the bicubic
    interpolant can overshoot). The two bilinear colour samples are one
    launch of the batched sampler. ``with_aux`` also returns a
    :class:`FrameAux`: ``(frame, aux)``.

    When every tensor lies on one card and ``with_aux`` is false (and no
    capture is open and no gradient is wanted), the frame is a replay of a
    CUDA graph of this body, captured at the first call of each signature
    (:func:`frame_graph_key`); it gives the same bits as the eager body,
    which runs every other call.

    ``srcs0``/``srcs1`` are the reference's prebuilt TPU sampler sources
    (copies of ``i0``/``i1`` laid out for its Pallas gather); they are
    accepted and ignored: the port samples ``i0``/``i1`` themselves, and the
    frame does not depend on them.
    """
    if conf0 is None or conf1 is None:
        conf0 = conf1 = None
    inputs = (i0, i1, v, b, conf0, conf1)
    if not with_aux and _replayable(inputs):
        return _replay(inputs, t, sp)
    return _render_frame_eager(i0, i1, v, b, _time_vector(t, v), sp, conf0, conf1, with_aux)


def _render_frame_eager(i0, i1, v, b, tv, sp: SynthParams, conf0, conf1, with_aux: bool):
    """The frame of :func:`render_frame` at the time whose
    :func:`time_values` the vector ``tv`` holds (``v``'s dtype and device).
    A product with such an entry gives the bits of the product with the
    Python number, which the tensor's dtype would have rounded alike."""
    h, w = i0.shape[0], i0.shape[1]
    cv, cb, f0, f1 = tv.unbind()
    disp = _displacement(v, b, cv, cb)
    p, v_at_p = _invert_with_field(v, disp, sp.invert_iters, sp.invert_multiscale)
    phi0 = p - v_at_p
    phi1 = p + v_at_p
    with_conf = conf0 is not None and conf1 is not None
    if with_conf:
        i0 = torch.cat([i0, conf0[..., None]], -1)
        i1 = torch.cat([i1, conf1[..., None]], -1)
    if sp.sampling == "bicubic":
        s0, s1 = bicubic_sample(i0, phi0), bicubic_sample(i1, phi1)
    else:
        s0, s1 = bilinear_sample_batched(torch.stack([i0, i1]), torch.stack([phi0, phi1]))
    c0 = c1 = None
    if with_conf:
        s0, c0 = s0[..., :-1], torch.clamp(s0[..., -1], 0.0, 1.0)
        s1, c1 = s1[..., :-1], torch.clamp(s1[..., -1], 0.0, 1.0)
    m0 = inside_mask(phi0, h, w)
    m1 = inside_mask(phi1, h, w)
    out = blend_with_weights(s0, s1, m0, m1, blend_weights_of(f0, f1, m0, m1, c0, c1), sp)
    if not with_aux:
        return out
    q = grid_coords(h, w, dtype=v.dtype, device=v.device)
    res = torch.linalg.norm(p + bilinear_sample(disp, p) - q, dim=-1)
    return out, FrameAux(mask0=m0, mask1=m1, inv_residual=res)


def frame_graph_key(device, stream, specs, sp: SynthParams, allow_tf32: bool, matmul_precision: str) -> tuple:
    """The cache key of a frame's CUDA graph: everything the captured
    launches depend on but the inputs' values and the time. ``specs``:
    ``(shape, dtype)`` of ``(i0, i1, v, b, conf0, conf1)``, None for one not
    given (H, W, C, the dtypes, whether ``b`` and the confidences are
    given); ``stream``: the stream the replays run on, which orders them
    against the copies into the graph's buffers; the matmul precision
    state, which the captured DCT products keep."""
    return (device, stream, specs, sp, allow_tf32, matmul_precision)


class _FrameGraph(NamedTuple):
    graph: Captured     # the frame's graph, as step "frame"
    inputs: tuple       # the buffers the graph reads, one per given input (None where not given)
    times: tuple        # 0-d views of the time vector the graph reads


_graphs = LRU(GRAPHS_KEPT)


def _replayable(inputs) -> bool:
    """Whether a frame of these inputs can be a graph replay
    (:func:`~videomorphing_tpu_torch.graphs.replayable` of the given ones)."""
    return replayable([x for x in inputs if x is not None])


def _capture(inputs, t, sp: SynthParams) -> _FrameGraph:
    """The body captured (:func:`~videomorphing_tpu_torch.graphs.capture`)
    on buffers of its own, into a memory pool of its own."""
    bufs = tuple(None if x is None else x.clone(memory_format=torch.contiguous_format) for x in inputs)
    i0, i1, v, b, conf0, conf1 = bufs
    tv = _time_vector(t, v)
    graph = capture({"frame": lambda: _render_frame_eager(i0, i1, v, b, tv, sp, conf0, conf1, False)},
                    inputs[0].device, COUNTED)
    profiling.count("graph_captures")
    return _FrameGraph(graph, bufs, tv.unbind())


def _replay(inputs, t, sp: SynthParams) -> torch.Tensor:
    """The frame as a replay of the graph of its signature (captured on a
    miss): the inputs copied into the graph's buffers, the time written,
    the graph replayed, a copy of its output returned."""
    dev = inputs[0].device
    with torch.cuda.device(dev):
        specs = tuple(None if x is None else (tuple(x.shape), x.dtype) for x in inputs)
        key = frame_graph_key(dev, torch.cuda.current_stream(dev).cuda_stream, specs, sp,
                              torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
        entry = _graphs.get(key, lambda: _capture(inputs, t, sp))
        for buf, x in zip(entry.inputs, inputs):
            if buf is not None:
                buf.copy_(x)
        _write_times(entry.times, t)
        entry.graph.replay("frame")
        profiling.count("graph_replays")
        return entry.graph.outputs["frame"].clone()


def render_clip(
    i0: torch.Tensor,
    i1: torch.Tensor,
    v: torch.Tensor,
    b: Optional[torch.Tensor],
    ts: Sequence[float],
    sp: SynthParams = SynthParams(),
) -> torch.Tensor:
    """One frame per time in ``ts`` (K,) -> (K, H, W, C), each written into
    one output as it is made; traced, each frame is a ``render.frame``
    span."""
    ts = np.asarray(ts.detach().cpu() if isinstance(ts, torch.Tensor) else ts, np.float32).reshape(-1)
    frames = None
    for k, t in enumerate(ts):
        with profiling.span("render.frame"):
            frame = render_frame(i0, i1, v, b, t, sp)
            if frames is None:
                frames = frame.new_empty((len(ts),) + tuple(frame.shape))
            frames[k] = frame
    if frames is None:
        raise ValueError("render_clip needs at least one time")
    return frames


@functools.lru_cache(maxsize=None)
def jitted_render_clip(sp: SynthParams):
    """:func:`render_clip` bound to ``sp``, cached per ``SynthParams``: the
    reference's jitted callable, here the plain function (PyTorch runs
    eagerly)."""
    return lambda i0, i1, v, b, ts: render_clip(i0, i1, v, b, ts, sp)
