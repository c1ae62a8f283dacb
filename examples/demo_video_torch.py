"""End-to-end VIDEO morphing demo of the PyTorch port — the [EGSR14]
workflow in one file, the twin of ``demo_video.py`` on
``videomorphing_tpu_torch``, on the card by default.

Synthesizes a clip pair (a textured disk crossing a drifting background,
with different paths and lighting in the two takes), authors a keyframe
correspondence, adds a LAYER for the disk, morphs the clips through the
temporal-coherence pipeline, and writes every artifact:

  - ``morph.y4m``        playable A->B transition (mpv/VLC)
  - ``layered.y4m``      the same transition with the disk as its own layer
  - ``frames/``          PNG frames
  - ``strip.png``        filmstrip of the transition
  - ``fields.png``       direction-coded halfway fields over time

Run from the repo root (no input data needed):

    python examples/demo_video_torch.py [outdir]               # on the card
    python examples/demo_video_torch.py [outdir] --device cpu  # on the CPU
    VMORPH_DEMO_SHAPE=4x72x104 python examples/demo_video_torch.py  # tiny

The takes come from ``utils.stressor.make_stressor(seed=5, drift=0.08)``,
whose textures the port draws with numpy (the JAX package's with
``jax.random``), so by default its takes are not pixel for pixel the
reference demo's; ``compute(params=...)`` takes the reference's draws,
and then they are. ``compute`` makes the arrays and runs the demo's
check; ``main`` writes the files (the PNGs need PIL).
"""

import os
import sys

import numpy as np

# runnable without installing: the repo root is the package root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def demo_shape():
    """(T, H, W) from ``VMORPH_DEMO_SHAPE`` (default 8x120x168)."""
    return tuple(int(x) for x in os.environ.get("VMORPH_DEMO_SHAPE", "8x120x168").split("x"))


def _disk_masks(tracked: np.ndarray, side: int, h: int, w: int, r: float) -> np.ndarray:
    """(T, H, W) discs of radius ``r`` around the tracked disk centre in
    clip A (``side`` 0) or B (1)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([
        ((yy - tracked[t, 0, side, 0]) ** 2 + (xx - tracked[t, 0, side, 1]) ** 2 < r**2).astype(np.float32)
        for t in range(tracked.shape[0])
    ])


def compute(shape=None, device="cuda", params=None) -> dict:
    """The morph and its layered variant as numpy arrays. ``ok``: the
    mid frame's disk centroid lands within 6 px of the midpoint of the two
    takes' centroids at that frame. ``params``: the takes' texture draws,
    passed on to ``make_stressor`` (default: its numpy draws of seed 5;
    given the JAX package's draws, the takes are the reference demo's)."""
    import torch

    from videomorphing_tpu_torch.utils.stressor import make_stressor
    from videomorphing_tpu_torch.video.layered import VideoLayer, morph_clips_layered
    from videomorphing_tpu_torch.video.pipeline import morph_video
    from videomorphing_tpu_torch.viewer import field_color

    t_len, h, w = demo_shape() if shape is None else shape
    # two synthetic "takes": the same scene, different disk path and lighting
    case = make_stressor(t_len, h, w, seed=5, drift=0.08, params=params, device=device)
    clip_a, clip_b = case.clip_a, case.clip_b
    # keyframe correspondence: the disk centre on frame 0, tracked to every
    # other frame by the per-clip optical flows ([EGSR14 s3])
    keyframe_points = {0: torch.from_numpy(case.points).to(clip_a.device)}

    # flows -> cold solve -> warm temporal scan -> quadratic paths ->
    # occlusion-aware Poisson blend
    res = morph_video(clip_a, clip_b, points=keyframe_points, render=True)
    frames = res.frames.cpu().numpy()
    fields = res.fields.cpu().numpy()

    # the layered variant: the disk as its own morph layer, its masks
    # following the tracked disk centre in each take
    tracked = res.tracked_points.cpu().numpy()  # (T, N, 2, 2)
    r = 0.16 * min(h, w) + 4.0
    masks = [torch.from_numpy(_disk_masks(tracked, side, h, w, r)).to(clip_a.device) for side in (0, 1)]
    layer = VideoLayer(mask0=masks[0], mask1=masks[1], points=keyframe_points)
    layered = morph_clips_layered(clip_a, clip_b, [layer], points=keyframe_points).frames.cpu().numpy()

    # the demo doubles as a correctness check: the disk centroid in the
    # morph must sweep between its take-A and take-B trajectories
    xx = np.mgrid[0:h, 0:w][1].astype(np.float32)

    def centroid_x(f):
        lum = f.mean(-1)
        m = np.maximum(lum - np.median(lum), 0)
        return float((xx * m).sum() / m.sum())

    mid = t_len // 2
    takes = (clip_a[mid].cpu().numpy(), clip_b[mid].cpu().numpy())
    mid_err = abs(centroid_x(frames[mid]) - 0.5 * (centroid_x(takes[0]) + centroid_x(takes[1])))
    return dict(
        clip_a=clip_a.cpu().numpy(), clip_b=clip_b.cpu().numpy(), frames=frames, layered=layered,
        strip=np.concatenate(list(frames), axis=1),
        fields=np.concatenate([field_color(fields[t]) for t in range(t_len)], axis=1),
        points=case.points, mid_err=mid_err, ok=mid_err < 6.0,
    )


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i : i + 2]
    outdir = args[0] if args else "vmorph_video_demo"

    from videomorphing_tpu_torch.io.clips import save_clip
    from videomorphing_tpu_torch.io.images import save_image

    os.makedirs(f"{outdir}/frames", exist_ok=True)
    print(f"morphing on {device} ...")
    out = compute(device=device)
    frames = out["frames"]
    t_len = frames.shape[0]
    save_clip(f"{outdir}/take_a.y4m", out["clip_a"], fps=8)
    save_clip(f"{outdir}/take_b.y4m", out["clip_b"], fps=8)
    save_clip(f"{outdir}/morph.y4m", frames, fps=8)
    for t in range(t_len):
        save_image(f"{outdir}/frames/frame_{t:04d}.png", frames[t])
    # filmstrip + field-colour strip (hue = direction, saturation = |v|)
    save_image(f"{outdir}/strip.png", out["strip"])
    save_image(f"{outdir}/fields.png", out["fields"])
    save_clip(f"{outdir}/layered.y4m", out["layered"], fps=8)

    ca0, cb0 = out["points"][0, 0], out["points"][0, 1]
    print(f"done: {t_len} frames -> {outdir}/")
    print("  morph.y4m, layered.y4m, frames/, strip.png, fields.png")
    print(f"  mid-frame centroid vs takes' midpoint: {out['mid_err']:.1f} px off")
    print(f"  keyframe pair authored at A({ca0[0]:.0f},{ca0[1]:.0f}) / "
          f"B({cb0[0]:.0f},{cb0[1]:.0f}), tracked to all frames by flow")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
