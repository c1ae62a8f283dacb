"""The port's batch tier (``parallel.batch``) against the reference's and
against its own pair path, on the CPU.

- ``run_manifest`` and ``StreamingBatchRunner.run_clip_pair`` of both
  packages on the same jobs and clips: the reference on 2 of its 8 virtual
  CPU devices, the port on ``make_mesh(devices=["cpu"] * 2)``. Frames agree
  to a mean |d| < 5e-3 and a 99th percentile < 0.05: the bound the
  reference holds its own batch step to against its single-pair path
  (``tests/test_batch.py``), since the line search's accept/reject turns
  float32 noise into different steps (ROADMAP §3: float32 solves drift
  ~1e-3 px after 20 iterations);
- the port's batch runs its own pair path, so its frames equal
  ``api.morph_pair`` (manifest) and the per-pair solve and render (stream)
  bitwise, with quadratic paths and the Poisson blend; a job with fewer
  points than the longest pads with far-off pairs that change nothing;
- ``n_frames`` trims per job; stream blocks larger than the mesh block
  re-chunk, a short block runs unpadded, the ``stats`` dicts carry the
  reference's keys; the frames handed back own their memory (pageable
  copies, not views of a staging buffer); ``_pad_block`` raises on an
  oversize block and the runner on streams out of step;
- the step hands back its solves (``results``) without changing its
  frames, and those solves are ``solver.ctf.optimize_pair``'s; traced, it
  logs its phases, one ``batch.step`` span and a ``render.frame`` span a
  frame.
"""

import numpy as np
import pytest
import torch

from videomorphing_tpu.config import MorphParams as JaxMorphParams
from videomorphing_tpu.config import SynthParams as JaxSynthParams
from videomorphing_tpu.io.clips import open_clip_reader as jax_open_clip_reader
from videomorphing_tpu.parallel import batch as jbatch
from videomorphing_tpu.parallel.mesh import make_mesh as jax_make_mesh
from videomorphing_tpu_torch import api
from videomorphing_tpu_torch.bench import make_clips_device
from videomorphing_tpu_torch.config import MorphParams, SynthParams
from videomorphing_tpu_torch.io.clips import open_clip_reader, write_vmc
from videomorphing_tpu_torch.models.image_morph import ImageMorpher
from videomorphing_tpu_torch.parallel import batch as tbatch
from videomorphing_tpu_torch.parallel.mesh import make_mesh
from videomorphing_tpu_torch.solver.constraints import rasterize_point_constraints
from videomorphing_tpu_torch.solver.ctf import optimize_pair
from videomorphing_tpu_torch.synth.paths import bulge_field
from videomorphing_tpu_torch.synth.render import render_frame
from videomorphing_tpu_torch.utils import profiling

torch.set_num_threads(2)
H, W = 40, 48
FAST = dict(iters_coarse=12, n_levels=2)
LINEAR = dict(quadratic_paths=False, blend_mode="linear")


def _pair(rng, shift=2.0):
    """The reference test's pair: a smoothed texture with a blob moved by
    2 ``shift`` px between the images."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    tex = rng.random((H, W, 3), dtype=np.float32)
    for _ in range(2):
        tex = 0.25 * (np.roll(tex, 1, 0) + np.roll(tex, -1, 0) + np.roll(tex, 1, 1) + np.roll(tex, -1, 1))

    def img(cx):
        blob = np.exp(-0.5 * ((yy - H / 2) ** 2 + (xx - cx) ** 2) / (H * 0.15) ** 2)
        return np.clip(0.3 + 0.4 * tex + 0.5 * blob[..., None], 0, 1).astype(np.float32)

    return img(W / 2 - shift), img(W / 2 + shift)


def _jobs(seed=0):
    rng = np.random.default_rng(seed)
    pts = ([[[20.0, 22.0], [20.0, 26.0]]], None, [[[12.0, 20.0], [12.0, 23.0]], [[28.0, 24.0], [28.0, 27.0]]])
    jobs = []
    for k in range(3):
        i0, i1 = _pair(rng, shift=1.5 + k)
        p = None if pts[k] is None else np.asarray(pts[k], np.float32)
        jobs.append(dict(i0=i0, i1=i1, points=p, n_frames=3 + k))
    return jobs


def _close(ref, got, what):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert err.mean() < 5e-3 and np.quantile(err, 0.99) < 0.05, (
        f"{what}: mean {err.mean():.4g} p99 {np.quantile(err, 0.99):.4g}"
    )


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two 5-frame .vmc clips and their quantized contents."""
    d = tmp_path_factory.mktemp("batch_clips")
    rng = np.random.default_rng(1)
    pairs = [_pair(rng, shift=1 + 0.2 * k) for k in range(5)]
    pa, pb = str(d / "a.vmc"), str(d / "b.vmc")
    write_vmc(pa, np.stack([p[0] for p in pairs]))
    write_vmc(pb, np.stack([p[1] for p in pairs]))
    blocks = lambda path: np.concatenate([b for _, b in open_clip_reader(path, block=8)])
    return pa, pb, blocks(pa), blocks(pb)


def test_manifest_matches_reference():
    jobs = _jobs()
    ref = jbatch.run_manifest(jobs, jax_make_mesh((2,)), JaxMorphParams(**FAST), JaxSynthParams(**LINEAR))
    got = tbatch.run_manifest(jobs, make_mesh(devices=["cpu"] * 2), MorphParams(**FAST), SynthParams(**LINEAR))
    assert len(got) == len(ref) == 3
    for k, (r, g) in enumerate(zip(ref, got)):
        assert g.shape == (jobs[k]["n_frames"], H, W, 3)
        _close(r, g, f"job {k}")


def test_manifest_equals_morph_pair_bitwise(capsys):
    """Quadratic paths and the Poisson blend (the defaults); job 0's one
    point pads to job 2's two, job 1's none to two far-off pairs."""
    jobs = _jobs(seed=2)
    mp, sp = MorphParams(**FAST), SynthParams()
    got = tbatch.run_manifest(jobs, make_mesh(devices=["cpu"] * 2), mp, sp, verbose=True)
    for job, frames in zip(jobs, got):
        ref = api.morph_pair(job["i0"], job["i1"], job["points"], job["n_frames"], mp, sp, device="cpu")
        assert frames.shape == (job["n_frames"], H, W, 3)
        np.testing.assert_array_equal(frames, ref.numpy())
    lines = [l for l in capsys.readouterr().out.splitlines() if '"batch_block"' in l]
    assert len(lines) == 2 and '"jobs": 2' in lines[0] and '"jobs": 1' in lines[1]


def test_point_padding_is_inert():
    pad = torch.full((3, 2, 2), -1e6)
    real = torch.tensor([[[20.0, 22.0], [20.0, 26.0]]])
    w_pad, vt_pad = rasterize_point_constraints(pad, (H, W), 8.0)
    w0, vt0 = rasterize_point_constraints(torch.zeros((0, 2, 2)), (H, W), 8.0)
    assert torch.equal(w_pad, w0) and torch.equal(vt_pad, vt0)
    w_m, vt_m = rasterize_point_constraints(torch.cat([real, pad]), (H, W), 8.0)
    w_r, vt_r = rasterize_point_constraints(real, (H, W), 8.0)
    assert torch.equal(w_m, w_r) and torch.equal(vt_m, vt_r)


def test_stream_matches_reference(clips):
    pa, pb, _, _ = clips
    mp, sp = FAST, LINEAR
    runner = jbatch.StreamingBatchRunner(jax_make_mesh((2,)), JaxMorphParams(**mp), JaxSynthParams(**sp))
    ref = dict(runner.run_clip_pair(jax_open_clip_reader(pa, block=2), jax_open_clip_reader(pb, block=2),
                                    5, (H, W)))
    runner = tbatch.StreamingBatchRunner(make_mesh(devices=["cpu"] * 2), MorphParams(**mp), SynthParams(**sp))
    got = dict(runner.run_clip_pair(open_clip_reader(pa, block=2), open_clip_reader(pb, block=2), 5, (H, W)))
    assert sorted(got) == sorted(ref) == [0, 2, 4]
    _close(np.concatenate([ref[s] for s in (0, 2, 4)]), np.concatenate([got[s] for s in (0, 2, 4)]), "stream")


def test_stream_equals_per_pair_bitwise_and_rechunks(clips):
    """Reader blocks of 8 over a 2-device mesh: one stream block re-chunks
    into mesh blocks of 2, 2 and 1 (unpadded); each frame equals the pair's
    own solve rendered at its time."""
    pa, pb, clip_a, clip_b = clips
    mp, sp = MorphParams(**FAST), SynthParams()
    runner = tbatch.StreamingBatchRunner(make_mesh(devices=["cpu"] * 2), mp, sp)
    stats, seen = [], []
    out = list(runner.run_clip_pair(open_clip_reader(pa, block=8), open_clip_reader(pb, block=8), 5, (H, W),
                                    on_block=lambda s, f: seen.append((s, f.shape[0])), stats=stats))
    assert [(s, f.shape[0]) for s, f in out] == seen == [(0, 2), (2, 2), (4, 1)]
    assert [(st["start"], st["n"]) for st in stats] == [(0, 2), (2, 2), (4, 1)]
    for st in stats:
        assert set(st) == {"start", "n", "decode_s", "h2d_s", "dispatch_s", "fetch_s"}
        assert all(st[k] >= 0.0 for k in ("decode_s", "h2d_s", "dispatch_s", "fetch_s"))
    frames = np.concatenate([f for _, f in out])
    times = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    morpher = ImageMorpher(mp, sp, "cpu")
    for k in range(5):
        i0, i1 = torch.from_numpy(clip_a[k]), torch.from_numpy(clip_b[k])
        ref = morpher.render(i0, i1, morpher.solve(i0, i1), times[k : k + 1])[0]
        np.testing.assert_array_equal(frames[k], ref.numpy())


def test_step_runs_a_short_block_unpadded():
    """One pair on a 2-device mesh solves and renders alone, equal to the
    full block's first row; times of another shape raise."""
    rng = np.random.default_rng(3)
    i0, i1 = _pair(rng)
    step = tbatch.make_batch_step(MorphParams(**FAST), SynthParams(**LINEAR), make_mesh(devices=["cpu"] * 2),
                                  (H, W), n_out=2)
    i0s = torch.from_numpy(np.stack([i0, i1]))
    i1s = torch.from_numpy(np.stack([i1, i0]))
    pts = torch.zeros((2, 0, 2, 2))
    ts = np.asarray([[0.25, 0.75], [0.5, 1.0]], np.float32)
    full = step(i0s, i1s, pts, ts)
    part = step(i0s[:1], i1s[:1], pts[:1], ts[:1])
    assert tuple(full.shape) == (2, 2, H, W, 3) and tuple(part.shape) == (1, 2, H, W, 3)
    assert torch.equal(part[0], full[0])
    with pytest.raises(ValueError, match="times"):
        step(i0s[:1], i1s[:1], pts[:1], ts)


def test_returned_frames_own_their_memory(clips):
    """Each job's (trimmed) frames and each streamed block are arrays of
    their own: no view of the block's output or staging buffer, which
    would keep a whole block (page-locked on a card) alive."""
    pa, pb, _, _ = clips
    mp, sp = MorphParams(**FAST), SynthParams(**LINEAR)
    mesh = make_mesh(devices=["cpu"] * 2)
    outs = tbatch.run_manifest(_jobs()[:2], mesh, mp, sp)
    runner = tbatch.StreamingBatchRunner(mesh, mp, sp)
    outs += [f for _, f in runner.run_clip_pair(open_clip_reader(pa, block=2), open_clip_reader(pb, block=2),
                                                 5, (H, W))]
    assert [o.shape[0] for o in outs] == [3, 4, 2, 2, 1]
    for o in outs:
        assert o.flags.owndata and o.base is None and o.flags.c_contiguous
    assert not any(np.shares_memory(a, b) for k, a in enumerate(outs) for b in outs[k + 1 :])


def test_pad_block_and_stream_sync_raise():
    assert tbatch._pad_block(np.arange(3), 5).tolist() == [0, 1, 2, 2, 2]
    with pytest.raises(ValueError, match="exceeds the mesh block size"):
        tbatch._pad_block(np.zeros((5, 2)), 4)
    runner = tbatch.StreamingBatchRunner(make_mesh(devices=["cpu"] * 2), MorphParams(**FAST), SynthParams(**LINEAR))
    blk = np.zeros((1, H, W, 3), np.float32)
    with pytest.raises(ValueError, match="out of sync"):
        list(runner.run_clip_pair(iter([(0, blk)]), iter([(1, blk)]), 2, (H, W)))


# --- the step's solves and spans ----------------------------------------------

HW4 = (36, 44)
SEED4 = 2**31 + 4321


def _seeded_block(n=2):
    """``n`` of the bench's seeded pairs at 36 x 44, stacked."""
    pairs = [make_clips_device(1, *HW4, SEED4 + k, "cpu") for k in range(n)]
    return torch.cat([a for a, _ in pairs]), torch.cat([b for _, b in pairs])


def test_step_hands_back_its_solves_and_the_same_frames():
    """Frames with ``results`` equal those without, bit for bit; each
    result is ``optimize_pair``'s on its pair, and its field renders the
    step's frames."""
    i0s, i1s = _seeded_block()
    mp, sp = MorphParams(**FAST), SynthParams()
    step = tbatch.make_batch_step(mp, sp, make_mesh(devices=["cpu"] * 2), HW4, n_out=2)
    pts = torch.zeros((2, 0, 2, 2))
    ts = np.asarray([[0.25, 0.75], [0.5, 1.0]], np.float32)
    results = []
    frames = step(i0s, i1s, pts, ts, results=results)
    assert torch.equal(frames, step(i0s, i1s, pts, ts))
    assert len(results) == 2
    for j, res in enumerate(results):
        ref = optimize_pair(i0s[j], i1s[j], points=pts[j], params=mp)
        assert torch.equal(res.v, ref.v) and res.n_levels == ref.n_levels == 2
        assert len(res.level_stats) == len(ref.level_stats)
        for got, want in zip(res.level_stats, ref.level_stats):
            assert (got.e0, got.e_final, got.iters, got.step) == (want.e0, want.e_final, want.iters, want.step)
            assert torch.equal(got.energy_history, want.energy_history)
        b = bulge_field(res.v, sp)
        for k in range(2):
            assert torch.equal(frames[j, k], render_frame(i0s[j], i1s[j], res.v, b, ts[j, k], sp))


def test_step_logs_its_phases_and_spans():
    i0s, i1s = _seeded_block()
    step = tbatch.make_batch_step(MorphParams(**FAST), SynthParams(), make_mesh(devices=["cpu"]), HW4, n_out=1)
    profiling.clear()
    try:
        with profiling.record_phases() as rec:
            step(i0s, i1s, torch.zeros((2, 0, 2, 2)), np.full((2, 1), 0.5, np.float32))
        log = profiling.spans()
    finally:
        profiling.clear()
    assert {"cold_solve", "bulges", "render"} <= set(rec) and all(rec[k] >= 0.0 for k in ("cold_solve", "render"))
    steps = [s for s in log if s.name == "batch.step"]
    assert len(steps) == 1
    top = steps[0]
    assert top.parent is None and top.counts == {"frames": 2}
    assert top.attrs == {"pairs": 2, "n_out": 1, "h": HW4[0], "w": HW4[1]}
    byid = {s.id: s for s in log}
    frames = [s for s in log if s.name == "render.frame"]
    assert len(frames) == 2 and all(byid[s.parent].name == "render" for s in frames)
    levels = [s for s in log if s.name == "solve.level"]
    assert len(levels) == 4 and all(byid[s.parent].name == "cold_solve" for s in levels)
    assert all(s.trace == top.id and top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
               for s in log if s is not top)

