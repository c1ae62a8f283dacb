"""Config-5 batch pipeline: streaming decode -> pair solves -> render,
pairs split over a mesh (port of ``videomorphing_tpu/parallel/batch.py``).

- :func:`make_batch_step`: the per-block function. The block's pairs
  spread over the mesh's devices as ``parallel.frames.optimize_pairs_batched``
  spreads them (each pair a coarse-to-fine solve, ``solver.ctf.optimize_pair``);
  then each pair's bulge (``synth.paths.bulge_field``; none when
  ``quadratic_paths`` is off, as ``models.image_morph`` has it) and one
  ``render_frame`` per output time, in turn, so the peak holds one frame.
  Traced (``utils.profiling``), a step is a ``batch.step`` span around the
  phases ``cold_solve``, ``bulges`` and ``render``, each frame a
  ``render.frame`` span.
- :class:`StreamingBatchRunner`: the host pipeline of a streamed clip pair.
- :func:`run_manifest`: many independent image-pair jobs in mesh-sized
  blocks.

The reference pads a short block to the mesh size, because its jitted
step has a fixed shape; the port's step takes any number of pairs
(``parallel.frames.shares`` spreads them), so it pads nothing.

Overlap. On a card, blocks go up through page-locked staging copies with
``non_blocking`` copies on a side stream, which the compute stream waits
for by event; each block's frames come down into a page-locked buffer on
the side stream, and the host waits for them only when it hands the block
on, after it has run the next block. What it hands on is a copy in pageable
memory, so the staging buffers go back to PyTorch's page-locked cache (and
are reused) as soon as a block is handed on. The level solver reads a few scalars back
every iteration and Armijo trial (``solver/descent.py``), so unlike the
reference's jitted step the host is not free while a block solves: what
overlaps is decode (the native reader's producer threads), the copies and
the renders queued at the end of a block. ``run_clip_pair``'s ``stats``
say where the host waited.

Not ported: ``MONOLITHIC_MAX_PIXELS`` and the staged step, which split the
reference's one-jit program because a 4K program overflowed its remote
compiler (the port has one code path for every size), and
``_hoisted_warp_sources``, the TPU sampler's source copies.
"""

from __future__ import annotations

import json
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from videomorphing_tpu_torch.config import MorphParams, SynthParams
from videomorphing_tpu_torch.parallel.frames import optimize_pairs_batched, shares
from videomorphing_tpu_torch.parallel.mesh import as_mesh
from videomorphing_tpu_torch.synth.paths import bulge_field
from videomorphing_tpu_torch.synth.render import render_frame
from videomorphing_tpu_torch.utils.profiling import count, phase_scope, span


def make_batch_step(
    mp: MorphParams,
    sp: SynthParams,
    mesh,
    hw: Tuple[int, int],
    n_out: int = 1,
    axis: str = "batch",
):
    """The batch step: (B pairs) -> (B, n_out frames).

    Signature of the returned function::

        step(i0s, i1s, points, ts, results=None) -> frames
        i0s, i1s : (B, H, W, C) tensors; B at most the mesh's ``axis`` size
                   in the runners, any B >= 1 here
        points   : (B, N, 2, 2) per-pair correspondences (N may be 0)
        ts       : (B, n_out) per-pair morph times (host array)
        results  : optional list; each pair's ``solver.ctf.OptimizeResult``
                   (its field, ``level_stats`` and ``n_levels``) is appended
                   in the block's order, as ``optimize_pairs_batched`` hands
                   them back: the solves the frames were rendered from
        frames   : (B, n_out, H, W, C) on ``i0s``' device

    ``n_out=1`` is the clip-batch mode (each pair gives one frame at its
    time); manifest jobs use ``n_out=n_frames``. Each pair solves and
    renders on its device of the mesh.

    Traced (``utils.profiling``), a step is one ``batch.step`` span
    (attributes ``pairs``, ``n_out``, ``h``, ``w``; counter ``frames``)
    around the phases ``cold_solve`` (the block's solves, with their
    ``solve.level`` spans), ``bulges`` and ``render`` (each pair's, summed
    over the block), and each frame is a ``render.frame`` span. Off, each
    costs one check.
    """
    devs = as_mesh(mesh).axis_devices(axis)
    h, w = hw

    def step(i0s, i1s, points, ts, results: Optional[list] = None) -> torch.Tensor:
        bsz = i0s.shape[0]
        ts = np.asarray(ts.detach().cpu() if isinstance(ts, torch.Tensor) else ts, np.float32)
        if tuple(i0s.shape[1:3]) != (h, w) or i1s.shape != i0s.shape:
            raise ValueError(f"pairs of {tuple(i0s.shape)} / {tuple(i1s.shape)} for a step of {hw}")
        if ts.shape != (bsz, n_out) or bsz < 1:
            raise ValueError(f"times {ts.shape} for a block of {bsz} x {n_out}")
        with span("batch.step", pairs=bsz, n_out=n_out, h=h, w=w):
            count("frames", bsz * n_out)
            with phase_scope("cold_solve"):
                vs = optimize_pairs_batched(i0s, i1s, mesh, mp, points, axis, results)
            frames = torch.empty((bsz, n_out) + tuple(i0s.shape[1:]), dtype=i0s.dtype, device=i0s.device)
            for dev, sl in zip(devs, shares(bsz, len(devs))):
                for j in range(sl.start, sl.stop):
                    i0, i1, v = (x.to(dev) for x in (i0s[j], i1s[j], vs[j]))
                    with phase_scope("bulges"):
                        b = bulge_field(v, sp) if sp.quadratic_paths else None
                    with phase_scope("render"):
                        for k in range(n_out):
                            with span("render.frame"):
                                frames[j, k] = render_frame(i0, i1, v, b, ts[j, k], sp)
        return frames

    return step


def _pad_block(arr: np.ndarray, bsz: int) -> np.ndarray:
    """Pad the leading axis up to ``bsz`` by repeating the last element
    (the reference's fixed-shape block; the port's runners do not pad)."""
    n = arr.shape[0]
    if n > bsz:
        raise ValueError(f"block of {n} items exceeds the mesh block size {bsz}")
    if n == bsz:
        return arr
    reps = np.repeat(arr[-1:], bsz - n, axis=0)
    return np.concatenate([arr, reps], axis=0)


class _Transfers:
    """Host <-> device copies for one device. On a card: page-locked
    staging buffers and ``non_blocking`` copies on a side stream, ordered
    against the compute stream by events. On the CPU: plain tensors."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(self, *arrs: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """Host arrays to the device; the compute stream waits for them."""
        if self.stream is None:
            return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrs)
        main = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            out = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(self.device, non_blocking=True)
                for a in arrs
            )
            ready = torch.cuda.Event()
            ready.record(self.stream)
        main.wait_event(ready)
        for t in out:
            t.record_stream(main)
        return out

    def fetch(self, frames: torch.Tensor):
        """Start the copy of ``frames`` to the host after the work queued
        so far; :meth:`wait` returns them as a numpy array, which may share
        memory with the staging buffer or the device tensor (the CPU's)."""
        if self.stream is None:
            return frames.to("cpu")
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        host = torch.empty(frames.shape, dtype=frames.dtype, pin_memory=True)
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(done)
            host.copy_(frames, non_blocking=True)
            frames.record_stream(self.stream)
            copied = torch.cuda.Event()
            copied.record(self.stream)
        return host, copied

    @staticmethod
    def wait(handle) -> np.ndarray:
        if isinstance(handle, torch.Tensor):
            return handle.numpy()
        host, copied = handle
        copied.synchronize()
        return host.numpy()


class StreamingBatchRunner:
    """Host-side pipeline for config 5: decode / H2D / compute / D2H.

    Per mesh block: take the next stream blocks (the native reader decodes
    ahead in its own threads), copy them up, run the step, start the copy
    of its frames down, then hand on the PREVIOUS block's frames, which
    came down while this one ran. The mesh's first device along ``axis``
    holds the inputs and outputs.
    """

    def __init__(
        self,
        mesh,
        mp: MorphParams = MorphParams(),
        sp: SynthParams = SynthParams(),
        axis: str = "batch",
    ):
        self.mesh = as_mesh(mesh)
        self.mp = mp
        self.sp = sp
        self.axis = axis
        self.block = int(self.mesh.shape[axis])
        self._xfer = _Transfers(self.mesh.axis_devices(axis)[0])

    def run_clip_pair(
        self,
        blocks_a: Iterator[Tuple[int, np.ndarray]],
        blocks_b: Iterator[Tuple[int, np.ndarray]],
        t_len: int,
        hw: Tuple[int, int],
        points: Optional[np.ndarray] = None,
        times: Optional[np.ndarray] = None,
        on_block=None,
        stats: Optional[list] = None,
    ) -> Iterator[Tuple[int, np.ndarray]]:
        """Morph two streamed clips pair by pair (no temporal carry).

        The data-parallel alternative to ``video.pipeline``'s warm scan:
        every frame pair solves alone, so the pairs spread over the mesh.
        Frame k renders at ``times[k]`` (default ``linspace(0, 1, t_len)``);
        ``points`` (N, 2, 2) apply to every pair. Yields ``(start_index,
        frames (K, H, W, C))`` blocks in order; stream blocks larger than
        the mesh block are re-chunked.

        ``stats``: optional list; one dict per mesh block with the host's
        time in each phase: ``decode_s`` (waiting on the clip iterators:
        whether decode keeps ahead), ``h2d_s`` (staging and issuing the
        copies up), ``dispatch_s`` (the step: the solves, whose scalar
        reads wait on the device, and the queued renders, plus issuing the
        copy down), ``fetch_s`` (waiting for the PREVIOUS block's frames
        and handing them on; the caller's time with them, such as an
        encode, counts here, as the yield is inside the timed span).
        """
        bsz = self.block
        step = make_batch_step(self.mp, self.sp, self.mesh, hw, 1, self.axis)
        if times is None:
            times = np.linspace(0.0, 1.0, t_len, dtype=np.float32)
        times = np.asarray(times, np.float32)
        pts_one = np.zeros((0, 2, 2), np.float32) if points is None else np.asarray(points, np.float32)
        xfer = self._xfer

        pending: List[Tuple[int, object]] = []  # (start, frames on their way down)

        def drain():
            s0, handle = pending.pop(0)
            host = np.array(xfer.wait(handle)[:, 0])  # pageable; frees the staging buffer
            if on_block is not None:
                on_block(s0, host)
            return s0, host

        paired = zip(blocks_a, blocks_b)
        while True:
            t_dec = time.perf_counter()
            try:
                (sa, blk_a), (sb, blk_b) = next(paired)
            except StopIteration:
                break
            decode_s = time.perf_counter() - t_dec
            if sa != sb:
                raise ValueError(f"clip streams out of sync: {sa} != {sb}")
            n_all = min(blk_a.shape[0], blk_b.shape[0])
            for off in range(0, n_all, bsz):
                s = sa + off
                n = min(bsz, n_all - off)
                i0s = np.ascontiguousarray(blk_a[off : off + n], np.float32)
                i1s = np.ascontiguousarray(blk_b[off : off + n], np.float32)
                pts = np.repeat(pts_one[None], n, axis=0)

                t_put = time.perf_counter()
                dev = xfer.put(i0s, i1s, pts)
                t_disp = time.perf_counter()
                out = xfer.fetch(step(*dev, times[s : s + n, None]))
                t_fetch = time.perf_counter()
                while pending:
                    yield drain()
                pending.append((s, out))
                if stats is not None:
                    stats.append({
                        "start": s, "n": n,
                        "decode_s": decode_s,
                        "h2d_s": t_disp - t_put,
                        "dispatch_s": t_fetch - t_disp,
                        "fetch_s": time.perf_counter() - t_fetch,
                    })
                decode_s = 0.0  # only the first chunk of a stream block waits

        while pending:
            t_fetch = time.perf_counter()
            item = drain()
            if stats:
                stats[-1]["fetch_s"] += time.perf_counter() - t_fetch
            yield item


def run_manifest(
    jobs: Sequence[dict],
    mesh,
    mp: MorphParams = MorphParams(),
    sp: SynthParams = SynthParams(),
    axis: str = "batch",
    verbose: bool = False,
) -> List[np.ndarray]:
    """Run many independent image-pair morph jobs, mesh-sized blocks at a time.

    Each job dict: ``{"i0": (H,W,C) array, "i1": array, "points": (N,2,2)
    array or None, "n_frames": int}``. All jobs in one call share the image
    resolution; ``n_frames`` may vary: every job renders at the largest
    count (its times ``linspace(0, 1, n_frames)``, then 1.0) and is trimmed.
    Point lists pad to the longest with far-off-domain pairs, whose weight
    is exactly 0 on the grid, so a padded job solves as unpadded. The
    previous block's frames come down while the next block runs. With
    ``verbose`` each block prints a ``batch_block`` JSON line.

    Returns one ``(n_frames, H, W, C)`` array per job, in order.
    """
    if not jobs:
        return []
    mesh = as_mesh(mesh)
    h, w = np.asarray(jobs[0]["i0"]).shape[:2]
    n_out = max(int(j.get("n_frames", 16)) for j in jobs)
    max_pts = max((np.asarray(j["points"]).shape[0] if j.get("points") is not None else 0) for j in jobs)
    bsz = int(mesh.shape[axis])
    step = make_batch_step(mp, sp, mesh, (h, w), n_out, axis)
    xfer = _Transfers(mesh.axis_devices(axis)[0])

    results: List[np.ndarray] = []
    pending: List[Tuple[list, float, object]] = []  # (jobs, t_dispatch, frames on their way down)

    def drain():
        blk_, t0_, handle = pending.pop(0)
        host = xfer.wait(handle)
        if verbose:
            dt = time.perf_counter() - t0_
            print(json.dumps({
                "event": "batch_block",
                "jobs": len(blk_),
                "frames": int(len(blk_) * n_out),
                "wall_s": round(dt, 3),
                "frames_per_sec": round(len(blk_) * n_out / dt, 3),
            }))
        for bi, j in enumerate(blk_):  # pageable copies free the staging buffer
            results.append(np.array(host[bi, : int(j.get("n_frames", n_out))]))

    for blk_start in range(0, len(jobs), bsz):
        blk = list(jobs[blk_start : blk_start + bsz])
        i0s = np.stack([np.asarray(j["i0"], np.float32) for j in blk])
        i1s = np.stack([np.asarray(j["i1"], np.float32) for j in blk])
        pts = np.full((len(blk), max_pts, 2, 2), -1e6, np.float32)
        for bi, j in enumerate(blk):
            p = j.get("points")
            if p is not None and len(p):
                p = np.asarray(p, np.float32)
                pts[bi, : p.shape[0]] = p
        ts = np.zeros((len(blk), n_out), np.float32)
        for bi, j in enumerate(blk):
            nf = int(j.get("n_frames", n_out))
            ts[bi, :nf] = np.linspace(0.0, 1.0, nf, dtype=np.float32)
            ts[bi, nf:] = 1.0

        t0 = time.perf_counter()
        out = xfer.fetch(step(*xfer.put(i0s, i1s, pts), ts))
        while pending:
            drain()
        pending.append((blk, t0, out))
    while pending:
        drain()
    return results
