"""GUI-free interactive correspondence editing: ``vmorph-torch edit``.

Port of ``videomorphing_tpu/edit.py``: a terminal command loop over an
ANSI halfway-domain preview. Each edit re-solves WARM from the current
field through :class:`videomorphing_tpu_torch.api.Session` (the solve
starts at the middle pyramid level) and re-renders the halfway view, where
correspondence errors show as ghosting. The session runs on ``device``
(default the card); the preview, the cursor view and the render copy their
image down once per command.

Scriptable by design: commands come from any iterable of lines (tests feed
a list; the CLI feeds stdin or ``--script``).

Commands:
    add Y0 X0 Y1 X1      add a pair (point in A, point in B)
    move I Y0 X0 Y1 X1   replace pair I
    del I                remove pair I
    list                 print pairs
    solve                (re-)solve warm from the current field + preview
    preview [T]          render the morph frame at time T (default 0.5)
    cursor               arrow-key point picking on a tty (see below)
    save [PATH]          write the points JSON (default --out)
    render PATH [N]      write N in-between frames (default 16)
    help / quit

Cursor mode (``cursor`` on a tty): arrows move the crosshair 1 px;
``W``/``A``/``S``/``D`` (capital S — lowercase ``s`` solves) move 10 px;
``space``/``enter`` places the point — first in image A, then in image B,
completing a pair — ``u`` undoes a pending A point, ``s`` warm re-solves
and shows the halfway view, ``q`` leaves cursor mode. The key decoder and
the event loop are pure (tests drive them with byte strings / event lists,
no tty required).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
from typing import Iterable, List, Optional

import numpy as np
import torch

from videomorphing_tpu_torch.config import MorphParams, SynthParams


def ansi_image(img: np.ndarray, max_cols: int = 0, stream=None) -> str:
    """Render an (H, W, C) [0,1] image as truecolor half-block ANSI text.

    Each character cell shows two vertical pixels (upper-half block with
    fg = top pixel, bg = bottom pixel). Returns the string; pure function
    so tests can assert on it without a terminal.
    """
    img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    h, w = img.shape[:2]
    if max_cols <= 0:
        max_cols = shutil.get_terminal_size((100, 40)).columns - 2
    scale = max(1, int(np.ceil(w / max_cols)))
    # box-average downsample by integer factor (crop to multiple)
    hh, ww = (h // (2 * scale)) * 2 * scale, (w // scale) * scale
    small = img[:hh, :ww].reshape(
        hh // scale, scale, ww // scale, scale, 3
    ).mean((1, 3))
    rgb = (small * 255).astype(np.uint8)
    lines = []
    for r in range(0, rgb.shape[0] - 1, 2):
        row = []
        for c in range(rgb.shape[1]):
            tr, tg, tb = rgb[r, c]
            br, bg_, bb = rgb[r + 1, c]
            row.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg_};{bb}m▀")
        lines.append("".join(row) + "\x1b[0m")
    return "\n".join(lines)


def _overlay_points(img: np.ndarray, points, v=None) -> np.ndarray:
    """Mark each pair's halfway anchor with a green cross (3 px)."""
    img = np.array(img, np.float32, copy=True)
    if points is None or len(points) == 0:
        return img
    pts = np.asarray(points)
    anchors = 0.5 * (pts[:, 0] + pts[:, 1])
    h, w = img.shape[:2]
    for ay, ax in anchors:
        iy, ix = int(round(ay)), int(round(ax))
        for d in range(-3, 4):
            if 0 <= iy + d < h and 0 <= ix < w:
                img[iy + d, ix] = [0.1, 1.0, 0.2]
            if 0 <= iy < h and 0 <= ix + d < w:
                img[iy, ix + d] = [0.1, 1.0, 0.2]
    return img


def decode_keys(data: bytes):
    """Decode a byte stream into cursor-mode key events (pure function).

    Yields: 'up'/'down'/'left'/'right' (arrow escape sequences),
    'UP'/'DOWN'/'LEFT'/'RIGHT' (WASD = big steps), 'place' (space/enter),
    'undo' ('u'), 'solve' ('s'), 'quit' ('q'/ESC alone/Ctrl-C/Ctrl-D).
    Unknown bytes are ignored.
    """
    i, n = 0, len(data)
    arrows = {65: "up", 66: "down", 67: "right", 68: "left"}
    while i < n:
        b = data[i]
        if b == 0x1B:  # ESC or escape sequence
            if i + 2 < n and data[i + 1] == ord("[") and data[i + 2] in arrows:
                yield arrows[data[i + 2]]
                i += 3
                continue
            yield "quit"
            i += 1
            continue
        ch = chr(b) if 32 <= b < 127 else ""
        if ch == " " or b in (10, 13):
            yield "place"
        elif ch in ("W", "w"):
            yield "UP"
        elif ch == "S":
            yield "DOWN"
        elif ch in ("A", "a"):
            yield "LEFT"
        elif ch in ("D", "d"):
            yield "RIGHT"
        elif ch == "u":
            yield "undo"
        elif ch == "s":
            yield "solve"
        elif ch in ("q", "Q") or b in (3, 4):
            yield "quit"
        i += 1


def _overlay_cursor(img: np.ndarray, cy: float, cx: float) -> np.ndarray:
    """Red crosshair at the cursor (longer arms than point markers)."""
    img = np.array(img, np.float32, copy=True)
    h, w = img.shape[:2]
    iy, ix = int(round(cy)), int(round(cx))
    for d in range(-6, 7):
        if d == 0:
            continue
        if 0 <= iy + d < h and 0 <= ix < w:
            img[iy + d, ix] = [1.0, 0.15, 0.1]
        if 0 <= iy < h and 0 <= ix + d < w:
            img[iy, ix + d] = [1.0, 0.15, 0.1]
    return img


def _host(x: torch.Tensor) -> np.ndarray:
    """One copy of a session tensor down to a numpy array."""
    return x.detach().cpu().numpy()


class PointEditor:
    """The edit -> warm re-solve -> preview loop, on ``device`` (default
    the card; ``device="cpu"`` runs it on the CPU)."""

    def __init__(
        self,
        i0,
        i1,
        points: Optional[np.ndarray] = None,
        mp=None,
        sp=None,
        out_path: Optional[str] = None,
        stream=None,
        preview_cols: int = 0,
        show_images: bool = True,
        device=None,
    ):
        from videomorphing_tpu_torch import api

        self.session = api.Session(
            i0, i1,
            mp if mp is not None else MorphParams(),
            sp if sp is not None else SynthParams(),
            device=device,
        )
        # host copies of the two images, made once: the cursor view redraws
        # them on every key event, and they never change in a session
        self._host_images = (_host(self.session.i0), _host(self.session.i1))
        # Python floats, so that ``save`` can write them (the reference keeps
        # numpy scalars here, which json cannot encode)
        self.pairs: List[List[List[float]]] = (
            np.asarray(points, np.float32).tolist() if points is not None and len(points) else []
        )
        self.out_path = out_path
        self.stream = stream if stream is not None else sys.stdout
        self.preview_cols = preview_cols
        self.show_images = show_images
        self.solves = 0

    # -- state ---------------------------------------------------------
    def _points_arr(self) -> Optional[np.ndarray]:
        return np.asarray(self.pairs, np.float32) if self.pairs else None

    def _say(self, msg: str) -> None:
        print(msg, file=self.stream)

    def _sync(self) -> None:
        if self.session.device.type == "cuda":
            torch.cuda.synchronize(self.session.device)

    # -- commands ------------------------------------------------------
    def cmd_add(self, y0, x0, y1, x1):
        self.pairs.append([[float(y0), float(x0)], [float(y1), float(x1)]])
        self._say(f"pair {len(self.pairs) - 1}: A({y0},{x0}) <-> B({y1},{x1})")

    def cmd_move(self, i, y0, x0, y1, x1):
        self.pairs[int(i)] = [[float(y0), float(x0)], [float(y1), float(x1)]]
        self._say(f"pair {i} moved")

    def cmd_del(self, i):
        self.pairs.pop(int(i))
        self._say(f"pair {i} removed ({len(self.pairs)} left)")

    def cmd_list(self):
        if not self.pairs:
            self._say("(no pairs)")
        for k, (a, b) in enumerate(self.pairs):
            self._say(f"{k}: A({a[0]:.1f},{a[1]:.1f}) <-> B({b[0]:.1f},{b[1]:.1f})")

    def cmd_solve(self):
        """Warm re-solve with the current pairs, then show the halfway view.
        The time is read after the card has finished the solve."""
        from videomorphing_tpu_torch.viewer import halfway_image

        t0 = time.perf_counter()
        art = self.session.update_points(self._points_arr())
        self._sync()
        dt = time.perf_counter() - t0
        hw = halfway_image(self.session.i0, self.session.i1, art.v, self.session.device)
        self._show(_overlay_points(hw, self._points_arr()))
        e = float(art.result.level_stats[-1].e_final) if art.result else float("nan")
        self.solves += 1
        self._say(f"solved in {dt:.2f}s (warm={self.solves > 1})  energy={e:.5f}")

    def cmd_preview(self, t: float = 0.5):
        self._show(_host(self.session.preview(float(t))))
        self._say(f"morph frame at t={float(t):.2f}")

    def cmd_cursor(self, events=None):
        """Arrow-key point picking (the reference's click-to-place).

        ``events``: iterable of decoded key events (see :func:`decode_keys`);
        ``None`` reads raw keystrokes from the controlling tty. The state
        machine is pure relative to the event stream, so tests drive it
        headlessly with a list.
        """
        if events is None:
            events = self._tty_events()
        h, w = self.session.i0.shape[:2]
        cy, cx = h / 2.0, w / 2.0
        picking = "A"           # placing the A point or the B point
        pending = None          # the A point awaiting its B partner
        step_small, step_big = 1.0, 10.0
        self._say(
            "[cursor] arrows=move 1px, WAD/S=10px, space=place "
            f"({picking} first), u=undo, s=solve, q=done"
        )
        self._show_cursor_view(picking, cy, cx, pending)
        for ev in events:
            if ev == "quit":
                break
            if ev in ("up", "down", "left", "right", "UP", "DOWN", "LEFT", "RIGHT"):
                s = step_big if ev.isupper() else step_small
                dy = {"up": -s, "down": s}.get(ev.lower(), 0.0)
                dx = {"left": -s, "right": s}.get(ev.lower(), 0.0)
                cy = float(np.clip(cy + dy, 0, h - 1))
                cx = float(np.clip(cx + dx, 0, w - 1))
            elif ev == "place":
                if picking == "A":
                    pending = (cy, cx)
                    picking = "B"
                    self._say(f"[cursor] A point at ({cy:.0f},{cx:.0f}) — now pick B")
                else:
                    self.cmd_add(pending[0], pending[1], cy, cx)
                    pending, picking = None, "A"
            elif ev == "undo":
                if pending is not None:
                    pending, picking = None, "A"
                    self._say("[cursor] pending A point dropped")
                elif self.pairs:
                    self.cmd_del(len(self.pairs) - 1)
            elif ev == "solve":
                self.cmd_solve()
            self._show_cursor_view(picking, cy, cx, pending)
        self._say(f"[cursor] done ({len(self.pairs)} pairs)")

    def _show_cursor_view(self, picking: str, cy: float, cx: float, pending) -> None:
        if not self.show_images:
            return
        img = self._host_images[0 if picking == "A" else 1]
        view = _overlay_points(img, self._points_arr())
        if pending is not None and picking == "B":
            view = _overlay_cursor(view, pending[0], pending[1])
        self._show(_overlay_cursor(view, cy, cx))

    def _tty_events(self):
        """Raw-mode keystroke events from stdin (requires a POSIX tty)."""
        import termios
        import tty as _tty

        if not sys.stdin.isatty():
            self._say("cursor: stdin is not a tty (use scripted add/move)")
            return
        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            _tty.setraw(fd)
            while True:
                data = os.read(fd, 8)
                done = False
                for ev in decode_keys(data):
                    yield ev
                    if ev == "quit":
                        done = True
                if done:
                    break
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)

    def cmd_save(self, path: Optional[str] = None):
        path = path or self.out_path
        if not path:
            self._say("save: no path (pass one or use --out)")
            return
        with open(path, "w") as f:
            json.dump({"points": self.pairs}, f, indent=1)
        self._say(f"wrote {len(self.pairs)} pairs to {path}")

    def cmd_render(self, path: str, n: int = 16):
        from videomorphing_tpu_torch.io.clips import save_clip

        frames = _host(self.session.render(int(n)))
        save_clip(path, frames)
        self._say(f"wrote {frames.shape[0]} frames to {path}")

    def _show(self, img: np.ndarray) -> None:
        if self.show_images:
            self._say(ansi_image(img, self.preview_cols))

    # -- loop ----------------------------------------------------------
    def run(self, lines: Iterable[str]) -> int:
        """Drive the editor from an iterable of command lines."""
        self._say(
            "vmorph edit — commands: add/move/del/list/solve/preview/save/"
            "render/quit (help for details)"
        )
        for raw in lines:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            cmd, *args = line.split()
            try:
                if cmd in ("quit", "exit", "q"):
                    break
                elif cmd == "help":
                    self._say(__doc__.split("Commands:")[1])
                elif cmd == "add":
                    self.cmd_add(*args[:4])
                elif cmd == "move":
                    self.cmd_move(*args[:5])
                elif cmd in ("del", "rm"):
                    self.cmd_del(args[0])
                elif cmd == "list":
                    self.cmd_list()
                elif cmd == "solve":
                    self.cmd_solve()
                elif cmd == "preview":
                    self.cmd_preview(*args[:1])
                elif cmd == "cursor":
                    self.cmd_cursor()
                elif cmd == "save":
                    self.cmd_save(*args[:1])
                elif cmd == "render":
                    self.cmd_render(*args[:2])
                else:
                    self._say(f"unknown command: {cmd} (try help)")
            except (ValueError, IndexError, TypeError) as e:
                self._say(f"error: {e}")
        if self.out_path and self.pairs:
            self.cmd_save(self.out_path)
        return 0


def run_editor_cli(args) -> int:
    """Entry point for ``vmorph-torch edit`` (wired in cli.py)."""
    from videomorphing_tpu_torch.cli import _device, _load_points, _params_from_args
    from videomorphing_tpu_torch.io.images import load_image

    mp, sp, _ = _params_from_args(args)
    ed = PointEditor(
        load_image(args.image_a),
        load_image(args.image_b),
        points=_load_points(args.points),
        mp=mp,
        sp=sp,
        out_path=args.out,
        preview_cols=args.cols,
        show_images=not args.no_preview,
        device=_device(args),
    )
    if args.script:
        with open(args.script) as f:
            return ed.run(f.readlines())
    return ed.run(sys.stdin)
