"""Port parity: the terminal point editor (``videomorphing_tpu_torch/edit.py``
against ``videomorphing_tpu/edit.py``) and ``cli edit``.

The same numpy images (a blob of 48 x 48 or 24 x 24, as
``tests/test_edit.py`` draws it) and the same scripts drive both editors.

- ``ansi_image`` and ``decode_keys``: numpy copies, equal byte for byte;
- the scripted round trip (add, list, solve, move, warm solve, preview,
  save): the printed lines equal the reference's with the solve times
  masked and the printed energies within 1e-5 relative (float32 sums in
  another order), and the saved JSON is identical. The cold fields of the two
  packages differ by 2.3e-5 px (max abs), the reference's own distance
  under 1-ulp input noise (1.2e-5 to 3.8e-5 px over three draws). The warm
  solve amplifies that: moving the reference's own warm start by 2e-5 px
  moves its warm field by 3.0e-3 to 1.1e-2 px max and 5.0e-5 px mean abs
  (three draws). So the final fields must agree within 1e-2 px max and
  5e-5 px mean abs (measured: 1.05e-3 and 4.0e-6);
- the cursor session (events, no tty): the same pairs and lines, and with
  previews on the same ANSI cursor views;
- ``render``: a (4, 24, 24, 3) uint8 ``.npz`` within 1 level of 255 of the
  reference's (a cold solve of 23 iterations, float32 drift);
- bad commands print an error and do not stop the loop;
- ``cli edit --script ... --no-preview --device cpu`` end to end, and its
  default ``--device cuda`` raises without a card.
"""

import io
import json
import re

import numpy as np
import pytest
import torch

from videomorphing_tpu import edit as jed
from videomorphing_tpu.config import MorphParams as JaxMorphParams
from videomorphing_tpu.config import SynthParams as JaxSynthParams
from videomorphing_tpu_torch import cli
from videomorphing_tpu_torch import edit as ted
from videomorphing_tpu_torch.config import MorphParams, SynthParams

torch.set_num_threads(2)
SP = dict(blend_mode="linear", quadratic_paths=False)


def _blob(h, w, cy, cx, sigma=4.0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.exp(-0.5 * ((yy - cy) ** 2 + (xx - cx) ** 2) / np.float32(sigma * sigma)).astype(np.float32)
    return np.stack([img, 0.8 * img, 0.6 * img], -1).astype(np.float32)


def _editors(i0, i1, mp_kw, **kw):
    """The reference's editor and the port's on the CPU, each with its own
    output stream."""
    ref = jed.PointEditor(i0, i1, mp=JaxMorphParams(**mp_kw), sp=JaxSynthParams(**SP),
                          stream=io.StringIO(), **kw)
    got = ted.PointEditor(i0, i1, mp=MorphParams(**mp_kw), sp=SynthParams(**SP),
                          stream=io.StringIO(), device="cpu", **kw)
    return ref, got


def _lines(ed, *names):
    """The editor's printed lines with the solve times and the energies
    masked (and ``names`` replaced by ``*``), and the energies."""
    text = re.sub(r"solved in \d+\.\d\ds", "solved in *s", ed.stream.getvalue())
    for name in names:
        text = text.replace(name, "*")
    energies = [float(e) for e in re.findall(r"energy=(\S+)", text)]
    return re.sub(r"energy=\S+", "energy=*", text).splitlines(), energies


def _same_lines(got, ref, names=()):
    """Equal lines, and energies within 1e-5 relative (float32 sums in
    another order: the last printed digit may differ)."""
    lines, e = _lines(got, *names)
    lines_ref, e_ref = _lines(ref, *names)
    assert lines == lines_ref
    np.testing.assert_allclose(e, e_ref, rtol=1e-5)


# ---------------------------------------------------------------- pure parts


@pytest.mark.parametrize("case", ["rgb", "grey", "odd", "scaled", "one_channel"])
def test_ansi_image_equals_reference(case):
    rng = np.random.default_rng(1)
    img, cols = {
        "rgb": (rng.random((8, 8, 3), dtype=np.float32), 8),
        "grey": (rng.random((10, 12), dtype=np.float32), 40),
        "odd": (rng.random((13, 17, 3), dtype=np.float32), 40),
        "scaled": (rng.random((30, 50, 3), dtype=np.float32) * 1.2 - 0.1, 7),
        "one_channel": (rng.random((9, 11, 1), dtype=np.float32), 4),
    }[case]
    got = ted.ansi_image(img, max_cols=cols)
    assert got == jed.ansi_image(img, max_cols=cols)
    assert "▀" in got


def test_decode_keys_equals_reference():
    corpus = [
        b"\x1b[A\x1b[B\x1b[C\x1b[D wWSad us q", b"\x1b", b"\x03", b"\x04", b"\r\n", b"\x1b[", b"\x1b[Z",
        b"zz\x7fQ", bytes(range(256)),
    ]
    for data in corpus:
        assert list(ted.decode_keys(data)) == list(jed.decode_keys(data)), data


def test_overlays_equal_reference():
    img = np.random.default_rng(2).random((20, 24, 3), dtype=np.float32)
    pts = np.array([[[2.0, 3.0], [4.0, 5.0]], [[18.6, 22.4], [19.0, 23.0]]], np.float32)
    np.testing.assert_array_equal(ted._overlay_points(img, pts), jed._overlay_points(img, pts))
    np.testing.assert_array_equal(ted._overlay_points(img, None), jed._overlay_points(img, None))
    for cy, cx in ((0.0, 0.0), (10.4, 11.6), (19.0, 23.0)):
        np.testing.assert_array_equal(ted._overlay_cursor(img, cy, cx), jed._overlay_cursor(img, cy, cx))


# ------------------------------------------------------------- the sessions


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    d = tmp_path_factory.mktemp("edit")
    i0, i1 = _blob(48, 48, 24, 20), _blob(48, 48, 24, 28)
    script = ["add 24 20 24 28", "list", "solve", "move 0 24.0 20.0 24.0 28.0", "solve", "preview 0.5",
              "save", "quit"]
    out = {}
    for name, ed in zip(("ref", "got"), _editors(i0, i1, dict(n_levels=2, iters_coarse=30, iters_fine=15),
                                                  show_images=False)):
        ed.out_path = str(d / f"{name}.json")
        assert ed.run(script) == 0
        out[name] = ed
    return out


def test_scripted_round_trip_prints_and_saves_as_reference(round_trip):
    ref, got = round_trip["ref"], round_trip["got"]
    assert got.solves == ref.solves == 2
    _same_lines(got, ref, ("got.json", "ref.json"))
    assert "warm=True" in got.stream.getvalue()
    with open(ref.out_path) as f, open(got.out_path) as g:
        assert g.read() == f.read()


def test_scripted_round_trip_field_matches_reference(round_trip):
    v_ref = np.asarray(round_trip["ref"].session.art.v)
    v = round_trip["got"].session.art.v.numpy()
    err = np.abs(v - v_ref)
    assert err.max() <= 1e-2 and err.mean() <= 5e-5, (err.max(), err.mean())
    # the tests/test_edit.py claim: the halfway blob sits near x = 24
    assert abs(v[20:29, 21:28, 1].mean() - 4.0) < 1.5


def test_cursor_session_matches_reference():
    i0, i1 = _blob(48, 48, 24, 20), _blob(48, 48, 24, 28)
    events = ["LEFT", "up", "place", "RIGHT", "RIGHT", "place", "place", "undo", "solve", "place", "undo",
              "undo", "quit", "place"]
    ref, got = _editors(i0, i1, dict(n_levels=2, iters_coarse=20, iters_fine=10), show_images=False)
    ref.cmd_cursor(list(events))
    got.cmd_cursor(list(events))
    assert got.pairs == ref.pairs == []
    assert got.solves == ref.solves == 1
    _same_lines(got, ref)
    assert "pending A point dropped" in got.stream.getvalue()
    got2 = ted.PointEditor(i0, i1, mp=MorphParams(n_levels=2, iters_coarse=20, iters_fine=10),
                           sp=SynthParams(**SP), stream=io.StringIO(), show_images=False, device="cpu")
    got2.cmd_cursor(["LEFT", "up", "place", "RIGHT", "RIGHT", "place", "place", "undo", "quit"])
    assert got2.pairs == [[[23.0, 14.0], [23.0, 34.0]]]


def test_cursor_view_shows_images():
    """With previews on, the cursor views (images with the point and
    cursor overlays) render the same ANSI text as the reference's."""
    i0, i1 = _blob(24, 24, 12, 10), _blob(24, 24, 12, 14)
    ref, got = _editors(i0, i1, dict(n_levels=1, iters_coarse=4, iters_fine=4), show_images=True,
                        preview_cols=12)
    events = ["up", "place", "RIGHT", "place", "quit"]
    ref.cmd_cursor(list(events))
    got.cmd_cursor(list(events))
    assert got.pairs == ref.pairs
    _same_lines(got, ref)


def test_render_writes_frames_like_reference(tmp_path):
    i0, i1 = _blob(24, 24, 12, 10), _blob(24, 24, 12, 14)
    ref, got = _editors(i0, i1, dict(n_levels=2, iters_coarse=15, iters_fine=8), show_images=False)
    ref.run([f"render {tmp_path / 'ref.npz'} 4", "quit"])
    got.run([f"render {tmp_path / 'got.npz'} 4", "quit"])
    f_ref = np.load(tmp_path / "ref.npz")["frames"]
    f_got = np.load(tmp_path / "got.npz")["frames"]
    assert f_got.shape == f_ref.shape == (4, 24, 24, 3) and f_got.dtype == np.uint8
    assert np.abs(f_got.astype(int) - f_ref.astype(int)).max() <= 1
    assert "wrote 4 frames" in got.stream.getvalue()


def test_bad_commands_do_not_crash():
    i0 = _blob(16, 16, 8, 8)
    out = io.StringIO()
    ed = ted.PointEditor(i0, i0, stream=out, show_images=False, device="cpu")
    assert ed.run(["bogus", "del 5", "move x", "", "# comment", "add 1 2", "save", "help", "quit"]) == 0
    text = out.getvalue()
    assert "unknown command" in text and text.count("error:") == 3
    assert "save: no path" in text and "Commands:" not in text and "move I Y0 X0 Y1 X1" in text


# ------------------------------------------------------------ cli edit


def test_cli_edit_runs_a_script_on_the_cpu(tmp_path, capsys):
    from videomorphing_tpu_torch.io.images import save_image

    save_image(str(tmp_path / "a.png"), _blob(24, 24, 12, 10))
    save_image(str(tmp_path / "b.png"), _blob(24, 24, 12, 14))
    (tmp_path / "p.json").write_text(json.dumps({"points": [[[12, 10], [12, 14]]]}))
    (tmp_path / "s.txt").write_text(f"list\nsolve\npreview 0.25\nrender {tmp_path / 'f.npz'} 3\nquit\n")
    out = str(tmp_path / "out.json")
    assert cli.main(["edit", str(tmp_path / "a.png"), str(tmp_path / "b.png"), "--points", str(tmp_path / "p.json"),
                     "--script", str(tmp_path / "s.txt"), "--no-preview", "--out", out, "--device", "cpu",
                     "--levels", "2", "--iters", "10"]) == 0
    text = capsys.readouterr().out
    assert "0: A(12.0,10.0) <-> B(12.0,14.0)" in text and "solved in" in text and "\x1b[" not in text
    assert json.loads(open(out).read()) == {"points": [[[12.0, 10.0], [12.0, 14.0]]]}
    assert np.load(tmp_path / "f.npz")["frames"].shape == (3, 24, 24, 3)


def test_cli_edit_defaults_to_the_card(monkeypatch, tmp_path):
    from videomorphing_tpu_torch.io.images import save_image

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    save_image(str(tmp_path / "a.png"), _blob(16, 16, 8, 8))
    args = cli.build_parser().parse_args(["edit", str(tmp_path / "a.png"), str(tmp_path / "a.png")])
    assert args.device == "cuda" and args.fn is cli.cmd_edit
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["edit", str(tmp_path / "a.png"), str(tmp_path / "a.png"), "--no-preview"])
