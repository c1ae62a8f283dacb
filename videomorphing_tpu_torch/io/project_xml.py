"""Best-effort importer for reference-style XML project files.

A copy of ``videomorphing_tpu/io/project_xml.py`` against this package's
``io.project`` and ``config``.

The reference's MdiEditor persists its projects as XML — input paths,
energy-weight settings, the user's correspondence points and layer masks
(SURVEY.md section 3 "Project/config"). The exact schema is [RECON]-grade
(the original source was not available — SURVEY.md section 0),
so this importer is deliberately TOLERANT rather than schema-exact: it
walks the tree for the structures any variant of that format must contain
and maps them onto :class:`videomorphing_tpu_torch.io.project.Project`.

What it recognizes (all case-insensitive, attribute or child-element form):

- **Sources**: the first two path-valued entries whose name contains
  ``image`` / ``video`` / ``clip`` / ``source`` / ``file``, ordered by any
  0/1 | a/b | left/right suffix, else by document order.
- **Points**: elements carrying ``x0/y0/x1/y1``-style coordinates (any of
  the spellings ``x0 y0 x1 y1``, ``ax ay bx by``, ``x_a y_a x_b y_b``), or
  consecutive ``<point x= y=>`` pairs under a group whose name contains
  ``point``/``correspond``/``pair``. Frame-indexed groups (a ``frame`` /
  ``time`` / ``index`` attribute on the group) become video keyframes.
  NOTE the axis order: XML conventions are (x, y); Project stores (y, x).
- **Parameters**: numeric entries whose name mentions ``ssim`` (ignored —
  weight folded into the others), ``tps``/``smooth`` -> ``lambda_tps``,
  ``ui``/``point``/``constraint`` -> ``gamma_ui``, ``tc``/``temporal`` ->
  ``beta_tc``, ``layer`` in a mask path context -> layers.
- **Layers**: groups named like ``layer`` with mask paths (``mask``).
- **Output / frame count**: entries named ``output``/``out``/``result``
  and ``frames``/``nframes``/``num_frames``.

Anything unrecognized is collected into the returned report so a user can
finish the migration by hand instead of silently losing settings.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from videomorphing_tpu_torch.io.project import Project


_PATH_KEY = re.compile(r"(image|video|clip|source|file|input)", re.I)
_PATH_VAL = re.compile(r"\.(png|jpe?g|bmp|npz|npy|vmc|y4m|mp4|avi|mov|webm)$|[/\\]", re.I)
_ORDER_B = re.compile(r"(1|b|right|second)\s*$", re.I)
_POINT_GROUP = re.compile(r"(point|correspond|pair)", re.I)
_LAYER_GROUP = re.compile(r"layer", re.I)
_FRAME_ATTR = re.compile(r"^(frame|time|index|key)$", re.I)

# coordinate spelling variants, each as ((x0, y0), (x1, y1)) attribute names
_COORD_SPELLINGS: Tuple[Tuple[Tuple[str, str], Tuple[str, str]], ...] = (
    (("x0", "y0"), ("x1", "y1")),
    (("ax", "ay"), ("bx", "by")),
    (("x_a", "y_a"), ("x_b", "y_b")),
    (("xa", "ya"), ("xb", "yb")),
)

_PARAM_MAP: Tuple[Tuple[re.Pattern, Tuple[str, str]], ...] = (
    (re.compile(r"(tps|smooth)", re.I), ("morph", "lambda_tps")),
    (re.compile(r"(ui|constraint)", re.I), ("morph", "gamma_ui")),
    (re.compile(r"(tc|temporal)", re.I), ("morph", "beta_tc")),
)


def _lc(s: Optional[str]) -> str:
    return (s or "").strip().lower()


def _items(el: ET.Element):
    """Yield (name, value, element) over attributes and text-leaf children."""
    for k, v in el.attrib.items():
        yield k, v, el
    for ch in el:
        if len(ch) == 0 and ch.text and ch.text.strip():
            yield ch.tag, ch.text.strip(), ch


def _try_float(v: str) -> Optional[float]:
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def _pair_from_attrs(el: ET.Element) -> Optional[List[List[float]]]:
    """One correspondence pair [[y0,x0],[y1,x1]] from a coordinate element."""
    at = {k.lower(): v for k, v in el.attrib.items()}
    for ch in el:
        if len(ch) == 0 and ch.text and ch.text.strip():
            at.setdefault(ch.tag.lower(), ch.text.strip())
    for (xa, ya), (xb, yb) in _COORD_SPELLINGS:
        if all(k in at for k in (xa, ya, xb, yb)):
            vals = [_try_float(at[k]) for k in (ya, xa, yb, xb)]
            if None not in vals:
                return [[vals[0], vals[1]], [vals[2], vals[3]]]
    return None


def _single_point(el: ET.Element) -> Optional[List[float]]:
    at = {k.lower(): v for k, v in el.attrib.items()}
    if "x" in at and "y" in at:
        x, y = _try_float(at["x"]), _try_float(at["y"])
        if x is not None and y is not None:
            return [y, x]
    return None


def _collect_points(group: ET.Element) -> List[List[List[float]]]:
    """All correspondence pairs under a group element."""
    pairs: List[List[List[float]]] = []
    singles: List[List[float]] = []
    for el in group.iter():
        p = _pair_from_attrs(el)
        if p is not None:
            pairs.append(p)
            continue
        s = _single_point(el)
        if s is not None:
            singles.append(s)
    # consecutive single <point x y> entries pair up A,B,A,B
    if not pairs and len(singles) >= 2:
        pairs = [[singles[i], singles[i + 1]] for i in range(0, len(singles) - 1, 2)]
    return pairs


def import_xml_project(path: str) -> Tuple[Project, Dict[str, Any]]:
    """Parse a reference-style XML project into a :class:`Project`.

    Returns ``(project, report)`` where ``report`` lists what was mapped
    and what was skipped — the schema is [RECON]-unverified, so the import
    is explicit about its own coverage rather than pretending fidelity.
    """
    tree = ET.parse(path)
    root = tree.getroot()
    base = os.path.dirname(os.path.abspath(path))

    sources: List[Tuple[bool, str, str]] = []   # (is_b, name, resolved path)
    overrides: Dict[str, Dict[str, float]] = {"morph": {}, "synth": {}, "video": {}}
    mapped: List[str] = []
    skipped: List[str] = []
    n_frames = None
    output = None

    point_groups: List[Tuple[Optional[int], List]] = []
    layers: List[Dict[str, Any]] = []

    # entries a claimed group DID consume (coords, masks, frame indices) —
    # anything else inside it still lands in the skipped report (the module
    # contract: nothing is dropped silently)
    _GROUP_KNOWN = re.compile(
        r"^(x|y|x0|y0|x1|y1|ax|ay|bx|by|x_a|y_a|x_b|y_b|xa|ya|xb|yb"
        r"|frame|time|index|key)$|mask",
        re.I,
    )

    def _report_unconsumed(group: ET.Element) -> None:
        for sub in group.iter():
            for k, v in sub.attrib.items():
                if not _GROUP_KNOWN.search(k):
                    skipped.append(f"{sub.tag}/{k} = {v}")
            for ch in sub:
                if len(ch) == 0 and ch.text and ch.text.strip() and not _GROUP_KNOWN.search(ch.tag):
                    skipped.append(f"{sub.tag}/{ch.tag} = {ch.text.strip()}")

    claimed: set = set()
    for el in root.iter():
        tag = _lc(el.tag)
        if _LAYER_GROUP.search(tag) and el is not root:
            masks = [
                v for k, v, _src in _items(el)
                if re.search(r"mask", k, re.I) and _PATH_VAL.search(v or "")
            ]
            lpts = _collect_points(el)
            if masks or lpts:
                lay: Dict[str, Any] = {}
                if masks:
                    lay["mask_a"] = os.path.join(base, masks[0])
                    lay["mask_b"] = os.path.join(base, masks[-1])
                if lpts:
                    lay["points"] = lpts
                layers.append(lay)
                claimed.update(id(x) for x in el.iter())
                _report_unconsumed(el)
                mapped.append(f"layer <{el.tag}> ({len(lpts)} pairs, {len(masks)} masks)")
                continue
        if _POINT_GROUP.search(tag) and id(el) not in claimed:
            pts = _collect_points(el)
            if pts:
                frame = None
                for k, v in el.attrib.items():
                    if _FRAME_ATTR.match(k) and _try_float(v) is not None:
                        frame = int(float(v))
                point_groups.append((frame, pts))
                claimed.update(id(x) for x in el.iter())
                _report_unconsumed(el)
                mapped.append(
                    f"points <{el.tag}> ({len(pts)} pairs"
                    + (f", frame {frame})" if frame is not None else ")")
                )
                continue

    for el in root.iter():
        if id(el) in claimed:
            continue
        for name, val, src in _items(el):
            if id(src) in claimed:
                continue
            lname = _lc(name)
            # output naming wins over source naming: "outputfile" /
            # "result_clip" contain source keywords ("file", "clip") but
            # are destinations — consuming them as inputs displaced a real
            # source (review finding)
            is_out = bool(re.search(r"^(out|output|result)", lname))
            if not is_out and _PATH_KEY.search(lname) and val and _PATH_VAL.search(val):
                is_b = bool(_ORDER_B.search(lname))
                sources.append((is_b, lname, os.path.join(base, val)))
                mapped.append(f"source {name} = {val}")
                continue
            f = _try_float(val)
            if f is not None:
                if re.search(r"^(n_?frames?|num_?frames?|frames)$", lname):
                    n_frames = int(f)
                    mapped.append(f"n_frames = {n_frames}")
                    continue
                hit = False
                for pat, (sec, field) in _PARAM_MAP:
                    if pat.search(lname) and re.search(r"(weight|lambda|gamma|beta|w_)", lname):
                        overrides[sec][field] = f
                        mapped.append(f"{name} -> {sec}.{field} = {f}")
                        hit = True
                        break
                if hit:
                    continue
                skipped.append(f"{el.tag}/{name} = {val}")
            elif is_out and val:
                output = os.path.join(base, val)
                mapped.append(f"output = {val}")
            elif val and len(val) < 120:
                skipped.append(f"{el.tag}/{name} = {val}")

    sources.sort(key=lambda s: s[0])  # a-side entries first, stable otherwise
    if len(sources) < 2:
        raise ValueError(
            f"{path}: found {len(sources)} input path(s); an importable project "
            "needs two (elements/attributes named like image0/image1, "
            "videoA/videoB, source...)"
        )

    points: Any = None
    keyed = {f: p for f, p in point_groups if f is not None}
    flat = [pair for f, p in point_groups if f is None for pair in p]
    if keyed:
        points = {
            f: np.asarray(p, np.float32) for f, p in sorted(keyed.items())
        }
        if flat:
            points.setdefault(0, np.asarray(flat, np.float32))
    elif flat:
        points = np.asarray(flat, np.float32)

    from videomorphing_tpu_torch.io.project import _apply  # same override semantics
    from videomorphing_tpu_torch.config import MorphParams, SynthParams, VideoParams

    proj = Project(
        source_a=sources[0][2],
        source_b=sources[1][2],
        points=points,
        layers=layers or None,
        n_frames=n_frames if n_frames is not None else 16,
        morph=_apply(MorphParams, MorphParams(), overrides["morph"]),
        synth=_apply(SynthParams, SynthParams(), overrides["synth"]),
        video=_apply(VideoParams, VideoParams(), overrides["video"]),
        output=output or "morph_out",
    )
    report = {"mapped": mapped, "skipped": skipped}
    return proj, report
