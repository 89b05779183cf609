# Frozen copy of vgtpu_torch/scenes/svg.py for the benchmark's plain reference: the
# port's host semantics as of the benchmark's first version, importing
# nothing of the program, so a later change to the port cannot move the
# yardstick.
"""Minimal SVG loader: enough of SVG 1.1 to render path-based artwork like the
Ghostscript tiger (path d= data, fill/stroke/stroke-width/opacity attributes,
groups with transforms).  This is the 'SVG tiger loader' of SURVEY.md §7.9.

Renders through the public vg API so the full pipeline is exercised.
"""

from __future__ import annotations

import math
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

from vgbench.reference import vg
from vgbench.reference import path as path_mod

_NUM = re.compile(r"[-+]?(?:\d*\.\d+|\d+\.?)(?:[eE][-+]?\d+)?")


def _parse_floats(s: str) -> list[float]:
    return [float(m) for m in _NUM.findall(s)]


def _parse_color(s: str | None, default=None):
    if s is None or s == "inherit":
        return default
    s = s.strip()
    if s == "none":
        return None
    if s.startswith("#"):
        h = s[1:]
        if len(h) == 3:
            h = "".join(c * 2 for c in h)
        r, g, b = int(h[0:2], 16), int(h[2:4], 16), int(h[4:6], 16)
        return vg.color4ub(r, g, b, 255)
    m = re.match(r"rgb\(([^)]*)\)", s)
    if m:
        parts = [p.strip() for p in m.group(1).split(",")]
        vals = []
        for p in parts:
            if p.endswith("%"):
                vals.append(int(float(p[:-1]) * 2.55))
            else:
                vals.append(int(float(p)))
        return vg.color4ub(*vals[:3], 255)
    # the CSS2 named set + common extras (SVG 1.1 color keywords subset)
    named = {
        "black": vg.Colors.Black, "white": vg.Colors.White, "red": vg.Colors.Red,
        "green": vg.color4ub(0, 128, 0, 255), "blue": vg.Colors.Blue,
        "yellow": vg.color4ub(255, 255, 0, 255), "none": None,
        "silver": vg.color4ub(192, 192, 192, 255),
        "gray": vg.color4ub(128, 128, 128, 255),
        "grey": vg.color4ub(128, 128, 128, 255),
        "maroon": vg.color4ub(128, 0, 0, 255),
        "purple": vg.color4ub(128, 0, 128, 255),
        "fuchsia": vg.color4ub(255, 0, 255, 255),
        "magenta": vg.color4ub(255, 0, 255, 255),
        "lime": vg.color4ub(0, 255, 0, 255),
        "olive": vg.color4ub(128, 128, 0, 255),
        "navy": vg.color4ub(0, 0, 128, 255),
        "teal": vg.color4ub(0, 128, 128, 255),
        "aqua": vg.color4ub(0, 255, 255, 255),
        "cyan": vg.color4ub(0, 255, 255, 255),
        "orange": vg.color4ub(255, 165, 0, 255),
        "pink": vg.color4ub(255, 192, 203, 255),
        "brown": vg.color4ub(165, 42, 42, 255),
        "gold": vg.color4ub(255, 215, 0, 255),
        "transparent": None,
    }
    key = s.lower()
    if key not in named:
        import warnings

        warnings.warn(f"svg: unknown color {s!r}, using default",
                      stacklevel=2)
    return named.get(key, default)


def _parse_transform(s: str) -> np.ndarray:
    from vgbench.reference.core import (
        xform_identity,
        xform_multiply,
        xform_rotate,
        xform_scale,
        xform_translate,
    )

    m = xform_identity()
    for op, args in re.findall(r"(\w+)\s*\(([^)]*)\)", s or ""):
        v = _parse_floats(args)
        if op == "translate":
            t = xform_translate(v[0], v[1] if len(v) > 1 else 0.0)
        elif op == "scale":
            t = xform_scale(v[0], v[1] if len(v) > 1 else v[0])
        elif op == "rotate":
            t = xform_rotate(math.radians(v[0]))
            if len(v) == 3:
                t = xform_multiply(
                    xform_multiply(xform_translate(v[1], v[2]), t),
                    xform_translate(-v[1], -v[2]),
                )
        elif op == "matrix" and len(v) == 6:
            t = np.array(v, np.float64)
        else:
            continue
        m = xform_multiply(m, t)
    return m


@dataclass
class SvgPath:
    d: str
    fill: int | None
    stroke: int | None
    stroke_width: float
    transform: np.ndarray
    fill_rule: int = 0  # NonZero
    clip_id: str | None = None


@dataclass
class SvgDoc:
    width: float
    height: float
    paths: list[SvgPath] = field(default_factory=list)
    clips: dict = field(default_factory=dict)   # id -> [(d, transform)]


def load_svg(source: str) -> SvgDoc:
    """Parse an SVG string or file path."""
    if source.lstrip().startswith("<"):
        root = ET.fromstring(source)
    else:
        root = ET.parse(source).getroot()

    def strip(tag):
        return tag.split("}")[-1]

    w = _parse_floats(root.get("width", "0") or "0")
    h = _parse_floats(root.get("height", "0") or "0")
    vb = _parse_floats(root.get("viewBox", "") or "")
    doc = SvgDoc(
        width=w[0] if w else (vb[2] if len(vb) == 4 else 0),
        height=h[0] if h else (vb[3] if len(vb) == 4 else 0),
    )

    from vgbench.reference.core import xform_identity, xform_multiply

    # pre-pass: clipPath definitions (usually inside <defs>)
    def collect_clips(el, xf):
        xf = xform_multiply(xf, _parse_transform(el.get("transform", "")))
        if strip(el.tag) == "clipPath" and el.get("id"):
            shapes = []
            for child in el.iter():
                if strip(child.tag) == "path" and child.get("d"):
                    cxf = xform_multiply(xf, _parse_transform(child.get("transform", "")))
                    shapes.append((child.get("d"), cxf.copy()))
                elif strip(child.tag) == "rect":
                    x0 = float(child.get("x", 0)); y0 = float(child.get("y", 0))
                    w0 = float(child.get("width", 0)); h0 = float(child.get("height", 0))
                    d = f"M{x0} {y0} H{x0+w0} V{y0+h0} H{x0} Z"
                    cxf = xform_multiply(xf, _parse_transform(child.get("transform", "")))
                    shapes.append((d, cxf.copy()))
            doc.clips[el.get("id")] = shapes
        for child in el:
            collect_clips(child, xf)

    collect_clips(root, xform_identity())

    def walk(el, xf, style):
        style = dict(style)
        for k in ("fill", "stroke", "stroke-width", "fill-rule", "opacity"):
            if el.get(k) is not None:
                style[k] = el.get(k)
        st = el.get("style")
        if st:
            for part in st.split(";"):
                if ":" in part:
                    k, v = part.split(":", 1)
                    style[k.strip()] = v.strip()
        for k in ("fill-opacity", "stroke-opacity"):
            if el.get(k) is not None:
                style[k] = el.get(k)
        cp = el.get("clip-path")
        if cp:
            m = re.match(r"url\(#([^)]+)\)", cp.strip())
            if m:
                style["__clip"] = m.group(1)   # innermost clip wins
        xf = xform_multiply(xf, _parse_transform(el.get("transform", "")))
        tag = strip(el.tag)
        if tag == "clipPath":
            return                             # handled by the pre-pass
        if tag == "path" and el.get("d"):
            fill = _parse_color(style.get("fill"), vg.Colors.Black)
            stroke = _parse_color(style.get("stroke"), None)
            sw = float(_parse_floats(style.get("stroke-width", "1") or "1")[0])
            rule = 1 if style.get("fill-rule") == "evenodd" else 0

            def _apply_opacity(col, key):
                if col is None:
                    return None
                o = float(style.get("opacity", 1.0)) * float(style.get(key, 1.0))
                if o >= 1.0:
                    return col
                return vg.colorSetAlpha(col, int(vg.colorGetAlpha(col) * max(o, 0.0)))

            fill = _apply_opacity(fill, "fill-opacity")
            stroke = _apply_opacity(stroke, "stroke-opacity")
            doc.paths.append(SvgPath(el.get("d"), fill, stroke, sw, xf.copy(), rule,
                                     style.get("__clip")))
        for child in el:
            walk(child, xf, style)

    walk(root, xform_identity(), {})
    return doc


_VERB_CACHE: dict = {}


def path_verbs(ctx, d: str) -> None:
    """Feed SVG path data into the current vg path (the verbs map 1:1).

    Compiled once per d-string into a PACKED program (verbs i32, args f64)
    and cached — tokenizing + parsing measured ~22 ms/frame on the 240-path
    tiger when re-done every frame, and even the compiled per-verb Python
    dispatch cost ~2 ms/frame before appendPackedPath replaced it with one
    call per path (C replay in the fast recorder)."""
    prog = _VERB_CACHE.get(d)
    if prog is None:
        prog = _VERB_CACHE[d] = _compile_path_verbs(d)
        if len(_VERB_CACHE) > 4096:
            _VERB_CACHE.clear()
            _VERB_CACHE[d] = prog
    vg.appendPackedPath(ctx, *prog)


_NAME_TO_OP = {
    "moveTo": path_mod.R_MOVE, "lineTo": path_mod.R_LINE,
    "cubicTo": path_mod.R_CUBIC, "quadraticTo": path_mod.R_QUAD,
    "arc": path_mod.R_ARC, "closePath": path_mod.R_CLOSE,
    "arcTo": path_mod.R_ARCTO,
}


def _compile_path_verbs(d: str):
    out: list = []

    class _Rec:
        def __getattr__(self, name):
            def rec(*args):
                out.append((name, args))
            return rec

    _emit_path_verbs(_Rec(), d)
    return path_mod.pack_path_program(
        [(_NAME_TO_OP[name], *args) for name, args in out])


def _emit_path_verbs(ctx, d: str) -> None:
    i = 0
    toks = re.findall(r"[MmZzLlHhVvCcSsQqTtAa]|" + _NUM.pattern, d)
    cx = cy = sx = sy = 0.0
    pcx = pcy = None  # previous control point for S/T
    cmd = None

    def nf(n):
        nonlocal i
        v = [float(toks[i + k]) for k in range(n)]
        i += n
        return v

    while i < len(toks):
        t = toks[i]
        if re.match(r"[A-Za-z]", t):
            cmd = t
            i += 1
            if cmd in "Zz":
                ctx.closePath()
                cx, cy = sx, sy
                pcx = pcy = None
                continue
        rel = cmd.islower()
        c = cmd.upper()
        if c == "M":
            x, y = nf(2)
            if rel:
                x += cx
                y += cy
            ctx.moveTo(x, y)
            cx, cy, sx, sy = x, y, x, y
            cmd = "l" if rel else "L"
            pcx = pcy = None
        elif c == "L":
            x, y = nf(2)
            if rel:
                x += cx
                y += cy
            ctx.lineTo(x, y)
            cx, cy = x, y
            pcx = pcy = None
        elif c == "H":
            (x,) = nf(1)
            if rel:
                x += cx
            ctx.lineTo(x, cy)
            cx = x
            pcx = pcy = None
        elif c == "V":
            (y,) = nf(1)
            if rel:
                y += cy
            ctx.lineTo(cx, y)
            cy = y
            pcx = pcy = None
        elif c == "C":
            x1, y1, x2, y2, x, y = nf(6)
            if rel:
                x1 += cx; y1 += cy; x2 += cx; y2 += cy; x += cx; y += cy
            ctx.cubicTo(x1, y1, x2, y2, x, y)
            pcx, pcy = x2, y2
            cx, cy = x, y
        elif c == "S":
            x2, y2, x, y = nf(4)
            if rel:
                x2 += cx; y2 += cy; x += cx; y += cy
            x1 = 2 * cx - pcx if pcx is not None else cx
            y1 = 2 * cy - pcy if pcy is not None else cy
            ctx.cubicTo(x1, y1, x2, y2, x, y)
            pcx, pcy = x2, y2
            cx, cy = x, y
        elif c == "Q":
            x1, y1, x, y = nf(4)
            if rel:
                x1 += cx; y1 += cy; x += cx; y += cy
            ctx.quadraticTo(x1, y1, x, y)
            pcx, pcy = x1, y1
            cx, cy = x, y
        elif c == "T":
            x, y = nf(2)
            if rel:
                x += cx; y += cy
            x1 = 2 * cx - pcx if pcx is not None else cx
            y1 = 2 * cy - pcy if pcy is not None else cy
            ctx.quadraticTo(x1, y1, x, y)
            pcx, pcy = x1, y1
            cx, cy = x, y
        elif c == "A":
            # elliptical arc -> cubic-ish via vg.arc on circles; general case
            # approximated with the endpoint parameterization
            rx, ry, rot, laf, swf, x, y = nf(7)
            if rel:
                x += cx; y += cy
            _svg_arc(ctx, cx, cy, rx, ry, rot, laf, swf, x, y)
            cx, cy = x, y
            pcx = pcy = None
        else:
            i += 1

    return None


def _svg_arc(ctx, x0, y0, rx, ry, rot_deg, laf, swf, x, y):
    """SVG endpoint arc -> polyline via the standard center parameterization."""
    if rx <= 0 or ry <= 0 or (x0 == x and y0 == y):
        ctx.lineTo(x, y)
        return
    phi = math.radians(rot_deg)
    cphi, sphi = math.cos(phi), math.sin(phi)
    dx2, dy2 = (x0 - x) / 2.0, (y0 - y) / 2.0
    x1p = cphi * dx2 + sphi * dy2
    y1p = -sphi * dx2 + cphi * dy2
    l = x1p**2 / rx**2 + y1p**2 / ry**2
    if l > 1:
        s = math.sqrt(l)
        rx *= s
        ry *= s
    num = rx**2 * ry**2 - rx**2 * y1p**2 - ry**2 * x1p**2
    den = rx**2 * y1p**2 + ry**2 * x1p**2
    co = math.sqrt(max(0.0, num / den)) * (1 if laf != swf else -1)
    cxp = co * rx * y1p / ry
    cyp = -co * ry * x1p / rx
    cx_ = cphi * cxp - sphi * cyp + (x0 + x) / 2
    cy_ = sphi * cxp + cphi * cyp + (y0 + y) / 2

    def ang(ux, uy, vx, vy):
        d = math.hypot(ux, uy) * math.hypot(vx, vy)
        a = math.acos(max(-1, min(1, (ux * vx + uy * vy) / d)))
        return a if ux * vy - uy * vx >= 0 else -a

    th1 = ang(1, 0, (x1p - cxp) / rx, (y1p - cyp) / ry)
    dth = ang((x1p - cxp) / rx, (y1p - cyp) / ry, (-x1p - cxp) / rx, (-y1p - cyp) / ry)
    if not swf and dth > 0:
        dth -= 2 * math.pi
    elif swf and dth < 0:
        dth += 2 * math.pi
    n = max(2, int(abs(dth) / 0.1))
    ts = np.linspace(0, 1, n + 1)[1:]
    for t in ts:
        a = th1 + dth * t
        ex = cx_ + rx * math.cos(a) * cphi - ry * math.sin(a) * sphi
        ey = cy_ + rx * math.cos(a) * sphi + ry * math.sin(a) * cphi
        ctx.lineTo(ex, ey)


def render_svg(ctx, doc: SvgDoc, aa: bool = True) -> None:
    """Draw a parsed SVG through the vg API with the current transform."""
    from vgbench.reference.core import TransformOrder

    fill_flags_aa = vg.FillFlags.ConcaveNonZeroAA if aa else vg.FillFlags.ConcaveNonZero
    fill_flags_eo = vg.FillFlags.ConcaveEvenOddAA if aa else vg.FillFlags.ConcaveEvenOdd
    stroke_flags = (
        vg.StrokeFlags.ButtRoundAA if aa else vg.StrokeFlags.ButtRound
    )
    active_clip = None
    for p in doc.paths:
        # set the engine clip when the SVG clip changes (runs of equally
        # clipped paths share one beginClip/endClip)
        clip = p.clip_id if (p.clip_id in doc.clips and doc.clips[p.clip_id]) else None
        if clip != active_clip:
            if clip is None:
                vg.resetClip(ctx)
            else:
                vg.beginClip(ctx, vg.ClipRule.In)
                for d, cxf in doc.clips[clip]:
                    vg.pushState(ctx)
                    vg.transformMult(ctx, cxf, TransformOrder.Pre)
                    vg.beginPath(ctx)
                    path_verbs(ctx, d)
                    vg.fillPath(ctx, vg.Colors.Black, vg.FillFlags.ConcaveNonZero)
                    vg.popState(ctx)
                vg.endClip(ctx)
            active_clip = clip
        vg.pushState(ctx)
        vg.transformMult(ctx, p.transform, TransformOrder.Pre)
        vg.beginPath(ctx)
        path_verbs(ctx, p.d)
        if p.fill is not None:
            vg.fillPath(ctx, p.fill, fill_flags_eo if p.fill_rule else fill_flags_aa)
        if p.stroke is not None:
            vg.strokePath(ctx, p.stroke, p.stroke_width, stroke_flags)
        vg.popState(ctx)
    if active_clip is not None:
        vg.resetClip(ctx)
