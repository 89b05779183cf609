"""The reference's vg:: surface: a plain recorder of draw calls into RasterOps.

The methods follow the port's Context on its immediate-geometry path (the
numpy flattening and stroking the port's native backend is held to) and are
frozen here: path verbs, fills and strokes with the thin-stroke alpha law,
solid, gradient and image-pattern paints, global alpha, the state stack and
transforms, scissors, clip shapes, indexed triangle lists and text.  Same-
state opaque solid draws merge into one winding body, as the port's _emit
does, since that changes coverage where the shapes share an edge; with
`ctx.merge` False no draw merges, as in the port's replay of a Cacheable
command list (each cached draw is an op of its own).

The recorder keeps the ops in `ctx.ops`; raster.render turns them into an
image.  No device, no binning, no memo: a frame is just its ops."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from vgbench.reference import core
from vgbench.reference.core import (  # noqa: F401  (the scenes' vg.* names)
    ClipRule,
    Colors,
    FillFlags,
    FillRule,
    ImageFlags,
    PathType,
    StrokeFlags,
    TextAlign,
    TransformOrder,
    color4ub,
    colorGetAlpha,
    colorHSB,
    colorSetAlpha,
    color_to_rgba_f32,
    fill_flags_aa,
    fill_flags_path_type,
    fill_flags_rule,
    stroke_flags_aa,
    stroke_flags_line_cap,
    stroke_flags_line_join,
)
from vgbench.reference.ops import (
    K_CLIP_ADD,
    K_CLIP_COMMIT,
    K_CLIP_RESET,
    K_DRAW,
    P_GRADIENT,
    P_IMAGE,
    P_SOLID,
    P_TRI,
    RasterOp,
    make_gradient_paint,
    make_solid_paint,
)
from vgbench.reference.path import PathBuilder, replay_packed
from vgbench.reference.stroker import (
    contours_to_edges,
    polyline_to_fill_edges,
    stroke_outline,
)

INVALID_IDX = 0xFFFF


@dataclass(frozen=True)
class GradientHandle:
    idx: int = INVALID_IDX


@dataclass(frozen=True)
class ImagePatternHandle:
    idx: int = INVALID_IDX


@dataclass(frozen=True)
class ImageHandle:
    idx: int = INVALID_IDX


@dataclass(frozen=True)
class FontHandle:
    idx: int = INVALID_IDX


def isValid(handle) -> bool:
    return handle is not None and handle.idx != INVALID_IDX


@dataclass
class TextConfig:
    font: FontHandle
    font_size: float
    alignment: int
    color: int


@dataclass
class TextRow:
    start: int = 0
    end: int = 0
    next: int = 0
    width: float = 0.0
    minx: float = 0.0
    maxx: float = 0.0


@dataclass
class _State:
    transform: np.ndarray = field(default_factory=core.xform_identity)
    scissor: np.ndarray = field(default_factory=lambda: np.zeros(4))  # x,y,w,h
    global_alpha: float = 1.0
    avg_scale: float = 1.0
    font_scale: float = 1.0
    scissor_explicit: bool = False

    def copy(self) -> "_State":
        return _State(self.transform.copy(), self.scissor.copy(), self.global_alpha,
                      self.avg_scale, self.font_scale, self.scissor_explicit)

    def update(self) -> None:
        """avgScale and the 0.1-quantized font scale (updateState)."""
        m0, m1, m2, m3, _m4, _m5 = self.transform.tolist()
        sx = math.sqrt(m0 * m0 + m2 * m2)
        sy = math.sqrt(m1 * m1 + m3 * m3)
        self.avg_scale = (sx + sy) * 0.5
        self.font_scale = math.floor((self.avg_scale / 0.1) + 0.5) * 0.1


@dataclass
class Config:
    """The ContextConfig fields the recorder reads (the port's defaults)."""

    tess_tol: float = 0.25
    fringe: float = 1.0
    force_aa_off: bool = False
    min_font_size: float = 4.0
    max_fonts: int = 8


class Context:
    def __init__(self, ui_font_data: bytes | None = None) -> None:
        self.cfg = Config()
        self.ui_font_data = ui_font_data
        self.images: dict[int, tuple[np.ndarray, int]] = {}
        self.fonts: list = []
        self._font_by_name: dict[str, int] = {}
        self.font_system = None
        self.merge = True
        self.begin(0, 0, 1.0)

    # -- frame -----------------------------------------------------------
    def begin(self, w: int, h: int, dpr: float = 1.0) -> None:
        self.canvas_width, self.canvas_height = int(w), int(h)
        self.dpr = dpr
        self.fb_width = int(round(w * dpr))
        self.fb_height = int(round(h * dpr))
        self.tess_tol = self.cfg.tess_tol / dpr
        self.fringe = self.cfg.fringe / dpr
        self.state_stack = [_State()]
        self.resetScissor()
        self.state.transform = core.xform_identity()
        self.state.update()
        self.path = PathBuilder()
        self._path_xf = None
        self.ops: list[RasterOp] = []
        self.gradients: list[np.ndarray] = []
        self.image_patterns: list = []
        self._recording_clip = False
        self._clip_rule = ClipRule.In
        self._clip_shapes = 0

    @property
    def state(self) -> _State:
        return self.state_stack[-1]

    def image_map(self) -> dict:
        """image id -> (data, flags): the user images and the glyph atlas."""
        m = dict(self.images)
        if self.font_system is not None:
            m.update({k: v[:2] for k, v in self.font_system.atlas_image_map().items()})
        return m

    # -- transforms ------------------------------------------------------
    def _render_transform(self):
        if self.dpr == 1.0:
            return self.state.transform
        return core.xform_multiply(core.xform_scale(self.dpr, self.dpr), self.state.transform)

    def _path_geometry(self):
        """The current path baked and put through the render transform
        captured at its first draw (the reference's transformPath cache)."""
        if self._path_xf is None:
            self._path_xf = tuple(self._render_transform().tolist())
        verts, subs = self.path.bake()
        return core.xform_points(self._path_xf, verts), subs

    # -- paints ----------------------------------------------------------
    def _resolve_paint(self, paint_or_color, color_modulate=None):
        ga = self.state.global_alpha
        if isinstance(paint_or_color, GradientHandle):
            if not isValid(paint_or_color) or paint_or_color.idx >= len(self.gradients):
                return None
            p = self.gradients[paint_or_color.idx].copy()
            p[13] *= ga
            p[17] *= ga
            return (P_GRADIENT, p, None)
        if isinstance(paint_or_color, ImagePatternHandle):
            if not isValid(paint_or_color) or paint_or_color.idx >= len(self.image_patterns):
                return None
            mat, img = self.image_patterns[paint_or_color.idx]
            rgba = color_to_rgba_f32(color_modulate if color_modulate is not None
                                     else Colors.White)
            rgba[3] *= ga
            p = np.zeros(18, np.float32)
            p[0:6] = mat
            p[10:14] = rgba
            return (P_IMAGE, p, img)
        col = int(paint_or_color)
        if ga != 1.0:
            col = colorSetAlpha(col, int(ga * colorGetAlpha(col)))
        if colorGetAlpha(col) == 0:
            return None
        return (P_SOLID, make_solid_paint(color_to_rgba_f32(col)), None)

    def _op_scissor(self):
        if not self.state.scissor_explicit:
            return None
        s, d = self.state.scissor, self.dpr
        if s[2] <= 0 or s[3] <= 0:
            return (0.0, 0.0, 0.0, 0.0)
        return (float(s[0] * d), float(s[1] * d),
                float((s[0] + s[2]) * d), float((s[1] + s[3]) * d))

    def _emit(self, op: RasterOp, mergeable: bool = False) -> None:
        """Append an op; an opaque solid NonZero draw of the same state as
        the previous one joins its winding body (the port's _emit)."""
        prev = self.ops[-1] if self.ops else None
        mergeable = mergeable and self.merge
        if (mergeable and prev is not None and getattr(prev, "_mergeable", False)
                and op.kind == K_DRAW and prev.kind == K_DRAW
                and op.paint_kind == P_SOLID and prev.paint_kind == P_SOLID
                and op.fill_rule == FillRule.NonZero
                and prev.fill_rule == FillRule.NonZero
                and op.aa == prev.aa and op.scissor == prev.scissor
                and op.paint[13] >= 1.0 and np.array_equal(op.paint, prev.paint)):
            prev.edges = np.concatenate([prev.edges, op.edges], axis=0)
            return
        op._mergeable = mergeable
        self.ops.append(op)

    # -- fills and strokes ----------------------------------------------
    def fillPath(self, paint_or_color, flags: int, color_modulate=None) -> None:
        if self._recording_clip:
            resolved = (P_SOLID, make_solid_paint(np.array([0, 0, 0, 1], np.float32)), None)
        else:
            resolved = self._resolve_paint(paint_or_color, color_modulate)
        if resolved is None:
            return
        pk, paint, img = resolved
        aa = (not self.cfg.force_aa_off) and (not self._recording_clip) and fill_flags_aa(flags)
        rule = fill_flags_rule(flags)
        verts, subs = self._path_geometry()
        if len(subs) == 0:
            return
        kind = K_CLIP_ADD if self._recording_clip else K_DRAW

        def mk(edges):
            return RasterOp(kind=kind, edges=edges, fill_rule=rule, aa=aa,
                            paint_kind=pk, paint=paint, scissor=self._op_scissor(),
                            image_id=(img.idx if img is not None else -1))

        if fill_flags_path_type(flags) == PathType.Convex:
            for first, count, _closed in subs:
                if count < 3:
                    continue
                self._emit(mk(polyline_to_fill_edges(verts[first:first + count],
                                                     normalize=True)),
                           mergeable=not self._recording_clip)
                self._clip_shapes += self._recording_clip
        else:
            parts = [polyline_to_fill_edges(verts[f:f + c]) for f, c, _cl in subs if c >= 3]
            parts = [p for p in parts if len(p)]
            if not parts:
                return
            self._emit(mk(np.concatenate(parts, axis=0)))
            self._clip_shapes += self._recording_clip

    def strokePath(self, paint_or_color, width: float, flags: int,
                   color_modulate=None) -> None:
        st = self.state
        render_scale = st.avg_scale * self.dpr
        if flags & core.StrokeFlags.FixedWidth:
            scaled_width = width
        else:
            sw = width * st.avg_scale
            scaled_width = min(max(sw, 0.0), 200.0) * self.dpr
        fringe_fb = self.fringe * self.dpr
        if scaled_width <= fringe_fb:
            # thin strokes: fringe width, alpha scaled by the width squared
            a = min(max(scaled_width / self.dpr, 0.0), self.fringe)
            alpha_scale, stroke_width = a * a, fringe_fb
        else:
            alpha_scale, stroke_width = 1.0, scaled_width
        if self._recording_clip:
            resolved = (P_SOLID, make_solid_paint(np.array([0, 0, 0, 1], np.float32)), None)
        elif isinstance(paint_or_color, (GradientHandle, ImagePatternHandle)):
            resolved = self._resolve_paint(paint_or_color, color_modulate)
            if resolved is not None and alpha_scale < 1.0:
                p = resolved[1].copy()
                p[13] *= alpha_scale
                p[17] *= alpha_scale
                resolved = (resolved[0], p, resolved[2])
        else:
            col = int(paint_or_color)
            mod = alpha_scale * st.global_alpha
            if mod != 1.0:
                col = colorSetAlpha(col, int(mod * colorGetAlpha(col)))
            if colorGetAlpha(col) == 0:
                return
            resolved = (P_SOLID, make_solid_paint(color_to_rgba_f32(col)), None)
        if resolved is None:
            return
        pk, paint, img = resolved
        aa = (not self.cfg.force_aa_off) and (not self._recording_clip) and stroke_flags_aa(flags)
        verts, subs = self._path_geometry()
        kind = K_CLIP_ADD if self._recording_clip else K_DRAW
        for first, count, closed in subs:
            if count < 2:
                continue
            edges = contours_to_edges(stroke_outline(
                verts[first:first + count], bool(closed), stroke_width,
                stroke_flags_line_cap(flags), stroke_flags_line_join(flags),
                scale=render_scale, tol=self.tess_tol))
            if not len(edges):
                continue
            self._emit(RasterOp(kind=kind, edges=edges, fill_rule=FillRule.NonZero, aa=aa,
                                paint_kind=pk, paint=paint, scissor=self._op_scissor(),
                                image_id=(img.idx if img is not None else -1)),
                       mergeable=not self._recording_clip)
            self._clip_shapes += self._recording_clip

    # -- clip ------------------------------------------------------------
    def beginClip(self, rule: int) -> None:
        self._recording_clip = True
        self._clip_rule = rule
        self._clip_shapes = 0

    def endClip(self) -> None:
        self._recording_clip = False
        if self._clip_shapes == 0:
            self._emit(RasterOp(kind=K_CLIP_RESET))
        else:
            self._emit(RasterOp(kind=K_CLIP_COMMIT,
                                fill_rule=0 if self._clip_rule == ClipRule.In else 1))

    def resetClip(self) -> None:
        self._emit(RasterOp(kind=K_CLIP_RESET))

    # -- gradients and patterns ----------------------------------------
    def _store_gradient(self, grad_mtx, params, icol, ocol) -> GradientHandle:
        inv = core.xform_invert(core.xform_multiply(self._render_transform(), grad_mtx))
        self.gradients.append(make_gradient_paint(
            inv.astype(np.float32), params, color_to_rgba_f32(icol), color_to_rgba_f32(ocol)))
        return GradientHandle(idx=len(self.gradients) - 1)

    def createLinearGradient(self, sx, sy, ex, ey, icol, ocol) -> GradientHandle:
        large = 1e5
        dx, dy = ex - sx, ey - sy
        d = math.sqrt(dx * dx + dy * dy)
        if d > 1e-4:
            dx /= d
            dy /= d
        else:
            dx, dy = 0.0, 1.0
        gm = np.array([dy, -dx, dx, dy, sx - dx * large, sy - dy * large])
        params = np.array([large, large + d * 0.5, 0.0, max(1.0, d)], np.float32)
        return self._store_gradient(gm, params, icol, ocol)

    def createBoxGradient(self, x, y, w, h, r, f, icol, ocol) -> GradientHandle:
        gm = np.array([1.0, 0.0, 0.0, 1.0, x + w * 0.5, y + h * 0.5])
        params = np.array([w * 0.5, h * 0.5, r, max(1.0, f)], np.float32)
        return self._store_gradient(gm, params, icol, ocol)

    def createImagePattern(self, cx, cy, w, h, angle, image) -> ImagePatternHandle:
        if not isValid(image):
            return ImagePatternHandle()
        cs, sn = math.cos(angle), math.sin(angle)
        patt = core.xform_multiply(self._render_transform(),
                                   np.array([cs, sn, -sn, cs, cx, cy]))
        inv = core.xform_invert(patt) / np.array([w, h, w, h, w, h], np.float64)
        self.image_patterns.append((inv.astype(np.float32), image))
        return ImagePatternHandle(idx=len(self.image_patterns) - 1)

    def createImage(self, w: int, h: int, flags: int, data) -> ImageHandle:
        idx = len(self.images)
        arr = np.asarray(data, np.uint8).reshape(h, w, 4).copy()
        self.images[idx] = (arr, flags)
        return ImageHandle(idx=idx)

    # -- state -----------------------------------------------------------
    def pushState(self) -> None:
        self.state_stack.append(self.state.copy())

    def popState(self) -> None:
        if len(self.state_stack) <= 1:
            raise RuntimeError("state stack underflow")
        self.state_stack.pop()

    def resetScissor(self) -> None:
        self.state.scissor[:] = (0.0, 0.0, float(self.canvas_width), float(self.canvas_height))
        self.state.scissor_explicit = False

    def setScissor(self, x, y, w, h) -> None:
        m = self.state.transform
        px, py = core.xform_point(m, x, y)
        sx = m[0] * w + m[2] * h
        sy = m[1] * w + m[3] * h
        cw, chh = float(self.canvas_width), float(self.canvas_height)
        minx, miny = float(np.clip(px, 0.0, cw)), float(np.clip(py, 0.0, chh))
        maxx, maxy = float(np.clip(px + sx, 0.0, cw)), float(np.clip(py + sy, 0.0, chh))
        self.state.scissor[:] = (minx, miny, maxx - minx, maxy - miny)
        self.state.scissor_explicit = True

    def _mult(self, mtx, pre: bool = True) -> None:
        st = self.state
        st.transform = core.xform_multiply(st.transform, mtx) if pre \
            else core.xform_multiply(mtx, st.transform)
        st.update()

    # -- triangles -------------------------------------------------------
    def indexedTriList(self, pos, uv, colors, indices, img) -> None:
        """Per-vertex colours become one P_TRI op whose triangles each carry
        their colour planes (tri_paints); a single colour is one winding op."""
        if uv is not None:
            raise NotImplementedError("textured triangle lists are not in the reference")
        pos = np.asarray(pos, np.float32).reshape(-1, 2)
        spos = core.xform_points(self._render_transform(), pos)
        idx = np.asarray(indices, np.int64).reshape(-1, 3)
        colors = np.atleast_1d(np.asarray(colors, np.uint32))
        col_f = core.colors_to_rgba_f32(colors)
        col_f[:, 3] *= self.state.global_alpha
        tri = spos[idx]
        A = np.concatenate([tri.astype(np.float64), np.ones((len(idx), 3, 1))], axis=2)
        if len(col_f) == 1:
            edges = np.concatenate([tri, np.roll(tri, -1, axis=1)], axis=2).reshape(-1, 4)
            self._emit(RasterOp(edges=edges.astype(np.float32), aa=False,
                                paint=make_solid_paint(col_f[0]), scissor=self._op_scissor()))
            return
        good = np.abs(np.linalg.det(A)) > 1e-9
        tri, A, idx = tri[good], A[good], idx[good]
        if not len(idx):
            return
        edges = np.concatenate([tri, np.roll(tri, -1, axis=1)], axis=2).astype(np.float32)
        coef = np.linalg.solve(A, col_f[idx].astype(np.float64))        # (K, 3, 4)
        paints = np.zeros((len(idx), 18), np.float32)
        paints[:, 0:4], paints[:, 4:8], paints[:, 8:12] = coef[:, 0], coef[:, 1], coef[:, 2]
        self._emit(RasterOp(edges=edges.reshape(-1, 4), aa=False, paint_kind=P_TRI,
                            scissor=self._op_scissor(), tri_paints=paints))


# ---------------------------------------------------------------------------
# free functions: the vg:: names the scenes call
# ---------------------------------------------------------------------------

def createContext(ui_font_data: bytes | None = None) -> Context:
    return Context(ui_font_data)


def begin(ctx, view_id, w, h, dpr=1.0):
    ctx.begin(w, h, dpr)


def beginPath(ctx):
    ctx.path.reset(ctx.state.avg_scale, ctx.tess_tol)
    ctx._path_xf = None


def moveTo(ctx, x, y):
    ctx.path.move_to(x, y)


def lineTo(ctx, x, y):
    ctx.path.line_to(x, y)


def cubicTo(ctx, c1x, c1y, c2x, c2y, x, y):
    ctx.path.cubic_to(c1x, c1y, c2x, c2y, x, y)


def quadraticTo(ctx, cx, cy, x, y):
    ctx.path.quadratic_to(cx, cy, x, y)


def arc(ctx, cx, cy, r, a0, a1, direction):
    ctx.path.arc(cx, cy, r, a0, a1, direction)


def rect(ctx, x, y, w, h):
    ctx.path.rect(x, y, w, h)


def roundedRect(ctx, x, y, w, h, r):
    ctx.path.rounded_rect(x, y, w, h, r)


def circle(ctx, cx, cy, r):
    ctx.path.circle(cx, cy, r)


def ellipse(ctx, cx, cy, rx, ry):
    ctx.path.ellipse(cx, cy, rx, ry)


def closePath(ctx):
    ctx.path.close()


def appendPackedPath(ctx, verbs, args):
    replay_packed(ctx.path, verbs, args)


def fillPath(ctx, paint_or_color, *args):
    if isinstance(paint_or_color, ImagePatternHandle):
        color_mod, flags = args
        ctx.fillPath(paint_or_color, flags, color_modulate=color_mod)
    else:
        (flags,) = args
        ctx.fillPath(paint_or_color, flags)


def strokePath(ctx, paint_or_color, *args):
    if isinstance(paint_or_color, ImagePatternHandle):
        color_mod, width, flags = args
        ctx.strokePath(paint_or_color, width, flags, color_modulate=color_mod)
    else:
        width, flags = args
        ctx.strokePath(paint_or_color, width, flags)


def beginClip(ctx, rule):
    ctx.beginClip(rule)


def endClip(ctx):
    ctx.endClip()


def resetClip(ctx):
    ctx.resetClip()


def createLinearGradient(ctx, sx, sy, ex, ey, icol, ocol):
    return ctx.createLinearGradient(sx, sy, ex, ey, icol, ocol)


def createBoxGradient(ctx, x, y, w, h, r, f, icol, ocol):
    return ctx.createBoxGradient(x, y, w, h, r, f, icol, ocol)


def createImagePattern(ctx, cx, cy, w, h, angle, image):
    return ctx.createImagePattern(cx, cy, w, h, angle, image)


def createImage(ctx, w, h, flags, data):
    return ctx.createImage(w, h, flags, data)


def pushState(ctx):
    ctx.pushState()


def popState(ctx):
    ctx.popState()


def resetScissor(ctx):
    ctx.resetScissor()


def setScissor(ctx, x, y, w, h):
    ctx.setScissor(x, y, w, h)


def transformTranslate(ctx, x, y):
    ctx._mult(core.xform_translate(x, y))


def transformScale(ctx, x, y):
    ctx._mult(core.xform_scale(x, y))


def transformMult(ctx, mtx, order):
    ctx._mult(np.asarray(mtx, np.float64), pre=order == TransformOrder.Pre)


def indexedTriList(ctx, pos, uv, num_vertices, colors, num_colors, indices,
                   num_indices, img):
    ctx.indexedTriList(pos, uv, colors, indices, img)


def createFont(ctx, name, data, size=None, flags=0):
    from vgbench.reference.text import ctx_create_font

    return ctx_create_font(ctx, name, data, flags)


def makeTextConfig(ctx, font, font_size, alignment, color):
    return TextConfig(font, font_size, alignment, color)


def text(ctx, cfg, x, y, s, end=None):
    from vgbench.reference.text import ctx_text

    ctx_text(ctx, cfg, x, y, s if end is None else s[:end])


def textBox(ctx, cfg, x, y, break_width, s, end=None, flags=0):
    from vgbench.reference.text import ctx_text_box

    ctx_text_box(ctx, cfg, x, y, break_width, s if end is None else s[:end], flags)
