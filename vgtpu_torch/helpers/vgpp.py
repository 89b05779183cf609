# Copied from vgtpu/helpers/vgpp.py: the jax-free host half of the PyTorch port.
"""Object-oriented convenience wrapper — the vgpp compat layer
(include/vg/helpers/vgpp.h, which the reference keeps for legacy code).

`Renderer` wraps a Context with methods instead of free functions; `Shape`
wraps a command list and mirrors the reference's Shape recording object.
"""

from __future__ import annotations

import vgtpu_torch as vg


class Shape:
    """Recorded, replayable shape (vgpp::Shape over a command list)."""

    def __init__(self, renderer: "Renderer", flags: int = vg.CommandListFlags.Cacheable):
        self._r = renderer
        self.handle = vg.createCommandList(renderer.ctx, flags)

    def __enter__(self):
        vg.beginCommandList(self._r.ctx, self.handle)
        return self._r

    def __exit__(self, *exc):
        vg.endCommandList(self._r.ctx)
        return False

    def reset(self):
        vg.resetCommandList(self._r.ctx, self.handle)

    def destroy(self):
        vg.destroyCommandList(self._r.ctx, self.handle)


class Renderer:
    def __init__(self, cfg=None, *, device="cuda"):
        # device: the context's torch device (createContext's keyword)
        self.ctx = vg.createContext(None, cfg, device=device)

    # frame
    def begin_frame(self, w, h, dpr=1.0, view_id=0):
        vg.begin(self.ctx, view_id, w, h, dpr)

    def end_frame(self, background=None):
        return vg.end(self.ctx, background)

    def frame(self):
        vg.frame(self.ctx)

    def readback(self):
        return self.ctx.readback_u8()

    # shapes
    def create_shape(self, flags: int = vg.CommandListFlags.Cacheable) -> Shape:
        return Shape(self, flags)

    def submit(self, shape: Shape):
        vg.submitCommandList(self.ctx, shape.handle)

    # paths
    def begin_path(self):
        vg.beginPath(self.ctx)
        return self

    def move_to(self, x, y):
        vg.moveTo(self.ctx, x, y)
        return self

    def line_to(self, x, y):
        vg.lineTo(self.ctx, x, y)
        return self

    def cubic_to(self, c1x, c1y, c2x, c2y, x, y):
        vg.cubicTo(self.ctx, c1x, c1y, c2x, c2y, x, y)
        return self

    def quadratic_to(self, cx, cy, x, y):
        vg.quadraticTo(self.ctx, cx, cy, x, y)
        return self

    def arc(self, cx, cy, r, a0, a1, direction=vg.Winding.CW):
        vg.arc(self.ctx, cx, cy, r, a0, a1, direction)
        return self

    def arc_to(self, x1, y1, x2, y2, r):
        vg.arcTo(self.ctx, x1, y1, x2, y2, r)
        return self

    def rect(self, x, y, w, h):
        vg.rect(self.ctx, x, y, w, h)
        return self

    def rounded_rect(self, x, y, w, h, r):
        vg.roundedRect(self.ctx, x, y, w, h, r)
        return self

    def circle(self, cx, cy, r):
        vg.circle(self.ctx, cx, cy, r)
        return self

    def ellipse(self, cx, cy, rx, ry):
        vg.ellipse(self.ctx, cx, cy, rx, ry)
        return self

    def polyline(self, coords):
        vg.polyline(self.ctx, coords)
        return self

    def close_path(self):
        vg.closePath(self.ctx)
        return self

    # draws
    def fill(self, paint_or_color, flags=vg.FillFlags.ConcaveNonZeroAA):
        vg.fillPath(self.ctx, paint_or_color, flags)
        return self

    def stroke(self, paint_or_color, width, flags=vg.StrokeFlags.ButtMiterAA):
        vg.strokePath(self.ctx, paint_or_color, width, flags)
        return self

    # paints
    def linear_gradient(self, sx, sy, ex, ey, icol, ocol):
        return vg.createLinearGradient(self.ctx, sx, sy, ex, ey, icol, ocol)

    def box_gradient(self, x, y, w, h, r, f, icol, ocol):
        return vg.createBoxGradient(self.ctx, x, y, w, h, r, f, icol, ocol)

    def radial_gradient(self, cx, cy, inr, outr, icol, ocol):
        return vg.createRadialGradient(self.ctx, cx, cy, inr, outr, icol, ocol)

    def image_pattern(self, cx, cy, w, h, angle, image):
        return vg.createImagePattern(self.ctx, cx, cy, w, h, angle, image)

    # state
    def push_state(self):
        vg.pushState(self.ctx)
        return self

    def pop_state(self):
        vg.popState(self.ctx)
        return self

    def translate(self, x, y):
        vg.transformTranslate(self.ctx, x, y)
        return self

    def rotate(self, a):
        vg.transformRotate(self.ctx, a)
        return self

    def scale(self, x, y):
        vg.transformScale(self.ctx, x, y)
        return self

    def scissor(self, x, y, w, h):
        vg.setScissor(self.ctx, x, y, w, h)
        return self

    def global_alpha(self, a):
        vg.setGlobalAlpha(self.ctx, a)
        return self

    # text
    def create_font(self, name, data):
        return vg.createFont(self.ctx, name, data, len(data), 0)

    def text(self, font, size, align, color, x, y, s):
        cfg = vg.makeTextConfig(self.ctx, font, size, align, color)
        vg.text(self.ctx, cfg, x, y, s)
        return self
