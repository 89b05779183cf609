# Frozen copy of vgtpu_torch/scenes/demo_ui.py for the benchmark's plain reference: the
# port's host semantics as of the benchmark's first version, importing
# nothing of the program, so a later change to the port cannot move the
# yardstick.
"""Benchmark scene B: demo UI at 1080p — panels, gradients, clip, text, a
color wheel (indexed tri-list), sliders, graph strokes.  Mirrors the feature
coverage of the reference's demo/DLS screenshots (README.md:51-67) and
BASELINE.json config #5."""

from __future__ import annotations

import math

import numpy as np

from vgbench.reference import vg


def _font(ctx):
    """UI font handle, cached on the context.  The font's bytes are the
    ones the harness hands to both sides (ctx.ui_font_data: DejaVu Sans,
    read from the file the configuration names and checked against its
    SHA-256)."""
    handle = getattr(ctx, "_demo_ui_font", None)
    if handle is not None:
        return handle
    data = ctx.ui_font_data
    ctx._demo_ui_font = vg.createFont(ctx, "ui-sans", data, len(data), 0)
    return ctx._demo_ui_font


def draw_window(ctx, title, x, y, w, h):
    corner = 4.0
    # panel
    vg.beginPath(ctx)
    vg.roundedRect(ctx, x, y, w, h, corner)
    vg.fillPath(ctx, vg.color4ub(28, 30, 34, 230), vg.FillFlags.ConvexAA)
    # drop-shadow-ish ring via box gradient stroke
    sh = vg.createBoxGradient(ctx, x, y + 2, w, h, corner * 2, 10,
                              vg.color4ub(0, 0, 0, 128), vg.color4ub(0, 0, 0, 0))
    vg.beginPath(ctx)
    vg.rect(ctx, x - 10, y - 10, w + 20, h + 30)
    vg.roundedRect(ctx, x, y, w, h, corner)
    vg.fillPath(ctx, sh, vg.FillFlags.ConcaveEvenOddAA)
    # header
    hg = vg.createLinearGradient(ctx, x, y, x, y + 15,
                                 vg.color4ub(255, 255, 255, 18), vg.color4ub(0, 0, 0, 30))
    vg.beginPath(ctx)
    vg.roundedRect(ctx, x + 1, y + 1, w - 2, 30, corner - 1)
    vg.fillPath(ctx, hg, vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.moveTo(ctx, x + 0.5, y + 0.5 + 30)
    vg.lineTo(ctx, x + 0.5 + w - 1, y + 0.5 + 30)
    vg.strokePath(ctx, vg.color4ub(0, 0, 0, 60), 1.0, vg.StrokeFlags.ButtMiterAA)
    cfg = vg.makeTextConfig(ctx, _font(ctx), 16.0, vg.TextAlign.MiddleCenter,
                            vg.color4ub(220, 220, 220, 200))
    vg.text(ctx, cfg, x + w / 2, y + 16, title)


def draw_button(ctx, label, x, y, w, h, color):
    bg = vg.createLinearGradient(ctx, x, y, x, y + h,
                                 vg.color4ub(255, 255, 255, 40), vg.color4ub(0, 0, 0, 40))
    vg.beginPath(ctx)
    vg.roundedRect(ctx, x + 1, y + 1, w - 2, h - 2, 4)
    if (color >> 24) & 0xFF:
        vg.fillPath(ctx, color, vg.FillFlags.ConvexAA)
    vg.fillPath(ctx, bg, vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.roundedRect(ctx, x + 0.5, y + 0.5, w - 1, h - 1, 4.5)
    vg.strokePath(ctx, vg.color4ub(0, 0, 0, 120), 1.0, vg.StrokeFlags.ButtMiterAA)
    cfg = vg.makeTextConfig(ctx, _font(ctx), 15.0, vg.TextAlign.MiddleCenter,
                            vg.color4ub(255, 255, 255, 200))
    vg.text(ctx, cfg, x + w / 2, y + h / 2, label)


def draw_slider(ctx, pos, x, y, w, h):
    cy = y + h * 0.5
    # slot
    bg = vg.createBoxGradient(ctx, x, cy - 2, w, 4, 2, 2,
                              vg.color4ub(0, 0, 0, 32), vg.color4ub(0, 0, 0, 128))
    vg.beginPath(ctx)
    vg.roundedRect(ctx, x, cy - 2, w, 4, 2)
    vg.fillPath(ctx, bg, vg.FillFlags.ConvexAA)
    # knob
    kx = x + pos * w
    vg.beginPath(ctx)
    vg.circle(ctx, kx, cy, h * 0.25)
    vg.fillPath(ctx, vg.color4ub(40, 43, 48, 255), vg.FillFlags.ConvexAA)
    vg.strokePath(ctx, vg.color4ub(0, 0, 0, 92), 1.0, vg.StrokeFlags.ButtMiterAA)


def draw_color_wheel(ctx, cx, cy, r_out, r_in, segments=48):
    """Indexed tri-list color wheel (BASELINE config #5 'indexed tri lists')."""
    pos = []
    cols = []
    idx = []
    for i in range(segments + 1):
        a = i / segments * 2 * math.pi
        for r in (r_in, r_out):
            pos.append((cx + r * math.cos(a), cy + r * math.sin(a)))
        cols.extend([vg.colorHSB(i / segments, 0.9 if r_in else 1.0, 0.9)] * 2)
    for i in range(segments):
        b = i * 2
        idx.extend([b, b + 1, b + 3, b, b + 3, b + 2])
    vg.indexedTriList(
        ctx,
        np.array(pos, np.float32),
        None,
        len(pos),
        np.array(cols, np.uint32),
        len(cols),
        np.array(idx, np.uint16),
        len(idx),
        None,
    )
    # rims
    for r in (r_in - 0.5, r_out + 0.5):
        vg.beginPath(ctx)
        vg.circle(ctx, cx, cy, r)
        vg.strokePath(ctx, vg.color4ub(0, 0, 0, 64), 1.0, vg.StrokeFlags.ButtMiterAA)


def draw_graph(ctx, x, y, w, h, t):
    n = 100
    xs = x + np.arange(n) / (n - 1) * w
    ys = y + h * (0.5 + 0.35 * np.sin(np.arange(n) * 0.15 + t)
                  + 0.1 * np.sin(np.arange(n) * 0.47 + t * 1.7))
    grad = vg.createLinearGradient(ctx, x, y, x, y + h,
                                   vg.color4ub(0, 160, 192, 0), vg.color4ub(0, 160, 192, 64))
    vg.beginPath(ctx)
    vg.moveTo(ctx, xs[0], ys[0])
    for i in range(1, n):
        vg.lineTo(ctx, xs[i], ys[i])
    vg.lineTo(ctx, x + w, y + h)
    vg.lineTo(ctx, x, y + h)
    vg.closePath(ctx)
    vg.fillPath(ctx, grad, vg.FillFlags.ConcaveNonZeroAA)
    vg.beginPath(ctx)
    vg.moveTo(ctx, xs[0], ys[0])
    for i in range(1, n):
        vg.lineTo(ctx, xs[i], ys[i])
    vg.strokePath(ctx, vg.color4ub(0, 160, 192, 255), 3.0, vg.StrokeFlags.RoundRoundAA)


def draw_clipped_pattern(ctx, x, y, w, h, t):
    """Clip in/out exercise (BASELINE config #5 'clip in/out stencil')."""
    vg.beginClip(ctx, vg.ClipRule.In)
    vg.beginPath(ctx)
    vg.circle(ctx, x + w / 2, y + h / 2, min(w, h) * 0.48)
    vg.fillPath(ctx, vg.Colors.Black, vg.FillFlags.Convex)
    vg.endClip(ctx)
    for i in range(10):
        vg.beginPath(ctx)
        vg.rect(ctx, x + i * w / 10, y, w / 20, h)
        vg.fillPath(ctx, vg.colorHSB(i / 10 + t * 0.05, 0.7, 0.9), vg.FillFlags.ConvexAA)
    vg.resetClip(ctx)


def draw_demo_ui(ctx, t: float = 0.0, x0: float = 980.0, y0: float = 40.0) -> None:
    """The UI half of the benchmark frame."""
    draw_window(ctx, "Widgets & Layout", x0, y0, 420, 840)
    yy = y0 + 50
    for i, label in enumerate(["Login", "Delete", "Cancel", "Apply"]):
        col = [
            vg.color4ub(0, 96, 128, 255),
            vg.color4ub(128, 16, 8, 255),
            vg.color4ub(0, 0, 0, 0),
            vg.color4ub(16, 128, 64, 255),
        ][i]
        draw_button(ctx, label, x0 + 20 + (i % 2) * 200, yy + (i // 2) * 44, 180, 34, col)
    yy += 100
    for i in range(4):
        draw_slider(ctx, (math.sin(t + i) + 1) / 2, x0 + 20, yy + i * 30, 380, 24)
    yy += 140
    draw_color_wheel(ctx, x0 + 210, yy + 130, 120, 80)
    yy += 280
    draw_graph(ctx, x0 + 20, yy, 380, 100, t)
    yy += 120
    draw_clipped_pattern(ctx, x0 + 20, yy, 380, 80, t)

    cfg = vg.makeTextConfig(ctx, _font(ctx), 13.0, vg.TextAlign.TopLeft,
                            vg.color4ub(200, 200, 200, 160))
    vg.textBox(
        ctx, cfg, x0 + 20, y0 + 790,
        380.0,
        "The quick brown fox jumps over the lazy dog while the renderer "
        "wraps, kerns and caches every glyph.",
        None, 0,
    )


def draw_benchmark_frame(ctx, t: float = 0.0) -> None:
    """SVG tiger + demo UI @1080p — the north-star frame (BASELINE.json)."""
    from vgbench.reference.tiger import draw_tiger

    draw_tiger(ctx, 20, 60, 1.06)
    draw_demo_ui(ctx, t)
