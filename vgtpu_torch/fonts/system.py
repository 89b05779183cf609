# Copied from vgtpu/fonts/system.py: the jax-free host half of the PyTorch port.
"""Text engine: string baking, layout, measurement, drawing.

Reference call path: ctxText (vg.cpp:4177-4232) -> FONSstring bake
(fontstash.h:2365) -> renderTextQuads (vg.cpp:5541).  Parity behaviors:
  - glyphs bake at size*fontScale*dpr with the state's 0.1-quantized font
    scale (updateState, vg.cpp:4937-4943);
  - strings smaller than 4px on screen are culled (VG_CONFIG_MIN_FONT_SIZE,
    vg.cpp:4184);
  - quads snap to the integer pixel grid at baked scale (the JD fontstash
    snapping mod, fontstash.h:2403-2461);
  - baked strings cache against the atlas generation (FONSstring atlasID);
  - kern adjustments and fallback-font lookups per glyph
    (fontstash.h:2274-2286).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from vgtpu_torch.core import ImageFlags, TextAlign, color_to_rgba_f32, colorGetAlpha, colorSetAlpha
from vgtpu_torch.raster.binning import P_TEXTURE, RasterOp, make_solid_paint
from vgtpu_torch.fonts.fontstash import ATLAS_IMAGE_ID, GlyphAtlas
from vgtpu_torch.fonts.truetype import Font


@dataclass
class BakedString:
    quads: np.ndarray       # (N,10): x0,y0,x1,y1 local px; u0,v0,u1,v1; gi; char index
    width: float            # total advance, baked px
    minx: float
    maxx: float
    n: int


class FontSystem:
    def __init__(self) -> None:
        self.fonts: list[Font] = []
        self.fallback: dict[int, int] = {}
        self.atlas = GlyphAtlas()
        self._string_cache: dict = {}

    # -- fonts --------------------------------------------------------------
    def add_font(self, name: str, data: bytes) -> int:
        self.fonts.append(Font(name, data))
        return len(self.fonts) - 1

    def set_fallback(self, base: int, fallback: int) -> bool:
        if base >= len(self.fonts) or fallback >= len(self.fonts):
            return False
        self.fallback[base] = fallback
        return True

    def _lookup_glyph(self, font_idx: int, cp: int):
        """Glyph + owning font, following the fallback chain."""
        seen = set()
        fi = font_idx
        while fi not in seen:
            seen.add(fi)
            f = self.fonts[fi]
            g = f.glyph_name(cp)
            if g is not None:
                return fi, f, g
            fi = self.fallback.get(fi, fi)
        f = self.fonts[font_idx]
        return font_idx, f, f.glyph_name(0xFFFD) or ".notdef"

    # -- metrics ------------------------------------------------------------
    def vert_metrics(self, font_idx: int, size_px: float):
        f = self.fonts[font_idx]
        s = f.pixel_scale(size_px)
        return f.ascent_u * s, f.descent_u * s, (f.ascent_u - f.descent_u + f.line_gap_u) * s

    # -- string baking ------------------------------------------------------
    def bake_string(self, font_idx: int, size_px: float, text: str) -> BakedString:
        size10 = int(size_px * 10 + 0.5)
        key = (font_idx, size10, text)
        hit = self._string_cache.get(key)
        if hit is not None and hit[0] == self.atlas.generation:
            return hit[1]

        if len(self._string_cache) > 4096:
            self._string_cache.clear()

        quads = np.zeros((len(text), 10), np.float32)
        n = 0
        pen = 0.0
        minx, maxx = 1e9, -1e9
        prev = None  # (font_idx, glyph_name, Font)
        S = float(self.atlas.size)
        for ci, ch in enumerate(text):
            cp = ord(ch)
            fi, f, g = self._lookup_glyph(font_idx, cp)
            if prev is not None and prev[0] == fi:
                pen += f.kern_u(prev[1], g) * f.pixel_scale(size_px)
            gid = f.gid_of(g) if isinstance(g, str) else g
            gi = self.atlas.get_or_bake(fi, f, g, gid, size_px)
            S = float(self.atlas.size)
            if gi is None:
                prev = (fi, g, f)
                continue
            if gi.w > 0:
                # snap-to-grid: integer pen position at baked scale
                px = float(np.round(pen))
                x0 = px + gi.xoff
                y0 = float(gi.yoff)
                quads[n, 0:8] = (
                    x0, y0, x0 + gi.w, y0 + gi.h,
                    gi.atlas_x / S, gi.atlas_y / S,
                    (gi.atlas_x + gi.w) / S, (gi.atlas_y + gi.h) / S,
                )
                quads[n, 8] = 0
                quads[n, 9] = ci
                n += 1
                minx = min(minx, x0)
                maxx = max(maxx, x0 + gi.w)
            pen += gi.advance
            prev = (fi, g, f)
        if n == 0:
            minx = maxx = 0.0
        baked = BakedString(quads[:n], pen, minx, maxx, n)
        self._string_cache[key] = (self.atlas.generation, baked)
        return baked

    def align_offsets(self, font_idx: int, size_px: float, width: float, alignment: int):
        """fonsAlignString (fontstash.h:2485-2508): returns (dx, dy) baked px."""
        asc, desc, _lh = self.vert_metrics(font_idx, size_px)
        dx = 0.0
        if alignment & TextAlign.Center:
            dx = -width * 0.5
        elif alignment & TextAlign.Right:
            dx = -width
        dy = 0.0
        if alignment & TextAlign.Top:
            dy = asc
        elif alignment & TextAlign.Middle:
            dy = (asc + desc) * 0.5
        elif alignment & TextAlign.Bottom:
            dy = desc
        return dx, dy

    def atlas_image_map(self) -> dict:
        return {ATLAS_IMAGE_ID: (self.atlas.bitmap, ImageFlags.Filter_Bilinear,
                                 self.atlas.revision)}

    def end_frame(self) -> None:
        """frame() housekeeping (reference GCs extra atlases keeping the
        biggest, vg.cpp:1290-1328): advances the atlas frame counter that
        drives last-use glyph eviction when a max-size atlas overflows."""
        self.atlas.end_frame()


# ---------------------------------------------------------------------------
# ctx-level operations
# ---------------------------------------------------------------------------

def _fs(ctx) -> FontSystem:
    if ctx.font_system is None:
        ctx.font_system = FontSystem()
    return ctx.font_system


def ctx_create_font(ctx, name: str, data: bytes, flags: int = 0):
    from vgtpu_torch.api.context import FontHandle

    fs = _fs(ctx)
    if len(fs.fonts) >= ctx.cfg.max_fonts:
        return FontHandle()
    idx = fs.add_font(name, bytes(data))
    ctx._font_by_name[name] = idx
    return FontHandle(idx=idx)


def ctx_set_fallback_font(ctx, base, fallback) -> bool:
    fs = _fs(ctx)
    return fs.set_fallback(base.idx, fallback.idx)


def _text_scale(ctx) -> float:
    return ctx.state.font_scale * ctx.dpr


def ctx_text(ctx, cfg, x: float, y: float, s: str) -> None:
    if not s:
        return
    fs = _fs(ctx)
    scale = _text_scale(ctx)
    scaled_size = cfg.font_size * scale
    if scaled_size < ctx.cfg.min_font_size:
        return

    col = colorSetAlpha(cfg.color, int(ctx.state.global_alpha * colorGetAlpha(cfg.color)))
    if colorGetAlpha(col) == 0:
        return

    baked = fs.bake_string(cfg.font.idx, scaled_size, s)
    if baked.n == 0:
        return
    dx, dy = fs.align_offsets(cfg.font.idx, scaled_size, baked.width, cfg.alignment)

    m = ctx._render_transform()
    inv = 1.0 / scale
    tx = x + dx * inv
    ty = y + dy * inv
    ox = m[0] * tx + m[2] * ty + m[4]
    oy = m[1] * tx + m[3] * ty + m[5]
    lin = np.array([m[0] * inv, m[1] * inv, m[2] * inv, m[3] * inv])

    q = baked.quads
    qw = q[:, 2] - q[:, 0]
    qh = q[:, 3] - q[:, 1]
    tq = np.zeros((baked.n, 12), np.float32)
    tq[:, 0] = ox + lin[0] * q[:, 0] + lin[2] * q[:, 1]
    tq[:, 1] = oy + lin[1] * q[:, 0] + lin[3] * q[:, 1]
    tq[:, 2] = lin[0] * qw
    tq[:, 3] = lin[1] * qw
    tq[:, 4] = lin[2] * qh
    tq[:, 5] = lin[3] * qh
    tq[:, 6:10] = q[:, 4:8]

    ctx._emit(
        RasterOp(
            paint_kind=P_TEXTURE,
            paint=make_solid_paint(color_to_rgba_f32(col)),
            scissor=ctx._op_scissor(),
            image_id=ATLAS_IMAGE_ID,
            tex_quads=tq,
        )
    )


def ctx_measure_text(ctx, cfg, x: float, y: float, s: str):
    """Returns (advance_width, bounds[minx,miny,maxx,maxy]) in local units
    (measureText wrapper around fonsTextBounds, vg.cpp:1780)."""
    fs = _fs(ctx)
    scale = _text_scale(ctx)
    scaled_size = cfg.font_size * scale
    inv = 1.0 / max(scale, 1e-9)
    if not s:
        return 0.0, np.array([x, y, x, y])
    baked = fs.bake_string(cfg.font.idx, scaled_size, s)
    dx, dy = fs.align_offsets(cfg.font.idx, scaled_size, baked.width, cfg.alignment)
    asc, desc, _ = fs.vert_metrics(cfg.font.idx, scaled_size)
    minx = x + (baked.minx + dx) * inv
    maxx = x + (baked.maxx + dx) * inv
    miny = y + (dy - asc) * inv
    maxy = y + (dy - desc) * inv
    return baked.width * inv, np.array([minx, miny, maxx, maxy])


def ctx_text_line_height(ctx, cfg) -> float:
    fs = _fs(ctx)
    scale = _text_scale(ctx)
    _asc, _desc, lh = fs.vert_metrics(cfg.font.idx, cfg.font_size * scale)
    return lh / max(scale, 1e-9)


def ctx_text_break_lines(ctx, cfg, s: str, break_width: float, max_rows: int, flags: int):
    """Word-wrap state machine (ctxTextBreakLines, vg.cpp:1894-2123):
    breaks at whitespace when the row exceeds break_width; hard breaks on
    \\n, \\r, \\r\\n, NEL(0x85); KeepSpaces keeps leading/trailing spaces."""
    from vgtpu_torch.api.context import TextRow
    from vgtpu_torch.core import TextBoxFlags

    fs = _fs(ctx)
    scale = _text_scale(ctx)
    scaled_size = cfg.font_size * scale
    inv = 1.0 / max(scale, 1e-9)
    keep_spaces = bool(flags & TextBoxFlags.KeepSpaces)

    rows: list[TextRow] = []
    i = 0
    n = len(s)

    def width_of(a: int, b: int) -> tuple[float, float, float]:
        if a >= b:
            return 0.0, 0.0, 0.0
        baked = fs.bake_string(cfg.font.idx, scaled_size, s[a:b])
        return baked.width * inv, baked.minx * inv, baked.maxx * inv

    while i < n and len(rows) < max_rows:
        # hard-break scan
        j = i
        while j < n and s[j] not in "\r\n\x85":
            j += 1
        line = s[i:j]
        nl_next = j
        if j < n:
            nl_next = j + (2 if s[j] == "\r" and j + 1 < n and s[j + 1] == "\n" else 1)

        # soft-wrap the line
        start = 0
        while start < len(line) and len(rows) < max_rows:
            if not keep_spaces:
                while start < len(line) and line[start] == " ":
                    start += 1
            if start >= len(line):
                if not rows or i + start >= nl_next - 1:
                    break
                break
            # grow until overflow
            end = start
            last_space = -1
            while end < len(line):
                cand = end + 1
                if line[end] == " ":
                    last_space = end
                w, _, _ = width_of(i + start, i + cand)
                if w > break_width and cand - start > 1:
                    break
                end = cand
            if end < len(line) and last_space > start:
                row_end = last_space
                next_start = last_space + 1
            else:
                row_end = end
                next_start = end
            text_end = row_end
            if not keep_spaces:
                while text_end > start and line[text_end - 1] == " ":
                    text_end -= 1
            w, mn, mx = width_of(i + start, i + text_end)
            rows.append(
                TextRow(start=i + start, end=i + text_end,
                        next=i + next_start if next_start < len(line) else nl_next,
                        width=w, minx=mn, maxx=mx)
            )
            start = next_start
        if start >= len(line):
            if len(line) == 0 and len(rows) < max_rows and (j < n):
                rows.append(TextRow(start=i, end=i, next=nl_next, width=0.0))
        i = nl_next
        if j >= n:
            break
    return rows


def ctx_text_box(ctx, cfg, x, y, break_width, s, flags) -> None:
    """ctxTextBox (vg.cpp:4234-4271): break + per-row ctx_text with the
    horizontal alignment applied against the box."""
    from vgtpu_torch.api.context import TextConfig

    rows = ctx_text_break_lines(ctx, cfg, s, break_width, 1 << 30, flags)
    lh = ctx_text_line_height(ctx, cfg)
    halign = cfg.alignment & (TextAlign.Left | TextAlign.Center | TextAlign.Right)
    row_cfg = TextConfig(cfg.font, cfg.font_size, halign | TextAlign.Baseline, cfg.color)
    asc, _desc, _ = _fs(ctx).vert_metrics(cfg.font.idx, cfg.font_size * _text_scale(ctx))
    cy = y + asc / max(_text_scale(ctx), 1e-9)
    for r in rows:
        if halign & TextAlign.Center:
            rx = x + break_width * 0.5
        elif halign & TextAlign.Right:
            rx = x + break_width
        else:
            rx = x
        ctx_text(ctx, row_cfg, rx, cy, s[r.start : r.end])
        cy += lh


def ctx_measure_text_box(ctx, cfg, x, y, break_width, s, flags):
    rows = ctx_text_break_lines(ctx, cfg, s, break_width, 1 << 30, flags)
    lh = ctx_text_line_height(ctx, cfg)
    maxw = max((r.width for r in rows), default=0.0)
    return np.array([x, y, x + maxw, y + lh * max(len(rows), 1)])


def ctx_text_glyph_positions(ctx, cfg, x, y, s: str, max_positions=None):
    """textGlyphPositions (vg.cpp:2125-2168)."""
    from vgtpu_torch.api.context import GlyphPosition

    fs = _fs(ctx)
    scale = _text_scale(ctx)
    scaled_size = cfg.font_size * scale
    inv = 1.0 / max(scale, 1e-9)
    out = []
    pen = 0.0
    prev = None
    for ci, ch in enumerate(s):
        if max_positions is not None and ci >= max_positions:
            break
        fi, f, g = fs._lookup_glyph(cfg.font.idx, ord(ch))
        if prev is not None and prev[0] == fi:
            pen += f.kern_u(prev[1], g) * f.pixel_scale(scaled_size)
        gid = f.gid_of(g)
        gi = fs.atlas.get_or_bake(fi, f, g, gid, scaled_size)
        adv = gi.advance if gi else 0.0
        out.append(
            GlyphPosition(
                index=ci,
                x=x + pen * inv,
                minx=x + (pen + (gi.xoff if gi else 0)) * inv,
                maxx=x + (pen + (gi.xoff if gi else 0) + (gi.w if gi else 0)) * inv,
            )
        )
        pen += adv
        prev = (fi, g, f)
    return out
