# Frozen copy of vgtpu_torch/fonts/truetype.py for the benchmark's plain reference: the
# port's host semantics as of the benchmark's first version, importing
# nothing of the program, so a later change to the port cannot move the
# yardstick.
"""TrueType font loading + glyph rasterization (replaces stb_truetype,
SURVEY.md §2 #9).

Parsing is fonts/sfnt.py's (struct + numpy over the font's bytes, the
outlines fontTools' RecordingPen records, so no font library is needed);
rasterization is OUR engine: glyph quadratic outlines are flattened with the same Wang-formula
machinery as paths and rasterized with the same exact analytic winding
coverage as the main pipeline (numpy port of ops/coverage.py) — the engine
eats its own dog food for glyphs, like the reference feeding FontStash from
stb_truetype's raster.

Scale convention follows stb/FontStash: pixel scale = size / (ascent-descent)
(stbtt_ScaleForPixelHeight semantics, used via fons__tt_getPixelHeightScale).
"""

from __future__ import annotations

import numpy as np

from vgbench.reference.sfnt import SfntFont


def _edge_coverage_np(edges: np.ndarray, w: int, h: int) -> np.ndarray:
    """Exact analytic box-filter winding coverage, NonZero |w| clamp.
    Same formula as vgtpu_torch.ops.coverage._edge_contribution, dense numpy."""
    if len(edges) == 0:
        return np.zeros((h, w), np.float32)
    px = np.arange(w, dtype=np.float64)[None, :, None]
    py = np.arange(h, dtype=np.float64)[:, None, None]
    x0, y0, x1, y1 = (edges[:, i].astype(np.float64) for i in range(4))
    keep = np.abs(y1 - y0) > 1e-12
    x0, y0, x1, y1 = x0[keep], y0[keep], x1[keep], y1[keep]
    if len(x0) == 0:
        return np.zeros((h, w), np.float32)

    ymin = np.minimum(y0, y1)
    ymax = np.maximum(y0, y1)
    ytop = np.maximum(ymin, py)
    ybot = np.minimum(ymax, py + 1.0)
    hh = np.maximum(ybot - ytop, 0.0)
    s = np.sign(y1 - y0)
    m = (x1 - x0) / (y1 - y0)
    xa = x0 + m * (ytop - y0)
    xb = x0 + m * (ybot - y0)
    u0 = (px + 1.0) - xa
    u1 = (px + 1.0) - xb

    def G(u):
        return np.where(u <= 0.0, 0.0, np.where(u >= 1.0, u - 0.5, 0.5 * u * u))

    du = u1 - u0
    near = np.abs(du) < 1e-6
    k = np.where(
        near,
        np.clip(0.5 * (u0 + u1), 0.0, 1.0),
        (G(u1) - G(u0)) / np.where(near, 1.0, du),
    )
    wnd = (s * hh * k).sum(axis=-1)
    return np.minimum(np.abs(wnd), 1.0).astype(np.float32)


class Font:
    """One loaded TrueType font, read by fonts/sfnt.py.  Glyphs are keyed
    by glyph id."""

    def __init__(self, name: str, data: bytes) -> None:
        self.name = name
        self.sfnt = SfntFont(data)
        self.units_per_em = self.sfnt.units_per_em
        self.ascent_u = self.sfnt.ascent
        self.descent_u = self.sfnt.descent      # negative
        self.line_gap_u = self.sfnt.line_gap
        self.cmap = self.sfnt.cmap              # codepoint -> glyph id

    # stb-style pixel-height scale: pixels per font unit for a given size
    def pixel_scale(self, size_px: float) -> float:
        return size_px / float(self.ascent_u - self.descent_u)

    def has_glyph(self, glyph: int) -> bool:
        return 0 <= glyph < self.sfnt.num_glyphs

    def gid_of(self, glyph: int) -> int:
        """The glyph id the atlas keys on: 0 for a cmap entry past the
        font's glyphs (which has no outline and no advance)."""
        return glyph if self.has_glyph(glyph) else 0

    def glyph_id(self, codepoint: int) -> int | None:
        return self.cmap.get(codepoint)

    def advance_u(self, glyph: int) -> float:
        return int(self.sfnt.advances[glyph]) if self.has_glyph(glyph) else 0.0

    def kern_u(self, g1: int, g2: int) -> float:
        """Kern-table pair adjustment in font units (the reference caches
        these aggressively, fontstash.h:397-484; a dict serves here)."""
        return float(self.sfnt.kern_pairs().get((g1, g2), 0.0))

    def outline_contours(self, glyph: int, scale_px: float = 1.0) -> list[np.ndarray]:
        """Flattened closed contours in FONT UNITS (y-up); flattening density
        targets ~0.5px error at `scale_px` pixels per font unit."""
        from vgbench.reference.path import PathBuilder

        if not self.has_glyph(glyph):
            return []
        pb = PathBuilder()
        pb.reset(scale=scale_px, tess_tol=0.25)
        cur = (0.0, 0.0)
        for op, args in self.sfnt.draw(glyph):
            if op == "moveTo":
                cur = args[0]
                pb.move_to(*cur)
            elif op == "lineTo":
                cur = args[0]
                pb.line_to(*cur)
            elif op == "qCurveTo":
                # TrueType: run of off-curve points with implied on-curve
                # midpoints; final point on-curve (may be None = closed blob)
                pts = list(args)
                if pts[-1] is None:
                    pts[-1] = cur
                prev_off = None
                for q in pts[:-1]:
                    if prev_off is not None:
                        mid = ((prev_off[0] + q[0]) / 2, (prev_off[1] + q[1]) / 2)
                        pb.quadratic_to(*prev_off, *mid)
                    prev_off = q
                if prev_off is not None:
                    pb.quadratic_to(*prev_off, *pts[-1])
                else:
                    pb.line_to(*pts[-1])
                cur = pts[-1]
            elif op == "closePath":
                pb.close()
            # a composite glyph's addComponent events draw nothing, as in
            # vgtpu (its RecordingPen gets the same events from fontTools)
        verts, subs = pb.bake()
        return [verts[f : f + c] for f, c, _cl in subs if c >= 3]

    def rasterize(self, glyph: int, size_px: float, pad: int = 1):
        """Rasterize a glyph at pixel size; returns (bitmap u8 (h,w),
        x0, y0, w, h, advance_px) where (x0,y0) is the bitmap's top-left
        offset from the pen position (y-down screen convention)."""
        s = self.pixel_scale(size_px)
        contours = self.outline_contours(glyph, scale_px=s)
        adv = self.advance_u(glyph) * s
        if not contours:
            return None, 0, 0, 0, 0, adv

        # font units (y-up) -> pixels (y-down)
        pts = np.concatenate(contours, axis=0)
        xs = pts[:, 0] * s
        ys = -pts[:, 1] * s
        x0 = int(np.floor(xs.min())) - pad
        y0 = int(np.floor(ys.min())) - pad
        x1 = int(np.ceil(xs.max())) + pad
        y1 = int(np.ceil(ys.max())) + pad
        w, h = x1 - x0, y1 - y0
        if w <= 0 or h <= 0 or w > 4096 or h > 4096:
            return None, 0, 0, 0, 0, adv

        segs = []
        for c in contours:
            p = np.stack([c[:, 0] * s - x0, -c[:, 1] * s - y0], axis=1)
            nxt = np.roll(p, -1, axis=0)
            segs.append(np.concatenate([p, nxt], axis=1))
        edges = np.concatenate(segs, axis=0)
        cov = _edge_coverage_np(edges, w, h)
        bitmap = (cov * 255.0 + 0.5).astype(np.uint8)
        return bitmap, x0, y0, w, h, adv
