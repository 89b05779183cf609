# Copied from vgtpu/fonts/truetype.py: the jax-free host half of the PyTorch port.
"""TrueType font loading + glyph rasterization (replaces stb_truetype,
SURVEY.md §2 #9).

Parsing is delegated to fontTools (a stock library); rasterization is OUR
engine: glyph quadratic outlines are flattened with the same Wang-formula
machinery as paths and rasterized with the same exact analytic winding
coverage as the main pipeline (numpy port of ops/coverage.py) — the engine
eats its own dog food for glyphs, like the reference feeding FontStash from
stb_truetype's raster.

Scale convention follows stb/FontStash: pixel scale = size / (ascent-descent)
(stbtt_ScaleForPixelHeight semantics, used via fons__tt_getPixelHeightScale).
"""

from __future__ import annotations

import io

import numpy as np


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
    """One loaded TrueType font."""

    def __init__(self, name: str, data: bytes) -> None:
        from fontTools.ttLib import TTFont

        self.name = name
        self.ttf = TTFont(io.BytesIO(data), fontNumber=0, lazy=True)
        head = self.ttf["head"]
        hhea = self.ttf["hhea"]
        self.units_per_em = head.unitsPerEm
        self.ascent_u = hhea.ascent
        self.descent_u = hhea.descent          # negative
        self.line_gap_u = hhea.lineGap
        self.cmap = self.ttf.getBestCmap()
        self.glyph_order = self.ttf.getGlyphOrder()
        self._gid_of = {name: i for i, name in enumerate(self.glyph_order)}
        self.hmtx = self.ttf["hmtx"]
        self.glyf = self.ttf["glyf"] if "glyf" in self.ttf else None
        self._kern = None
        self._gid_cache: dict[int, str] = {}
        self._kern_cache: dict[tuple[str, str], float] = {}

    # stb-style pixel-height scale: pixels per font unit for a given size
    def pixel_scale(self, size_px: float) -> float:
        return size_px / float(self.ascent_u - self.descent_u)

    def gid_of(self, glyph_name: str) -> int:
        return self._gid_of.get(glyph_name, 0)

    def glyph_name(self, codepoint: int) -> str | None:
        g = self._gid_cache.get(codepoint)
        if g is None:
            g = self.cmap.get(codepoint)
            self._gid_cache[codepoint] = g
        return g

    def advance_u(self, glyph_name: str) -> float:
        try:
            return self.hmtx[glyph_name][0]
        except KeyError:
            return 0.0

    def kern_u(self, g1: str, g2: str) -> float:
        """Kern-table pair adjustment in font units (the reference caches
        these aggressively, fontstash.h:397-484; a dict serves here)."""
        key = (g1, g2)
        v = self._kern_cache.get(key)
        if v is not None:
            return v
        if self._kern is None:
            self._kern = {}
            if "kern" in self.ttf:
                for sub in self.ttf["kern"].kernTables:
                    if getattr(sub, "format", None) == 0:
                        self._kern.update(sub.kernTable)
        v = float(self._kern.get(key, 0.0))
        self._kern_cache[key] = v
        return v

    def outline_contours(self, glyph_name: str, scale_px: float = 1.0) -> list[np.ndarray]:
        """Flattened closed contours in FONT UNITS (y-up); flattening density
        targets ~0.5px error at `scale_px` pixels per font unit."""
        from fontTools.pens.recordingPen import RecordingPen

        from vgtpu_torch.geometry.path import PathBuilder

        glyph_set = self.ttf.getGlyphSet()
        if glyph_name not in glyph_set:
            return []
        pen = RecordingPen()
        glyph_set[glyph_name].draw(pen)

        pb = PathBuilder()
        pb.reset(scale=scale_px, tess_tol=0.25)
        cur = (0.0, 0.0)
        for op, args in pen.value:
            if op == "moveTo":
                cur = args[0]
                pb.move_to(*cur)
            elif op == "lineTo":
                cur = args[0]
                pb.line_to(*cur)
            elif op == "curveTo":
                c1, c2, p = args
                pb.cubic_to(*c1, *c2, *p)
                cur = p
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
        verts, subs = pb.bake()
        return [verts[f : f + c] for f, c, _cl in subs if c >= 3]

    def rasterize(self, glyph_name: str, size_px: float, pad: int = 1):
        """Rasterize a glyph at pixel size; returns (bitmap u8 (h,w),
        x0, y0, w, h, advance_px) where (x0,y0) is the bitmap's top-left
        offset from the pen position (y-down screen convention)."""
        s = self.pixel_scale(size_px)
        contours = self.outline_contours(glyph_name, scale_px=s)
        adv = self.advance_u(glyph_name) * s
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
