# Copied from vgtpu/scenes/tiger.py: the jax-free host half of the PyTorch port.
"""Benchmark scene A: a deterministic 'tiger-class' SVG artwork.

The canonical SVG tiger is not redistributable inside this repo, so the
benchmark generates a procedural artwork with the same structural statistics
as the Ghostscript tiger (~240 paths, ~2400 cubic segments, concave
multi-lobed fills, layered strokes, both fill rules) and feeds it through the
real SVG loader (scenes/svg.py) so the benchmarked path is identical to
loading tiger.svg from disk.  If a real tiger.svg exists at assets/tiger.svg
it is used instead.
"""

from __future__ import annotations

import math
import os

import numpy as np

from vgtpu_torch.scenes.svg import SvgDoc, load_svg

ASSET = os.path.join(os.path.dirname(__file__), "..", "..", "assets", "tiger.svg")


def _blob_path(rng, cx, cy, r_base, lobes) -> str:
    """Closed smooth loop of cubic beziers with per-lobe radius jitter."""
    n = lobes
    angs = np.linspace(0, 2 * math.pi, n, endpoint=False)
    radii = r_base * rng.uniform(0.55, 1.45, n)
    px = cx + radii * np.cos(angs)
    py = cy + radii * np.sin(angs)
    # catmull-rom-ish tangents -> cubic control points
    d = []
    for i in range(n):
        p0 = np.array([px[i], py[i]])
        p1 = np.array([px[(i + 1) % n], py[(i + 1) % n]])
        pm = np.array([px[(i - 1) % n], py[(i - 1) % n]])
        p2 = np.array([px[(i + 2) % n], py[(i + 2) % n]])
        t0 = (p1 - pm) / 6.0
        t1 = (p2 - p0) / 6.0
        c1 = p0 + t0
        c2 = p1 - t1
        if i == 0:
            d.append(f"M{p0[0]:.2f} {p0[1]:.2f}")
        d.append(f"C{c1[0]:.2f} {c1[1]:.2f} {c2[0]:.2f} {c2[1]:.2f} {p1[0]:.2f} {p1[1]:.2f}")
    d.append("Z")
    return "".join(d)


def _stripe_path(rng, x0, y0, length, waves) -> str:
    """Open wavy stroke path."""
    d = [f"M{x0:.2f} {y0:.2f}"]
    x, y = x0, y0
    for _ in range(waves):
        dx = length / waves
        c1 = (x + dx * 0.33, y + rng.uniform(-18, 18))
        c2 = (x + dx * 0.66, y + rng.uniform(-18, 18))
        x, y = x + dx, y + rng.uniform(-10, 10)
        d.append(f"C{c1[0]:.2f} {c1[1]:.2f} {c2[0]:.2f} {c2[1]:.2f} {x:.2f} {y:.2f}")
    return "".join(d)


def tiger_svg_text(seed: int = 20260816, n_paths: int = 240) -> str:
    """Deterministic artwork, ~tiger statistics, as SVG text."""
    rng = np.random.default_rng(seed)
    w, h = 900.0, 900.0
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{w:g}" height="{h:g}" viewBox="0 0 {w:g} {h:g}">']

    palette = [
        "#e8a33d", "#d97f28", "#c35b1c", "#8a3a12", "#f2c968",
        "#1a1a1a", "#2d2d2d", "#f7f3e8", "#b54a17", "#6b2e0e",
    ]
    n_blobs = int(n_paths * 0.72)
    n_stripes = n_paths - n_blobs
    for i in range(n_blobs):
        cx = rng.uniform(60, w - 60)
        cy = rng.uniform(60, h - 60)
        r = rng.uniform(18, 130) * (1.6 if i < 12 else 1.0)
        lobes = int(rng.integers(5, 14))
        d = _blob_path(rng, cx, cy, r, lobes)
        col = palette[int(rng.integers(0, len(palette)))]
        rule = "evenodd" if rng.uniform() < 0.12 else "nonzero"
        if rng.uniform() < 0.35:
            sw = rng.uniform(0.8, 4.0)
            parts.append(
                f'<path d="{d}" fill="{col}" fill-rule="{rule}" stroke="#1a1a1a" stroke-width="{sw:.2f}"/>'
            )
        else:
            parts.append(f'<path d="{d}" fill="{col}" fill-rule="{rule}"/>')
    for _ in range(n_stripes):
        x0 = rng.uniform(20, w - 260)
        y0 = rng.uniform(20, h - 40)
        d = _stripe_path(rng, x0, y0, rng.uniform(120, 320), int(rng.integers(3, 8)))
        sw = rng.uniform(1.5, 9.0)
        parts.append(f'<path d="{d}" fill="none" stroke="#1a1a1a" stroke-width="{sw:.2f}"/>')
    parts.append("</svg>")
    return "\n".join(parts)


_DOC_CACHE: dict = {}


def load_tiger() -> SvgDoc:
    """Parsed-document cache: the scene is static; regenerating + reparsing
    the SVG per frame would charge XML parsing to the render loop."""
    key = "tiger"
    if key not in _DOC_CACHE:
        if os.path.exists(ASSET):
            _DOC_CACHE[key] = load_svg(ASSET)
        else:
            _DOC_CACHE[key] = load_svg(tiger_svg_text())
    return _DOC_CACHE[key]


def draw_tiger(ctx, x: float, y: float, scale: float, aa: bool = True) -> None:
    import vgtpu_torch as vg
    from vgtpu_torch.scenes.svg import render_svg

    doc = load_tiger()
    vg.pushState(ctx)
    vg.transformTranslate(ctx, x, y)
    vg.transformScale(ctx, scale, scale)
    render_svg(ctx, doc, aa=aa)
    vg.popState(ctx)
