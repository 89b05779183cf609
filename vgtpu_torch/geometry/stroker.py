# Copied from vgtpu/geometry/stroker.py: the jax-free host half of the PyTorch port.
"""Stroke expansion: polyline -> closed outline polygons (reference: src/stroker.cpp).

The reference instantiates 27 templates over {closed} x {butt,round,square} x
{miter,round,bevel} and walks joints sequentially emitting triangle strips
(polylineStroke, stroker.cpp:1008-1388).  Here a stroke becomes a *closed
outline polygon* fed to the winding-coverage rasterizer (NonZero |w| clamp), and
all joints are computed at once with masked numpy lanes — the same math is
portable to jnp/Pallas.

Geometry parity with the reference:
  - extrusion vector v = (d01 - d12)/cross(d12,d01), fallback perpCCW(d01) when
    |cross| <= 1/100 (calcExtrusionVector, stroker.cpp:41-53);
  - miter join: p +- v*hsw on both sides (stroker.cpp:1105-1135);
  - inner corner: single extrusion point p + s*v*hsw (stroker.cpp:1099);
  - bevel/round join: outer fan from perp(d01) to perp(d12), round-arc density
    da = 2*acos(scale*hsw/(scale*hsw+tol)) (stroker.cpp:1012-1014);
  - caps: butt = perp offsets, square = offsets shifted by -+d*hsw, round =
    half-circle fan of numPointsHalfCircle points (stroker.cpp:1032-1100).

Outline self-overlap at tight joins yields winding |w|>=1 regions — the
NonZero-|clamp| fill rule keeps them solid, so no special-casing is needed
(the reference's overlapping join triangles behave the same way).

Padding: every joint emits exactly K points per side (repeats of the last
point); zero-length edges contribute exactly zero coverage and are dropped at
binning, so no masks are threaded through the pipeline.
"""

from __future__ import annotations

import math

import numpy as np

from vgtpu_torch.core import LineCap, LineJoin

_EPS = 1e-12


def _normalize(d: np.ndarray) -> np.ndarray:
    """Row-wise normalize with the reference's epsilon guard (vec2Dir,
    stroker.cpp:31-39): near-zero vectors become exactly zero."""
    len_sqr = d[:, 0] ** 2 + d[:, 1] ** 2
    inv = np.where(len_sqr < 1e-5, 0.0, 1.0 / np.sqrt(np.maximum(len_sqr, _EPS)))
    return d * inv[:, None]


def _perp_ccw(d: np.ndarray) -> np.ndarray:
    """(x,y) -> (-y,x), the reference's vec2PerpCCW ('left' side in y-down)."""
    return np.stack([-d[:, 1], d[:, 0]], axis=1)


def stroke_outline(
    pts: np.ndarray,
    closed: bool,
    stroke_width: float,
    line_cap: int,
    line_join: int,
    scale: float = 1.0,
    tol: float = 0.25,
    backend: str = "auto",
) -> list[np.ndarray]:
    """Expand a polyline into closed outline contour(s).

    pts: (N,2) float32 screen-space polyline (N>=2).
    Returns a list of (M,2) float32 closed polygons (open path -> 1 contour;
    closed path -> 2 nested contours, matching the reference's two strips).

    backend='auto' uses the native C++ engine when built (coverage-identical,
    validated in tests/test_native.py); this numpy body is the oracle.
    """
    if backend == "auto" and len(pts) >= 2:
        from vgtpu_torch import native

        res = native.stroke_outline_native(
            pts, closed, stroke_width, line_cap, line_join, scale, tol
        )
        if res is not None:
            return _normalize_orientation([c.astype(np.float32) for c in res])
    pts = np.asarray(pts, dtype=np.float64)
    n = len(pts)
    if n < 2:
        return []
    hsw = stroke_width * 0.5

    # round-join/cap density law (stroker.cpp:1012-1014)
    sr = scale * max(hsw, 1e-6)
    da = 2.0 * math.acos(max(-1.0, min(1.0, sr / (sr + tol))))
    n_half_circle = max(2, int(math.ceil(math.pi / da)))

    if closed:
        nxt = np.empty_like(pts)
        nxt[:-1] = pts[1:]
        nxt[-1] = pts[0]
        d = _normalize(nxt - pts)                            # d[i] = dir(p[i]->p[i+1])
        d01 = np.empty_like(d)                               # incoming dir at joint i
        d01[0] = d[-1]
        d01[1:] = d[:-1]
        d12 = d                                              # outgoing dir at joint i
        side_a = _joint_points(pts, d01, d12, hsw, line_join, da, +1.0)
        side_b = _joint_points(pts, d01, d12, hsw, line_join, da, -1.0)
        return _normalize_orientation([
            side_a.reshape(-1, 2).astype(np.float32),
            side_b.reshape(-1, 2)[::-1].astype(np.float32),
        ])

    # open path
    d = _normalize(pts[1:] - pts[:-1])                       # (n-1,2)
    parts_fwd: list[np.ndarray] = []
    parts_bwd: list[np.ndarray] = []   # collected in forward order, reversed later

    la0 = _perp_ccw(d[:1])[0]          # left perp at start
    la1 = _perp_ccw(d[-1:])[0]         # left perp at end

    # start endpoint offsets (square shifts along -d: stroker.cpp:1066-1076)
    shift0 = -d[0] * hsw if line_cap == LineCap.Square else 0.0
    parts_fwd.append((pts[0] + la0 * hsw + shift0)[None, :])
    parts_bwd.append((pts[0] - la0 * hsw + shift0)[None, :])

    if n > 2:
        d01 = d[:-1]
        d12 = d[1:]
        joints = pts[1:-1]
        parts_fwd.append(_joint_points(joints, d01, d12, hsw, line_join, da, +1.0).reshape(-1, 2))
        parts_bwd.append(_joint_points(joints, d01, d12, hsw, line_join, da, -1.0).reshape(-1, 2))

    shift1 = d[-1] * hsw if line_cap == LineCap.Square else 0.0
    a_end = pts[-1] + la1 * hsw + shift1
    b_end = pts[-1] - la1 * hsw + shift1
    parts_fwd.append(a_end[None, :])
    parts_bwd.append(b_end[None, :])

    # end cap: A -> B around +d (angle decreasing by pi; see module docstring)
    end_cap = np.zeros((0, 2))
    if line_cap == LineCap.Round:
        m = n_half_circle
        a0 = math.atan2(la1[1], la1[0])
        ang = a0 - np.arange(1, m - 1) * (math.pi / (m - 1))
        end_cap = pts[-1] + hsw * np.stack([np.cos(ang), np.sin(ang)], axis=1)

    # start cap: B -> A around -d (contour direction; reference fan reversed)
    start_cap = np.zeros((0, 2))
    if line_cap == LineCap.Round:
        m = n_half_circle
        a0 = math.atan2(la0[1], la0[0])
        ang = a0 + (m - 1 - np.arange(1, m - 1)) * (math.pi / (m - 1))
        start_cap = pts[0] + hsw * np.stack([np.cos(ang), np.sin(ang)], axis=1)

    contour = np.concatenate(
        parts_fwd + [end_cap] + [p[::-1] for p in reversed(parts_bwd)] + [start_cap],
        axis=0,
    )
    return _normalize_orientation([contour.astype(np.float32)])


def signed_area(c: np.ndarray) -> float:
    """Shoelace signed area of a closed polygon (y-down: CW on screen > 0)."""
    x, y = c[:, 0], c[:, 1]
    return 0.5 * float(np.dot(x[:-1], y[1:]) - np.dot(x[1:], y[:-1])
                       + x[-1] * y[0] - x[0] * y[-1])


def _normalize_orientation(contours: list[np.ndarray]) -> list[np.ndarray]:
    """Canonical winding so that identically-painted opaque draws can merge
    into one op without cancellation (see Context._emit): the largest contour
    winds positive, all others keep their sign relative to it (preserving
    ring holes of closed strokes)."""
    if not contours:
        return contours
    areas = [signed_area(c) for c in contours]
    dominant = max(range(len(contours)), key=lambda i: abs(areas[i]))
    if areas[dominant] < 0.0:
        contours = [c[::-1].copy() for c in contours]
    return contours


def _joint_points(
    p: np.ndarray,
    d01: np.ndarray,
    d12: np.ndarray,
    hsw: float,
    line_join: int,
    da: float,
    side: float,
) -> np.ndarray:
    """Per-joint outline points for one side, padded to a fixed K per joint.

    p, d01, d12: (J,2).  side: +1 = 'A' (perpCCW), -1 = 'B'.
    Returns (J, K, 2).
    """
    j = len(p)
    cross = d12[:, 0] * d01[:, 1] - d12[:, 1] * d01[:, 0]   # vec2Cross(d12, d01)
    perp01 = _perp_ccw(d01)
    perp12 = _perp_ccw(d12)
    # extrusion vector with the reference's 1/100 degeneracy clamp
    safe_cross = np.where(np.abs(cross) > 0.01, cross, 1.0)
    v = np.where(
        (np.abs(cross) > 0.01)[:, None],
        (d01 - d12) / safe_cross[:, None],
        perp01,
    )
    extr = p + side * v * hsw                                 # miter / inner-corner point

    # inner-corner test (stroker.cpp:1096-1099): left inner iff d12.(v*hsw) >= 0
    left_inner = (d12[:, 0] * v[:, 0] + d12[:, 1] * v[:, 1]) >= 0.0
    is_inner = left_inner if side > 0 else ~left_inner

    if line_join == LineJoin.Miter:
        return extr[:, None, :]

    # bevel/round: outer joints fan from side-perp(d01) to side-perp(d12)
    l0 = side * perp01
    l1 = side * perp12
    a0 = np.arctan2(l0[:, 1], l0[:, 0])
    a1 = np.arctan2(l1[:, 1], l1[:, 0])
    delta = np.mod(a1 - a0 + math.pi, 2.0 * math.pi) - math.pi  # signed short way

    if line_join == LineJoin.Bevel:
        n_arc = np.ones(j, dtype=np.int64)
    else:
        n_arc = np.maximum(2, (np.abs(delta) / da).astype(np.int64))
        n_arc = np.minimum(n_arc, 64)
    k = int(n_arc.max()) + 1 if j else 1

    t = np.minimum(np.arange(k)[None, :], n_arc[:, None]) / n_arc[:, None]
    ang = a0[:, None] + delta[:, None] * t
    fan = p[:, None, :] + hsw * np.stack([np.cos(ang), np.sin(ang)], axis=2)

    out = np.where(is_inner[:, None, None], extr[:, None, :], fan)
    return out


def contours_to_edges(contours: list[np.ndarray]) -> np.ndarray:
    """Closed polygon list -> (E,4) f32 edge segments [x0,y0,x1,y1]."""
    segs = []
    for c in contours:
        if len(c) < 2:
            continue
        e = np.empty((len(c), 4), np.float32)
        e[:, 0:2] = c
        e[:-1, 2:4] = c[1:]
        e[-1, 2:4] = c[0]
        segs.append(e)
    if not segs:
        return np.zeros((0, 4), np.float32)
    return np.concatenate(segs, axis=0).astype(np.float32)


def polyline_to_fill_edges(pts: np.ndarray, normalize: bool = False) -> np.ndarray:
    """Subpath polyline -> closed-contour edges for filling (implicit close,
    like the reference's fill paths which treat every subpath as a loop).
    normalize=True flips negative-area loops so same-paint fills can merge."""
    if len(pts) < 3:
        return np.zeros((0, 4), np.float32)
    if normalize and signed_area(np.asarray(pts, np.float64)) < 0.0:
        pts = pts[::-1]
    e = np.empty((len(pts), 4), np.float32)
    e[:, 0:2] = pts
    e[:-1, 2:4] = pts[1:]
    e[-1, 2:4] = pts[0]
    return e
