# Copied from vgtpu/api/standalone.py: the jax-free host half of the PyTorch port.
"""Standalone path + stroker APIs (include/vg/path.h:19-38,
include/vg/stroker.h:11-85): the reference exposes its geometry kernels as
renderer-independent free functions — the explicit unit-test seam (SURVEY §4).

TPU-native shape of the contract: this engine has no triangle meshes — the
stroker produces closed OUTLINE CONTOURS whose winding edges feed the analytic
coverage kernel, so `Mesh` here carries positions + contour table + (E,4)
winding edges.  `strokerConvexFill` additionally provides the reference's
index fan (trivially derivable and useful to consumers that do want
triangles); the AA variants return the same geometry as their non-AA
counterparts because AA is exact box-filtering in the raster, not fringe
geometry (PARITY.md "known deviations")."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from vgtpu_torch.geometry.path import PathBuilder
from vgtpu_torch.geometry.stroker import contours_to_edges, polyline_to_fill_edges, stroke_outline

__all__ = [
    "SubPath", "Mesh", "Stroker",
    "createPath", "destroyPath", "pathReset", "pathMoveTo", "pathLineTo",
    "pathCubicTo", "pathQuadraticTo", "pathArcTo", "pathRect",
    "pathRoundedRect", "pathRoundedRectVarying", "pathCircle", "pathEllipse",
    "pathArc", "pathPolyline", "pathClose", "pathGetVertices",
    "pathGetNumVertices", "pathGetSubPaths", "pathGetNumSubPaths",
    "createStroker", "destroyStroker", "strokerReset",
    "strokerPolylineStroke", "strokerPolylineStrokeAA",
    "strokerPolylineStrokeAAThin", "strokerConvexFill", "strokerConvexFillAA",
    "strokerConcaveFillBegin", "strokerConcaveFillAddContour",
    "strokerConcaveFillEnd", "strokerConcaveFillEndAA",
]


@dataclass
class SubPath:
    """path.h:11-16 field names."""

    m_FirstVertexID: int
    m_NumVertices: int
    m_IsClosed: bool


@dataclass
class Mesh:
    """Geometry currency of the standalone stroker (vg.h:353-360 analogue).
    pos/indices mirror the reference where triangles exist (convex fan);
    contours/edges are the TPU-native outline + winding-edge form."""

    pos: np.ndarray                         # (N,2) f32
    indices: np.ndarray | None = None       # (K,) u32 triangle list (fans)
    colors: np.ndarray | None = None        # (N,) u32 when a color was given
    contours: list = field(default_factory=list)   # [(M,2) f32 closed loops]
    edges: np.ndarray | None = None          # (E,4) f32 winding edges
    fill_rule: int = 0


# -- Path ---------------------------------------------------------------------

def createPath(allocator=None) -> PathBuilder:
    return PathBuilder()


def destroyPath(path: PathBuilder) -> None:
    path.reset(1.0, 0.25)


def pathReset(path, scale, tesselation_tolerance):
    path.reset(scale, tesselation_tolerance)


def pathMoveTo(path, x, y):
    path.move_to(x, y)


def pathLineTo(path, x, y):
    path.line_to(x, y)


def pathCubicTo(path, c1x, c1y, c2x, c2y, x, y):
    path.cubic_to(c1x, c1y, c2x, c2y, x, y)


def pathQuadraticTo(path, cx, cy, x, y):
    path.quadratic_to(cx, cy, x, y)


def pathArcTo(path, x1, y1, x2, y2, r):
    path.arc_to(x1, y1, x2, y2, r)


def pathRect(path, x, y, w, h):
    path.rect(x, y, w, h)


def pathRoundedRect(path, x, y, w, h, r):
    path.rounded_rect(x, y, w, h, r)


def pathRoundedRectVarying(path, x, y, w, h, rtl, rtr, rbr, rbl):
    path.rounded_rect_varying(x, y, w, h, rtl, rtr, rbr, rbl)


def pathCircle(path, x, y, r):
    path.circle(x, y, r)


def pathEllipse(path, x, y, rx, ry):
    path.ellipse(x, y, rx, ry)


def pathArc(path, x, y, r, a0, a1, direction):
    path.arc(x, y, r, a0, a1, direction)


def pathPolyline(path, coords, num_points=None):
    coords = np.asarray(coords, np.float32).reshape(-1, 2)
    if num_points is not None:
        coords = coords[:num_points]
    path.polyline(coords)


def pathClose(path):
    path.close()


def pathGetVertices(path) -> np.ndarray:
    return path.bake()[0]


def pathGetNumVertices(path) -> int:
    return int(len(path.bake()[0]))


def pathGetSubPaths(path) -> list[SubPath]:
    return [SubPath(int(f), int(c), bool(cl)) for f, c, cl in path.bake()[1]]


def pathGetNumSubPaths(path) -> int:
    return int(len(path.bake()[1]))


# -- Stroker ------------------------------------------------------------------

class Stroker:
    """stroker.cpp:159-174 state: scale, tolerance, fringe width."""

    def __init__(self) -> None:
        self.reset(1.0, 0.25, 1.0)

    def reset(self, scale: float, tol: float, fringe: float) -> None:
        self.scale = float(scale)
        self.tol = float(tol)
        self.fringe = float(fringe)
        self._contours: list[np.ndarray] = []


def createStroker(allocator=None) -> Stroker:
    return Stroker()


def destroyStroker(stroker: Stroker) -> None:
    stroker.reset(1.0, 0.25, 1.0)


def strokerReset(stroker, scale, tesselation_tolerance, fringe_width):
    stroker.reset(scale, tesselation_tolerance, fringe_width)


def _stroke_mesh(stroker, vertex_list, num_vertices, is_closed, width, cap, join,
                 color=None) -> Mesh:
    pts = np.asarray(vertex_list, np.float32).reshape(-1, 2)[: num_vertices or None]
    contours = stroke_outline(pts, bool(is_closed), float(width), int(cap),
                              int(join), scale=stroker.scale, tol=stroker.tol)
    pos = (np.concatenate(contours, axis=0) if contours
           else np.zeros((0, 2), np.float32))
    colors = (np.full(len(pos), np.uint32(color), np.uint32)
              if color is not None else None)
    return Mesh(pos=pos, colors=colors, contours=contours,
                edges=contours_to_edges(contours))


def strokerPolylineStroke(stroker, mesh_out, vertex_list, num_vertices,
                          is_closed, stroke_width, line_cap, line_join) -> Mesh:
    m = _stroke_mesh(stroker, vertex_list, num_vertices, is_closed,
                     stroke_width, line_cap, line_join)
    return _fill_out(mesh_out, m)


def strokerPolylineStrokeAA(stroker, mesh_out, vertex_list, num_vertices,
                            is_closed, color, stroke_width, line_cap,
                            line_join) -> Mesh:
    m = _stroke_mesh(stroker, vertex_list, num_vertices, is_closed,
                     stroke_width, line_cap, line_join, color=color)
    return _fill_out(mesh_out, m)


def strokerPolylineStrokeAAThin(stroker, mesh_out, vertex_list, num_vertices,
                                is_closed, color, line_cap, line_join) -> Mesh:
    """Thin strokes render at fringe width (the caller applies the alpha^2
    law, vg.cpp:3417-3420 — exactly like Context.strokePath does)."""
    m = _stroke_mesh(stroker, vertex_list, num_vertices, is_closed,
                     stroker.fringe, line_cap, line_join, color=color)
    return _fill_out(mesh_out, m)


def strokerConvexFill(stroker, mesh_out, vertex_list, num_vertices) -> Mesh:
    pts = np.asarray(vertex_list, np.float32).reshape(-1, 2)[: num_vertices or None]
    n = len(pts)
    if n >= 3:
        k = np.arange(1, n - 1, dtype=np.uint32)
        indices = np.stack([np.zeros(n - 2, np.uint32), k, k + 1], axis=1).reshape(-1)
    else:
        indices = np.zeros(0, np.uint32)
    m = Mesh(pos=pts, indices=indices, contours=[pts],
             edges=polyline_to_fill_edges(pts))
    return _fill_out(mesh_out, m)


def strokerConvexFillAA(stroker, mesh_out, vertex_list, num_vertices,
                        color) -> Mesh:
    m = strokerConvexFill(stroker, None, vertex_list, num_vertices)
    m.colors = np.full(len(m.pos), np.uint32(color), np.uint32)
    return _fill_out(mesh_out, m)


def strokerConcaveFillBegin(stroker) -> bool:
    stroker._contours = []
    return True


def strokerConcaveFillAddContour(stroker, vertex_list, num_vertices=None) -> None:
    pts = np.asarray(vertex_list, np.float32).reshape(-1, 2)
    if num_vertices is not None:
        pts = pts[:num_vertices]
    stroker._contours.append(pts)


def strokerConcaveFillEnd(stroker, mesh_out, fill_rule) -> Mesh | bool:
    parts = [polyline_to_fill_edges(c) for c in stroker._contours if len(c) >= 3]
    parts = [p for p in parts if len(p)]
    pos = (np.concatenate([c for c in stroker._contours if len(c) >= 3], axis=0)
           if parts else np.zeros((0, 2), np.float32))
    m = Mesh(pos=pos, contours=list(stroker._contours),
             edges=(np.concatenate(parts, axis=0) if parts
                    else np.zeros((0, 4), np.float32)),
             fill_rule=int(fill_rule))
    return _fill_out(mesh_out, m)


def strokerConcaveFillEndAA(stroker, mesh_out, color, fill_rule) -> Mesh | bool:
    m = strokerConcaveFillEnd(stroker, None, fill_rule)
    m.colors = np.full(len(m.pos), np.uint32(color), np.uint32)
    return _fill_out(mesh_out, m)


def _fill_out(mesh_out, m: Mesh):
    """C-style out-param compat: when the caller passes a Mesh, mutate it;
    the result is also returned either way."""
    if isinstance(mesh_out, Mesh):
        mesh_out.__dict__.update(m.__dict__)
        return mesh_out
    return m
