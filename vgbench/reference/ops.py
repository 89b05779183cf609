"""The recorder's output: one RasterOp per draw, in screen space.

The fields and paint layout are those of the port's RasterOp
(vgtpu_torch/raster/binning.py), frozen here so that the reference's
recorder (vg.py) and rasterizer (raster.py) share them without importing
the program.  Paint rows are PAINT_NF float32s: the inverse paint matrix
(0:6), gradient params (6:10), inner colour (10:14), outer colour (14:18);
a solid paint keeps its colour in the inner slot; a triangle paint keeps
the colour planes rgba(x, y) = A*x + B*y + C in (0:4, 4:8, 8:12)."""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np

K_DRAW = 0
K_CLIP_ADD = 1      # a clip shape accumulates into the clip buffer
K_CLIP_COMMIT = 2   # accumulated shapes -> binary mask (rule 0 = In, 1 = Out)
K_CLIP_RESET = 3    # mask := 1 everywhere

P_SOLID = 0
P_GRADIENT = 1
P_IMAGE = 2
P_TEXTURE = 3
P_TRI = 4

PAINT_NF = 18


@dataclass
class RasterOp:
    kind: int = K_DRAW
    edges: np.ndarray | None = None          # (E, 4) f32 screen-space segments
    fill_rule: int = 0
    aa: bool = True
    paint_kind: int = P_SOLID
    paint: np.ndarray | None = None          # (PAINT_NF,) f32
    scissor: tuple | None = None             # (x0, y0, x1, y1); None = no scissor
    image_id: int = -1
    tex_quads: np.ndarray | None = None      # (Q, 12) f32 parallelogram + uv rect
    tri_paints: np.ndarray | None = None     # (K, PAINT_NF): triangle k's paint


def make_solid_paint(rgba: np.ndarray) -> np.ndarray:
    p = np.zeros(PAINT_NF, np.float32)
    p[10:14] = rgba
    return p


def make_gradient_paint(mat6, params4, inner4, outer4) -> np.ndarray:
    p = np.zeros(PAINT_NF, np.float32)
    p[0:6] = mat6
    p[6:10] = params4
    p[10:14] = inner4
    p[14:18] = outer4
    return p


def translate_ops(ops: list[RasterOp], dx: float, dy: float) -> list[RasterOp]:
    """The ops moved by (dx, dy) in screen space: edges, scissors, textured
    quads and paints together (a frozen copy of the port's
    raster/retained.translate_ops).  Gradient and pattern paints hold the
    inverse transform u = M.p + t, so t -= M.d; triangle colour planes
    C -= A*dx + B*dy."""
    out = []
    for op in ops:
        o = copy.copy(op)
        if o.edges is not None and len(o.edges):
            e = np.asarray(o.edges, np.float32).copy()
            e[:, 0] += dx
            e[:, 2] += dx
            e[:, 1] += dy
            e[:, 3] += dy
            o.edges = e
        if o.scissor is not None:
            s = o.scissor
            o.scissor = (s[0] + dx, s[1] + dy, s[2] + dx, s[3] + dy)
        if o.tex_quads is not None and len(o.tex_quads):
            q = np.asarray(o.tex_quads, np.float32).copy()
            q[:, 0] += dx
            q[:, 1] += dy
            o.tex_quads = q
        if o.paint is not None:
            p = np.asarray(o.paint, np.float32).copy()
            if o.paint_kind in (P_GRADIENT, P_IMAGE):
                p[4] -= p[0] * dx + p[2] * dy
                p[5] -= p[1] * dx + p[3] * dy
            elif o.paint_kind == P_TRI:
                p[8:12] -= p[0:4] * dx + p[4:8] * dy
            o.paint = p
        if o.tri_paints is not None and len(o.tri_paints):
            tp = np.asarray(o.tri_paints, np.float32).copy()
            tp[:, 8:12] -= tp[:, 0:4] * dx + tp[:, 4:8] * dy
            o.tri_paints = tp
        out.append(o)
    return out
