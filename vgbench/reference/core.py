# Frozen copy of vgtpu_torch/core.py for the benchmark's plain reference: the
# port's host semantics as of the benchmark's first version, importing
# nothing of the program, so a later change to the port cannot move the
# yardstick.
"""Core types: colors, flag encodings, 2x3 affine transforms.

Bit encodings are kept identical to the reference so user code ports 1:1:
  - Color u32 RGBA packing: include/vg/vg.h:80-86
  - stroke flags (cap/join/aa):   include/vg/vg.h:176-209
  - fill flags (type/rule/aa):    include/vg/vg.h:229-250
"""

from __future__ import annotations

import colorsys
import math

import numpy as np

Color = int  # u32, RGBA packed little-endian-style: R in bits 0-7 ... A in bits 24-31

VG_EPSILON = 1e-5

COLOR_RED_SHIFT = 0
COLOR_GREEN_SHIFT = 8
COLOR_BLUE_SHIFT = 16
COLOR_ALPHA_SHIFT = 24
COLOR_RGB_MASK = 0x00FFFFFF


def color4ub(r: int, g: int, b: int, a: int = 255) -> Color:
    return (
        ((r & 0xFF) << COLOR_RED_SHIFT)
        | ((g & 0xFF) << COLOR_GREEN_SHIFT)
        | ((b & 0xFF) << COLOR_BLUE_SHIFT)
        | ((a & 0xFF) << COLOR_ALPHA_SHIFT)
    )


def _f2b(x: float) -> int:
    return max(0, min(255, int(x * 255.0 + 0.5)))


def color4f(r: float, g: float, b: float, a: float = 1.0) -> Color:
    return color4ub(_f2b(r), _f2b(g), _f2b(b), _f2b(a))


def colorHSB(h: float, s: float, b: float, a: float = 1.0) -> Color:
    r, g, bl = colorsys.hsv_to_rgb(h % 1.0, max(0.0, min(1.0, s)), max(0.0, min(1.0, b)))
    return color4f(r, g, bl, a)


def colorHSL(h: float, s: float, l: float, a: float = 1.0) -> Color:
    r, g, b = colorsys.hls_to_rgb(h % 1.0, max(0.0, min(1.0, l)), max(0.0, min(1.0, s)))
    return color4f(r, g, b, a)


def colorSetAlpha(c: Color, a: int) -> Color:
    return (c & COLOR_RGB_MASK) | ((a & 0xFF) << COLOR_ALPHA_SHIFT)


def colorGetRed(c: Color) -> int:
    return (c >> COLOR_RED_SHIFT) & 0xFF


def colorGetGreen(c: Color) -> int:
    return (c >> COLOR_GREEN_SHIFT) & 0xFF


def colorGetBlue(c: Color) -> int:
    return (c >> COLOR_BLUE_SHIFT) & 0xFF


def colorGetAlpha(c: Color) -> int:
    return (c >> COLOR_ALPHA_SHIFT) & 0xFF


def color_to_rgba_f32(c: Color) -> np.ndarray:
    """Unpack u32 color to float32 [r,g,b,a] in 0..1."""
    return np.array(
        [colorGetRed(c), colorGetGreen(c), colorGetBlue(c), colorGetAlpha(c)],
        dtype=np.float32,
    ) / np.float32(255.0)


def colors_to_rgba_f32(colors: np.ndarray) -> np.ndarray:
    """Vectorized unpack: (N,) u32 -> (N, 4) f32 in 0..1."""
    c = np.asarray(colors, np.uint32)
    out = np.empty((len(c), 4), np.float32)
    out[:, 0] = (c >> COLOR_RED_SHIFT) & 0xFF
    out[:, 1] = (c >> COLOR_GREEN_SHIFT) & 0xFF
    out[:, 2] = (c >> COLOR_BLUE_SHIFT) & 0xFF
    out[:, 3] = c >> COLOR_ALPHA_SHIFT
    out *= np.float32(1.0 / 255.0)
    return out


class Colors:
    Transparent = 0x00000000
    Black = 0xFF000000
    Red = 0xFF0000FF
    Green = 0xFF00FF00
    Blue = 0xFFFF0000
    White = 0xFFFFFFFF


class TextAlign:
    Left = 1 << 0
    Center = 1 << 1
    Right = 1 << 2
    Top = 1 << 3
    Middle = 1 << 4
    Bottom = 1 << 5
    Baseline = 1 << 6

    TopLeft = Top | Left
    TopCenter = Top | Center
    TopRight = Top | Right
    MiddleLeft = Middle | Left
    MiddleCenter = Middle | Center
    MiddleRight = Middle | Right
    BottomLeft = Bottom | Left
    BottomCenter = Bottom | Center
    BottomRight = Bottom | Right
    BaselineLeft = Baseline | Left
    BaselineCenter = Baseline | Center
    BaselineRight = Baseline | Right


class LineCap:
    Butt = 0
    Round = 1
    Square = 2


class LineJoin:
    Miter = 0
    Round = 1
    Bevel = 2


def stroke_flags(cap: int, join: int, aa: bool | int) -> int:
    """VG_STROKE_FLAGS — include/vg/vg.h:176."""
    return ((1 if aa else 0) << 4) | (cap << 2) | join


def stroke_flags_line_cap(flags: int) -> int:
    return (flags >> 2) & 0x03


def stroke_flags_line_join(flags: int) -> int:
    return flags & 0x03


def stroke_flags_aa(flags: int) -> bool:
    return (flags & 0x10) != 0


class StrokeFlags:
    ButtMiter = stroke_flags(LineCap.Butt, LineJoin.Miter, 0)
    ButtRound = stroke_flags(LineCap.Butt, LineJoin.Round, 0)
    ButtBevel = stroke_flags(LineCap.Butt, LineJoin.Bevel, 0)
    RoundMiter = stroke_flags(LineCap.Round, LineJoin.Miter, 0)
    RoundRound = stroke_flags(LineCap.Round, LineJoin.Round, 0)
    RoundBevel = stroke_flags(LineCap.Round, LineJoin.Bevel, 0)
    SquareMiter = stroke_flags(LineCap.Square, LineJoin.Miter, 0)
    SquareRound = stroke_flags(LineCap.Square, LineJoin.Round, 0)
    SquareBevel = stroke_flags(LineCap.Square, LineJoin.Bevel, 0)

    ButtMiterAA = stroke_flags(LineCap.Butt, LineJoin.Miter, 1)
    ButtRoundAA = stroke_flags(LineCap.Butt, LineJoin.Round, 1)
    ButtBevelAA = stroke_flags(LineCap.Butt, LineJoin.Bevel, 1)
    RoundMiterAA = stroke_flags(LineCap.Round, LineJoin.Miter, 1)
    RoundRoundAA = stroke_flags(LineCap.Round, LineJoin.Round, 1)
    RoundBevelAA = stroke_flags(LineCap.Round, LineJoin.Bevel, 1)
    SquareMiterAA = stroke_flags(LineCap.Square, LineJoin.Miter, 1)
    SquareRoundAA = stroke_flags(LineCap.Square, LineJoin.Round, 1)
    SquareBevelAA = stroke_flags(LineCap.Square, LineJoin.Bevel, 1)

    FixedWidth = 1 << 5  # scale-independent stroke width


class PathType:
    Convex = 0
    Concave = 1


class FillRule:
    NonZero = 0
    EvenOdd = 1


def fill_flags(path_type: int, rule: int, aa: bool | int) -> int:
    """VG_FILL_FLAGS — include/vg/vg.h:229."""
    return ((rule << 4) | ((1 if aa else 0) << 2)) | path_type


def fill_flags_path_type(flags: int) -> int:
    return flags & 0x01


def fill_flags_aa(flags: int) -> bool:
    return (flags & 0x04) != 0


def fill_flags_rule(flags: int) -> int:
    return (flags & 0x10) >> 4


class FillFlags:
    Convex = fill_flags(PathType.Convex, FillRule.NonZero, 0)
    ConvexAA = fill_flags(PathType.Convex, FillRule.NonZero, 1)
    ConcaveNonZero = fill_flags(PathType.Concave, FillRule.NonZero, 0)
    ConcaveEvenOdd = fill_flags(PathType.Concave, FillRule.EvenOdd, 0)
    ConcaveNonZeroAA = fill_flags(PathType.Concave, FillRule.NonZero, 1)
    ConcaveEvenOddAA = fill_flags(PathType.Concave, FillRule.EvenOdd, 1)
    # Backwards compat aliases (vg.h:246-249)
    Concave = ConcaveNonZero
    ConcaveAA = ConcaveNonZeroAA


class Winding:
    CCW = 0
    CW = 1


class TextBoxFlags:
    NoneFlags = 0
    KeepSpaces = 1 << 0


class ImageFlags:
    Filter_NearestUV = 1 << 0
    Filter_NearestW = 1 << 1
    Filter_LinearUV = 1 << 2
    Filter_LinearW = 1 << 3
    Clamp_U = 1 << 10
    Clamp_V = 1 << 11

    Filter_Nearest = Filter_NearestUV | Filter_NearestW
    Filter_Bilinear = Filter_LinearUV | Filter_NearestW
    Filter_Trilinear = Filter_LinearUV | Filter_LinearW
    Clamp_UV = Clamp_U | Clamp_V


class ClipRule:
    In = 0
    Out = 1


class TransformOrder:
    Pre = 0
    Post = 1


class CommandListFlags:
    NoneFlags = 0
    Cacheable = 1 << 0
    AllowCommandCulling = 1 << 1


class FontFlags:
    NoneFlags = 0
    DontCopyData = 1 << 0


# ---------------------------------------------------------------------------
# 2x3 affine transforms, stored as [a, b, c, d, e, f]:
#   x' = a*x + c*y + e
#   y' = b*x + d*y + f
# Same layout as the reference (vg_util.h:36-44).
# ---------------------------------------------------------------------------

def xform_identity() -> np.ndarray:
    return np.array([1.0, 0.0, 0.0, 1.0, 0.0, 0.0], dtype=np.float64)


def xform_translate(tx: float, ty: float) -> np.ndarray:
    return np.array([1.0, 0.0, 0.0, 1.0, tx, ty], dtype=np.float64)


def xform_scale(sx: float, sy: float) -> np.ndarray:
    return np.array([sx, 0.0, 0.0, sy, 0.0, 0.0], dtype=np.float64)


def xform_rotate(ang: float) -> np.ndarray:
    c, s = math.cos(ang), math.sin(ang)
    return np.array([c, s, -s, c, 0.0, 0.0], dtype=np.float64)


def xform_multiply(a, b) -> np.ndarray:
    """Returns a∘b: apply b first, then a (matrix product A·B for column vectors).

    Matches vgutil::multiplyMatrix3(stateTransform, localMtx) usage in the
    reference (vg.cpp:3744): state ∘ local.
    """
    # .tolist() yields python floats — scalar math on np.float64 objects
    # measured ~2x slower on this hot path (one call per svg path per frame)
    a0, a1, a2, a3, a4, a5 = a.tolist() if isinstance(a, np.ndarray) else a
    b0, b1, b2, b3, b4, b5 = b.tolist() if isinstance(b, np.ndarray) else b
    return np.array(
        [
            a0 * b0 + a2 * b1,
            a1 * b0 + a3 * b1,
            a0 * b2 + a2 * b3,
            a1 * b2 + a3 * b3,
            a0 * b4 + a2 * b5 + a4,
            a1 * b4 + a3 * b5 + a5,
        ],
        dtype=np.float64,
    )


def xform_invert(m) -> np.ndarray:
    """Invert 2x3 affine; double precision determinant like invertMatrix3
    (vg_util.cpp:14-33)."""
    a, b, c, d, e, f = (float(v) for v in m)
    det = a * d - c * b
    if abs(det) < 1e-12:
        return xform_identity()
    inv_det = 1.0 / det
    return np.array(
        [
            d * inv_det,
            -b * inv_det,
            -c * inv_det,
            a * inv_det,
            (c * f - e * d) * inv_det,
            (e * b - a * f) * inv_det,
        ],
        dtype=np.float64,
    )


def xform_point(m, x: float, y: float) -> tuple[float, float]:
    return (m[0] * x + m[2] * y + m[4], m[1] * x + m[3] * y + m[5])


def xform_points(m, pts: np.ndarray) -> np.ndarray:
    """Batch-transform an (N,2) array (the reference's batchTransformPositions,
    vg_util.cpp:136, as one vectorized expression)."""
    out = np.empty_like(pts, dtype=np.float32)
    out[:, 0] = m[0] * pts[:, 0] + m[2] * pts[:, 1] + m[4]
    out[:, 1] = m[1] * pts[:, 0] + m[3] * pts[:, 1] + m[5]
    return out


def xform_average_scale(m) -> float:
    """avgScale used for tessellation density + cache invalidation
    (updateState, vg.cpp:4927: (sx+sy)/2 where sx/sy are basis lengths)."""
    sx = math.sqrt(float(m[0]) ** 2 + float(m[2]) ** 2)
    sy = math.sqrt(float(m[1]) ** 2 + float(m[3]) ** 2)
    return (sx + sy) * 0.5
