"""The reference rasterizer: recorded ops -> a premultiplied RGBA image.

Plain torch, op by op over the whole canvas, with none of the program's
structure: no tiles, chunks, buckets, backdrops or memos.  For each op in
draw order:

  winding   every edge's exact box-filtered signed area in every pixel of
            the op's bounding box (the analytic formula the renderer
            defines, ARCHITECTURE.md), summed over the op's edges;
  coverage  the fill rule on the winding (NonZero: min(|w|, 1); EvenOdd:
            1 - |w mod 2 - 1|), thresholded at 0.5 when not antialiased;
            at coverage_supersample = ss > 1 on ss sub-rows a pixel, the
            rule applied per sub-row and the sub-rows averaged;
  clip      clip shapes accumulate coverage; a commit turns it into a mask
            (accum > 0.5, inverted for ClipRule.Out); a reset clears it;
  scissor   the pixel-centre test against the op's rect;
  paint     solid, gradient (the rounded-rect signed distance of the inverse
            paint transform), triangle colour planes, or a sampled texture:
            image patterns and glyph quads (bilinear, premultiplied);
  blend     source-over into the premultiplied framebuffer.

A threshold (non-antialiased coverage, the clip commit) decides a pixel
whose coverage lies within TIE of 0.5 by rounding alone, so the reference
also returns the pixels so decided, which a comparison leaves out.

`geom_dtype` carries every position: the edge and winding arithmetic,
pixel centres, texture and paint coordinates.  `comp_dtype` carries the
composite: coverage, texels, colours and the blend.  The reference runs
both in float64; the control (a lower precision in the program's place)
runs float32 positions and a bfloat16 composite."""

from __future__ import annotations

import math

import numpy as np
import torch

from vgbench.reference.core import ImageFlags
from vgbench.reference.ops import (
    K_CLIP_ADD,
    K_CLIP_COMMIT,
    K_CLIP_RESET,
    K_DRAW,
    P_GRADIENT,
    P_IMAGE,
    P_TEXTURE,
    P_TRI,
    RasterOp,
)

_EPS = 1e-6
_BLOCK = 1 << 22          # elements of one (edges, rows, cols) block
# |coverage - 0.5| below which a threshold is a tie: float32 vertex
# positions near x = 2000 carry ~1.2e-4 px of rounding, and the program and
# the reference translate and flatten with different roundings
TIE = 5e-4


def _expand_tris(ops: list[RasterOp]) -> list[RasterOp]:
    """A triangle-list op becomes one op per triangle with its own paint."""
    out = []
    for op in ops:
        if op.tri_paints is None:
            out.append(op)
            continue
        e = np.asarray(op.edges, np.float32).reshape(-1, 3, 4)
        for k in range(len(e)):
            out.append(RasterOp(kind=op.kind, edges=e[k], fill_rule=op.fill_rule,
                                aa=op.aa, paint_kind=P_TRI, paint=op.tri_paints[k],
                                scissor=op.scissor))
    return out


def edge_area(px, py, x0, y0, x1, y1):
    """Signed area that edge (x0, y0) -> (x1, y1) adds to pixel [px, px+1) x
    [py, py+1): the fraction of the pixel's row span the edge crosses
    (h, signed by direction) times the share of the pixel right of the
    edge, integrated exactly over the span; pixels wholly right of the edge
    get s*h, wholly left 0."""
    ymin = torch.minimum(y0, y1)
    ymax = torch.maximum(y0, y1)
    dy = y1 - y0
    s = torch.sign(dy)
    h = torch.clamp_min(torch.minimum(ymax, py + 1.0) - torch.maximum(ymin, py), 0.0)
    ytop = torch.maximum(ymin, py)
    m = (x1 - x0) / torch.where(dy.abs() < _EPS, torch.ones_like(dy), dy)
    steep = m.abs() < 0.01
    # the edge's x at the top and bottom of its span in this row, measured
    # from the pixel's right side
    u0 = (px + 1.0) - (x0 + m * (ytop - y0))
    u1 = u0 - m * h
    c0 = u0.clamp(0.0, 1.0)
    c1 = u1.clamp(0.0, 1.0)
    g0 = c0 * (u0 - 0.5 * c0)
    g1 = c1 * (u1 - 0.5 * c1)
    general = (g0 - g1) * (s / torch.where(steep, torch.ones_like(m), m))
    vertical = s * h * c0
    return torch.where(steep, vertical, general)


def winding(edges: torch.Tensor, x0: int, y0: int, w: int, h: int) -> torch.Tensor:
    """(h, w) winding of the pixels [x0, x0+w) x [y0, y0+h) from (E, 4)
    edges, in blocks of edges sorted by their top, each over the rows it
    spans and the columns from its left end to the box's right."""
    acc = edges.new_zeros((h, w))
    if not len(edges):
        return acc
    ylo = torch.minimum(edges[:, 1], edges[:, 3])
    order = torch.argsort(ylo)
    e = edges[order]
    ylo, yhi = ylo[order], torch.maximum(e[:, 1], e[:, 3])
    xlo = torch.minimum(e[:, 0], e[:, 2])
    ylo_h = ylo.cpu().numpy()
    yhi_h = yhi.cpu().numpy()
    xlo_h = xlo.cpu().numpy()
    n = len(e)
    i = 0
    while i < n:
        # grow the block while it stays within _BLOCK elements
        j = i + 1
        r0 = max(int(math.floor(ylo_h[i])) - y0, 0)
        r1 = min(int(math.ceil(yhi_h[i])) - y0, h)
        c0 = max(int(math.floor(xlo_h[i])) - x0, 0)
        while j < n:
            r1n = max(r1, min(int(math.ceil(yhi_h[j])) - y0, h))
            c0n = min(c0, max(int(math.floor(xlo_h[j])) - x0, 0))
            if (j + 1 - i) * max(r1n - r0, 1) * max(w - c0n, 1) > _BLOCK:
                break
            r1, c0 = r1n, c0n
            j += 1
        if r1 > r0 and c0 < w:
            blk = e[i:j]
            px = torch.arange(x0 + c0, x0 + w, dtype=e.dtype, device=e.device)[None, None, :]
            py = torch.arange(y0 + r0, y0 + r1, dtype=e.dtype, device=e.device)[None, :, None]
            ex = [blk[:, k][:, None, None] for k in range(4)]
            acc[r0:r1, c0:] += edge_area(px, py, *ex).sum(dim=0)
        i = j
    return acc


def _bbox(op: RasterOp, ss: int, width: int, height_s: int):
    """The op's pixel box on the sub-row canvas, clipped to it; None if
    empty.  Textured quads grow by a pixel for their antialiased rim."""
    if op.paint_kind == P_TEXTURE:
        q = np.asarray(op.tex_quads, np.float64)
        xs = np.concatenate([q[:, 0], q[:, 0] + q[:, 2], q[:, 0] + q[:, 4],
                             q[:, 0] + q[:, 2] + q[:, 4]])
        ys = np.concatenate([q[:, 1], q[:, 1] + q[:, 3], q[:, 1] + q[:, 5],
                             q[:, 1] + q[:, 3] + q[:, 5]]) * ss
        xa, xb, ya, yb = xs.min() - 1, xs.max() + 1, ys.min() - ss, ys.max() + ss
    else:
        e = np.asarray(op.edges, np.float64)
        if not len(e):
            return None
        xa, xb = e[:, [0, 2]].min(), e[:, [0, 2]].max()
        ya, yb = e[:, [1, 3]].min() * ss, e[:, [1, 3]].max() * ss
    x0 = max(int(math.floor(xa)), 0)
    x1 = min(int(math.ceil(xb)) + 1, width)
    y0 = max(int(math.floor(ya)) // ss * ss, 0)
    y1 = min(-(-(int(math.ceil(yb)) + 1) // ss) * ss, height_s)
    if x1 <= x0 or y1 <= y0:
        return None
    return x0, y0, x1 - x0, y1 - y0


def _bilinear(img, u, v, flags: int):
    """(h, w, C) texture at texel coordinates (u, v), texel centres at +0.5;
    repeat unless clamped per axis; nearest when only NearestUV is set."""
    h, w = img.shape[:2]
    x, y = u - 0.5, v - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx = (x - x0)[..., None].to(img.dtype)
    fy = (y - y0)[..., None].to(img.dtype)
    x0, y0 = x0.long(), y0.long()

    def wx(i):
        return i.clamp(0, w - 1) if flags & ImageFlags.Clamp_U else torch.remainder(i, w)

    def wy(i):
        return i.clamp(0, h - 1) if flags & ImageFlags.Clamp_V else torch.remainder(i, h)

    if not (flags & ImageFlags.Filter_LinearUV) and (flags & ImageFlags.Filter_NearestUV):
        return img[wy(torch.round(y).long()), wx(torch.round(x).long())]
    return (img[wy(y0), wx(x0)] * (1 - fx) * (1 - fy) + img[wy(y0), wx(x0 + 1)] * fx * (1 - fy)
            + img[wy(y0 + 1), wx(x0)] * (1 - fx) * fy + img[wy(y0 + 1), wx(x0 + 1)] * fx * fy)


def _texture_color(op: RasterOp, tex, flags: int, px, py):
    """Premultiplied colour, in the texture's dtype, of a textured op at
    output pixel centres (px, py)."""
    paint = torch.as_tensor(np.asarray(op.paint, np.float64), dtype=px.dtype, device=px.device)
    col = paint[10:14].to(tex.dtype)
    ih, iw = tex.shape[:2]
    if op.paint_kind == P_IMAGE:
        m = paint[0:6]
        u = (m[0] * px + m[2] * py + m[4]) * iw
        v = (m[1] * px + m[3] * py + m[5]) * ih
        texel = _bilinear(tex, u, v, flags)
        if texel.shape[-1] == 1:
            texel = torch.cat([torch.ones_like(texel)] * 3 + [texel], dim=-1)
        rgba = texel * col
        return torch.cat([rgba[..., 0:3] * rgba[..., 3:4], rgba[..., 3:4]], dim=-1)
    out = tex.new_zeros(px.shape + (4,))
    for p0x, p0y, exx, exy, eyx, eyy, u0, v0, u1, v1, _r0, _r1 in np.asarray(
            op.tex_quads, np.float64):
        det = exx * eyy - exy * eyx
        if abs(det) < 1e-12:
            continue
        i00, i01, i10, i11 = eyy / det, -eyx / det, -exy / det, exx / det
        rx, ry = px - p0x, py - p0y
        a = i00 * rx + i01 * ry                 # quad-space coordinates
        b = i10 * rx + i11 * ry
        wa = max(math.hypot(i00, i01), 1e-9)
        wb = max(math.hypot(i10, i11), 1e-9)
        qcov = (((0.5 - (a - 0.5).abs()) / wa + 0.5).clamp(0.0, 1.0).to(tex.dtype)
                * ((0.5 - (b - 0.5).abs()) / wb + 0.5).clamp(0.0, 1.0).to(tex.dtype))
        tu = (u0 + a.clamp(0, 1) * (u1 - u0)) * iw
        tv = (v0 + b.clamp(0, 1) * (v1 - v0)) * ih
        if tex.shape[-1] == 1:
            alpha = _bilinear(tex, tu, tv, flags)[..., 0] * col[3]
            rgba = torch.cat([col[0:3].expand(alpha.shape + (3,)), alpha[..., None]], dim=-1)
        else:
            rgba = _bilinear(tex, tu, tv, flags) * col
        out = out + torch.cat([rgba[..., 0:3] * (rgba[..., 3:4] * qcov[..., None]),
                               rgba[..., 3:4] * qcov[..., None]], dim=-1)
    return out.clamp(0.0, 1.0)


def _sdroundrect(ux, uy, ex, ey, rad):
    dx = ux.abs() - (ex - rad)
    dy = uy.abs() - (ey - rad)
    mx, my = dx.clamp_min(0.0), dy.clamp_min(0.0)
    return torch.maximum(dx, dy).clamp_max(0.0) + torch.sqrt(mx * mx + my * my) - rad


def _paint_color(op: RasterOp, px, py, dtype):
    """Straight (not premultiplied) RGBA, in `dtype`, of a solid, gradient
    or triangle paint at output pixel centres (px, py): the paint's
    coordinates in their own dtype, its colours in `dtype`."""
    p = torch.as_tensor(np.asarray(op.paint, np.float64), dtype=px.dtype, device=px.device)
    if op.paint_kind == P_GRADIENT:
        ux = p[0] * px + p[2] * py + p[4]
        uy = p[1] * px + p[3] * py + p[5]
        feather = p[9].clamp_min(1e-6)
        d = ((_sdroundrect(ux, uy, p[6], p[7], p[8]) + feather * 0.5) / feather).clamp(0, 1)
        d = d[..., None].to(dtype)
        return p[10:14].to(dtype) * (1.0 - d) + p[14:18].to(dtype) * d
    if op.paint_kind == P_TRI:
        return (p[0:4] * px[..., None] + p[4:8] * py[..., None] + p[8:12]).to(dtype)
    return p[10:14].to(dtype).expand(px.shape + (4,))


def render(ops: list[RasterOp], width: int, height: int, images: dict, *,
           background=(0.0, 0.0, 0.0, 0.0), ss: int = 1, device="cpu",
           geom_dtype=torch.float64, comp_dtype=torch.float64):
    """((height, width, 4) premultiplied image, (height, width) bool ties)
    of `ops` (screen-space, as recorded) over `background` (premultiplied).
    images: image id -> (data u8 (h, w, 4) or (h, w), flags)."""
    dev = torch.device(device)
    hs = height * ss
    fb = torch.as_tensor(background, dtype=comp_dtype, device=dev).expand(
        height, width, 4).clone()
    mask = torch.ones((hs, width), dtype=comp_dtype, device=dev)
    accum = torch.zeros((hs, width), dtype=comp_dtype, device=dev)
    ties = torch.zeros((hs, width), dtype=torch.bool, device=dev)
    textures: dict = {}
    for op in _expand_tris(ops):
        if op.kind == K_CLIP_RESET:
            mask.fill_(1.0)
            continue
        if op.kind == K_CLIP_COMMIT:
            ties |= (accum - 0.5).abs() < TIE
            mask = ((accum > 0.5) if op.fill_rule == 0 else ~(accum > 0.5)).to(comp_dtype)
            accum.zero_()
            continue
        if op.paint_kind == P_TEXTURE and op.kind != K_DRAW:
            continue
        box = _bbox(op, ss, width, hs)
        if box is None:
            continue
        x0, y0, w, h = box
        if op.paint_kind == P_TEXTURE:
            cov = torch.ones((h, w), dtype=comp_dtype, device=dev)
        else:
            e = torch.as_tensor(np.asarray(op.edges, np.float64), dtype=geom_dtype, device=dev)
            e = e * torch.tensor([1.0, ss, 1.0, ss], dtype=geom_dtype, device=dev)
            wnd = winding(e, x0, y0, w, h).to(comp_dtype)
            if op.fill_rule == 0:
                cov = wnd.abs().clamp_max(1.0)
            else:
                cov = 1.0 - (torch.remainder(wnd, 2.0) - 1.0).abs()
            if not op.aa:
                # a clip shape's threshold decides the mask of every later
                # draw there, a draw's its own pixel
                ties[y0:y0 + h, x0:x0 + w] |= (cov - 0.5).abs() < TIE
                cov = (cov >= 0.5).to(comp_dtype)
        if op.scissor is not None:
            sc = op.scissor
            pxc = torch.arange(x0, x0 + w, dtype=torch.float64, device=dev) + 0.5
            pyc = torch.arange(y0, y0 + h, dtype=torch.float64, device=dev) + 0.5
            inside = (((pxc >= sc[0]) & (pxc < sc[2]))[None, :]
                      & ((pyc >= sc[1] * ss) & (pyc < sc[3] * ss))[:, None])
            cov = cov * inside.to(comp_dtype)
        if op.kind == K_CLIP_ADD:
            accum[y0:y0 + h, x0:x0 + w] += cov
            continue
        c = cov * mask[y0:y0 + h, x0:x0 + w]
        if ss > 1:
            c = c.reshape(h // ss, ss, w).mean(dim=1)
        oy0, oh = y0 // ss, h // ss
        px = (torch.arange(x0, x0 + w, dtype=geom_dtype, device=dev) + 0.5).expand(oh, w)
        py = (torch.arange(oy0, oy0 + oh, dtype=geom_dtype, device=dev)[:, None] + 0.5
              ).expand(oh, w)
        if op.paint_kind in (P_TEXTURE, P_IMAGE):
            key = op.image_id
            if key not in textures:
                data, flags = images[key][:2]
                arr = np.asarray(data)
                if arr.ndim == 2:
                    arr = arr[..., None]
                textures[key] = (torch.as_tensor(arr, device=dev).to(comp_dtype) / 255.0,
                                 flags)
            tex, flags = textures[key]
            src = _texture_color(op, tex, flags, px, py)
            src_rgb, src_a = src[..., 0:3], src[..., 3]
        else:
            col = _paint_color(op, px, py, comp_dtype)
            src_rgb, src_a = col[..., 0:3] * col[..., 3:4], col[..., 3]
        a = src_a * c
        region = fb[oy0:oy0 + oh, x0:x0 + w]
        fb[oy0:oy0 + oh, x0:x0 + w] = torch.cat(
            [src_rgb * c[..., None] + region[..., 0:3] * (1.0 - a)[..., None],
             (a + region[..., 3] * (1.0 - a))[..., None]], dim=-1)
    return fb, ties.reshape(height, ss, width).any(dim=1)
