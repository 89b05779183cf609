# Copied from vgtpu/raster/sampling.py: the jax-free host half of the PyTorch port.
"""Texture sampling pass: fills per-entry color tiles for image-pattern fills
and textured quads (text), between binning and the device composite.

Replaces the reference's fs_image_pattern shader (UV from inverse paint matrix,
vg.cpp:104-111 rationale) and the textured text quads (renderTextQuads,
vg.cpp:5541-5621).  Host-side numpy for now — the per-frame cost is bounded by
actually-textured pixels; cacheable command lists amortize it.  A device gather
version is the planned follow-up.

All produced tiles are PREMULTIPLIED RGBA f32.
"""

from __future__ import annotations

import numpy as np

from vgtpu_torch.raster.binning import FramePlan, P_IMAGE, P_TEXTURE
from vgtpu_torch.core import ImageFlags


def _bilinear(img: np.ndarray, u: np.ndarray, v: np.ndarray, flags: int) -> np.ndarray:
    """Sample (h,w,C) image at texel coordinates (u,v) in pixels (continuous,
    texel centers at +0.5).  Wrap = repeat unless Clamp_U/V flags."""
    h, w = img.shape[:2]
    x = u - 0.5
    y = v - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def wrapx(i):
        return np.clip(i, 0, w - 1) if (flags & ImageFlags.Clamp_U) else np.mod(i, w)

    def wrapy(i):
        return np.clip(i, 0, h - 1) if (flags & ImageFlags.Clamp_V) else np.mod(i, h)

    nearest = not (flags & ImageFlags.Filter_LinearUV) and (flags & ImageFlags.Filter_NearestUV)
    if nearest:
        return img[wrapy(np.round(y).astype(np.int64)), wrapx(np.round(x).astype(np.int64))]

    p00 = img[wrapy(y0), wrapx(x0)]
    p10 = img[wrapy(y0), wrapx(x0 + 1)]
    p01 = img[wrapy(y0 + 1), wrapx(x0)]
    p11 = img[wrapy(y0 + 1), wrapx(x0 + 1)]
    return (
        p00 * (1 - fx) * (1 - fy)
        + p10 * fx * (1 - fy)
        + p01 * (1 - fx) * fy
        + p11 * fx * fy
    )


def fill_color_tiles(plan: FramePlan, ops, images, cache: dict | None = None) -> None:
    """Mutates plan: computes color_tiles + entry_color_tile for textured
    entries.  `images` maps image id -> (data u8 (h,w,4) or (h,w), flags).

    `cache` (optional, persists across frames on the Context) memoizes
    sampled tiles by content fingerprint — the analogue of FONSstring's
    baked-quad reuse (fontstash.h:2368): static text/pattern tiles cost a
    dict lookup per frame instead of a resample."""
    th, tw = plan.tile_h // plan.supersample, plan.tile_w   # output-space rows
    n = plan.n_real_entries
    pk = plan.entry_paint_kind[:n]
    need = np.nonzero((pk == P_IMAGE) | (pk == P_TEXTURE))[0]
    if len(need) == 0:
        return

    ix = np.arange(tw)[None, :] + 0.5
    iy = np.arange(th)[:, None] + 0.5

    if cache is not None and len(cache) > 8192:
        cache.clear()

    tiles: list[np.ndarray] = []
    for ei in need:
        # content fingerprint: tile + paint + image generation + quad bytes
        ck = None
        if cache is not None:
            op0 = ops[int(plan.entry_op[ei])]
            img_id = int(plan.entry_image[ei])
            rec0 = images.get(img_id, (None, 0))
            data0, flags0 = rec0[0], rec0[1]
            gen0 = rec0[2] if len(rec0) > 2 else 0
            qb = op0.tex_quads.tobytes() if op0.tex_quads is not None else b""
            ck = (
                int(plan.entry_tile[ei]), int(pk[ei]), img_id, flags0,
                id(data0), gen0, plan.entry_paint[ei].tobytes(), hash(qb),
            )
            hit = cache.get(ck)
            if hit is not None:
                plan.entry_color_tile[ei] = len(tiles)
                tiles.append(hit)
                continue
        tile_id = int(plan.entry_tile[ei])
        ox = (tile_id % plan.ntx) * tw
        oy = (tile_id // plan.ntx) * th
        pxc = ox + np.broadcast_to(ix, (th, tw))
        pyc = oy + np.broadcast_to(iy, (th, tw))
        paint = plan.entry_paint[ei]
        kind = int(pk[ei])
        op = ops[int(plan.entry_op[ei])]

        if kind == P_IMAGE:
            data, flags = images[int(plan.entry_image[ei])][:2]
            ih, iw = data.shape[:2]
            m = paint[0:6]
            u = (m[0] * pxc + m[2] * pyc + m[4]) * iw   # normalized -> texels
            v = (m[1] * pxc + m[3] * pyc + m[5]) * ih
            texel = _bilinear(data.astype(np.float32) / 255.0, u, v, flags)
            if texel.shape[-1] == 1:
                texel = np.concatenate([np.ones_like(texel)] * 3 + [texel], axis=-1)
            mod = paint[10:14]
            rgba = texel * mod
            tile = np.concatenate(
                [rgba[..., 0:3] * rgba[..., 3:4], rgba[..., 3:4]], axis=-1
            )
        else:  # P_TEXTURE: sum of textured parallelogram quads
            data, flags = images[int(plan.entry_image[ei])][:2]
            a8 = data.ndim == 2
            tex = data.astype(np.float32) / 255.0
            ih, iw = data.shape[:2]
            col = paint[10:14]
            tile = np.zeros((th, tw, 4), np.float32)
            q = np.asarray(op.tex_quads, np.float64)
            # quad bbox vs tile
            cxs = np.stack([q[:, 0], q[:, 0] + q[:, 2], q[:, 0] + q[:, 4], q[:, 0] + q[:, 2] + q[:, 4]])
            cys = np.stack([q[:, 1], q[:, 1] + q[:, 3], q[:, 1] + q[:, 5], q[:, 1] + q[:, 3] + q[:, 5]])
            qsel = (
                (cxs.min(axis=0) < ox + tw + 1) & (cxs.max(axis=0) > ox - 1)
                & (cys.min(axis=0) < oy + th + 1) & (cys.max(axis=0) > oy - 1)
            )
            for p0x, p0y, exx, exy, eyx, eyy, u0, v0, u1, v1, _r0, _r1 in q[qsel]:
                det = exx * eyy - exy * eyx
                if abs(det) < 1e-12:
                    continue
                inv = np.array([[eyy, -eyx], [-exy, exx]]) / det
                rx = pxc - p0x
                ry = pyc - p0y
                a = inv[0, 0] * rx + inv[0, 1] * ry   # quad-space coords [0,1]
                b = inv[1, 0] * rx + inv[1, 1] * ry
                # fractional edge coverage via gradient footprint per axis
                wa = max(np.hypot(inv[0, 0], inv[0, 1]), 1e-9)
                wb = max(np.hypot(inv[1, 0], inv[1, 1]), 1e-9)
                cov_a = np.clip((0.5 - np.abs(a - 0.5)) / wa + 0.5, 0.0, 1.0)
                cov_b = np.clip((0.5 - np.abs(b - 0.5)) / wb + 0.5, 0.0, 1.0)
                qcov = cov_a * cov_b
                tu = (u0 + np.clip(a, 0, 1) * (u1 - u0)) * iw
                tv = (v0 + np.clip(b, 0, 1) * (v1 - v0)) * ih
                if a8:
                    alpha = _bilinear(tex[..., None], tu, tv, flags)[..., 0]
                    rgba = np.empty((th, tw, 4), np.float32)
                    rgba[..., 0:3] = col[0:3]
                    rgba[..., 3] = alpha * col[3]
                else:
                    rgba = _bilinear(tex, tu, tv, flags) * col
                add = np.concatenate(
                    [rgba[..., 0:3] * (rgba[..., 3:4] * qcov[..., None]),
                     rgba[..., 3:4] * qcov[..., None]],
                    axis=-1,
                )
                tile = tile + add
            tile = np.clip(tile, 0.0, 1.0)

        tile = tile.astype(np.float32)
        plan.entry_color_tile[ei] = len(tiles)
        tiles.append(tile)
        if cache is not None and ck is not None:
            cache[ck] = tile

    plan.color_tiles = np.stack(tiles) if tiles else plan.color_tiles
