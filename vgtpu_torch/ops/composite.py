"""Fused painter composite (device half of the port): per-tile painter scan
+ shading + blending per bucket of tiles, gathering straight from resolved
chunk coverage.

Twin of the fused TPU formulation in vgtpu/ops/composite_pallas.py
(frame_fb_pallas -> composite_bucket_pallas -> _kernel_rows) for ss=1:
the per-entry backdrop is added in the composite, the background is a
broadcast colour, one variant.  On a CUDA tensor `composite_bucket` launches
kernel K2 (csrc/composite.cu, via ops/composite_cuda.py); on a CPU tensor it
runs the plain torch twin.  Any other device raises.

Reference behaviour: the end() draw loop vg.cpp:1162-1287, the four shader
programs src/shaders/*.sc, and the stencil clip semantics vg.cpp:1193-1215.

Per-bucket static data (host-built by raster/frame.plan_to_device):
  params: (MO, _npp(tile_h), NbP) f32 — per (slot, tile) metadata rows (_P_*)
  pteb:   (NbP, MO) i32 — primary chunk id per (tile, slot) (dead id if none)
  ctile:  (NbP, MO) i32 — colour-tile id per (tile, slot) (NCT = zeros row),
          only for buckets whose texture lane is on
  ids:    (NbP,) i32 — framebuffer row per tile (pad rows: the scratch row)
"""

from __future__ import annotations

import numpy as np
import torch

from vgtpu_torch.ops.coverage import fma
from vgtpu_torch.raster.binning import (
    K_CLIP_ADD,
    K_CLIP_COMMIT,
    K_CLIP_RESET,
    K_DRAW,
    P_GRADIENT,
    P_IMAGE,
    P_TEXTURE,
    P_TRI,
)

# params row indices (vgtpu/ops/composite_pallas.py)
_P_VALID = 0
_P_KIND = 1
_P_RULE = 2
_P_AA = 3
_P_PK = 4
_P_SC = 5          # 5..8  scissor x0,y0,x1,y1 (screen px)
_P_CTILE = 9       # has color tile (0/1)
_P_OX = 10
_P_OY = 11
_P_PAINT = 12      # 12..29 paint[0:18]
_P_BD = 32         # 32..32+tile_h  per-row backdrop winding


def _npp(tile_h: int) -> int:
    """params row count: 32 metadata rows + tile_h backdrop rows, padded to
    a multiple of 8 (copied from vgtpu/ops/composite_pallas.py)."""
    return -(-(_P_BD + tile_h) // 8) * 8


def build_bucket_aux(plan, te_b: np.ndarray, need_ct: bool = False):
    """Host-side static per-bucket arrays (copied from
    vgtpu/ops/composite_pallas.py): params_t (MO, NPP, Nb) and, when the
    bucket's texture lane is active, ct_t (MO, 4*NPX, Nb) channel-major."""
    mo = te_b.shape[1]
    nb = _pad_tiles(te_b.shape[0])
    if nb != te_b.shape[0]:
        te_b = np.concatenate(
            [te_b, np.full((nb - te_b.shape[0], mo), -1, te_b.dtype)])
    th, tw = plan.tile_h, plan.tile_w
    e = np.maximum(te_b, 0)
    valid = (te_b >= 0).astype(np.float32)

    pp = np.zeros((mo, _npp(th), nb), np.float32)
    pp[:, _P_VALID] = valid.T
    pp[:, _P_KIND] = plan.entry_kind[e].T
    pp[:, _P_RULE] = plan.entry_rule[e].T
    pp[:, _P_AA] = plan.entry_aa[e].T
    pp[:, _P_PK] = plan.entry_paint_kind[e].T
    pp[:, _P_SC : _P_SC + 4] = plan.entry_scissor[e].transpose(1, 2, 0)
    ctile = plan.entry_color_tile[e]
    pp[:, _P_CTILE] = (ctile >= 0).astype(np.float32).T
    tile = plan.entry_tile[e]          # (Nb, MO) flat tile id of the ENTRY
    # tile origin comes from the bucket's own tile row (scratch rows get 0)
    pp[:, _P_OX] = ((tile % plan.ntx) * tw).astype(np.float32).T
    pp[:, _P_OY] = ((tile // plan.ntx) * th).astype(np.float32).T
    pp[:, _P_PAINT : _P_PAINT + 18] = plan.entry_paint[e].transpose(1, 2, 0)
    pp[:, _P_BD : _P_BD + th] = (plan.entry_backdrop[e] * valid[:, :, None]).transpose(1, 2, 0)

    ct_t = None
    if need_ct:
        # color tiles live on the OUTPUT domain (th counts sub-rows when the
        # plan supersamples)
        npx_out = (th // plan.supersample) * tw
        ct = plan.color_tiles[np.maximum(ctile, 0)]       # (Nb, MO, th_out, tw, 4)
        ct = ct * (ctile >= 0).astype(np.float32)[:, :, None, None, None]
        # -> (MO, 4, NPX_OUT, Nb) -> (MO, 4*NPX_OUT, Nb) channel-major
        ct_t = np.ascontiguousarray(
            ct.reshape(nb, mo, npx_out, 4).transpose(1, 3, 2, 0).reshape(mo, 4 * npx_out, nb)
        ).astype(np.float32)
    return pp, ct_t


def build_bucket_pteb(te_b: np.ndarray, primary: np.ndarray,
                      dead_id: int) -> np.ndarray:
    """(Nb, MO) bucket entry table -> (NbP, MO) primary-chunk ids for the
    fused chunk-gather composite (copied from vgtpu/ops/composite_pallas.py):
    rows pad to _pad_tiles, invalid slots point at the all-zero dead chunk."""
    nbp = _pad_tiles(te_b.shape[0])
    te_p = te_b
    if nbp != te_b.shape[0]:
        te_p = np.concatenate(
            [te_b, np.full((nbp - te_b.shape[0], te_b.shape[1]), -1, te_b.dtype)])
    return np.where(te_p >= 0, primary[np.maximum(te_p, 0)],
                    dead_id).astype(np.int32)


def _pad_tiles(nb: int) -> int:
    """Bucket row padding (copied from vgtpu/ops/composite_pallas.py, where
    the TPU lane blocks need it): buckets over 128 tiles pad to the next
    128-multiple.  Kept so both packages build identical bucket tables."""
    if nb <= 128:
        return nb
    return -(-nb // 128) * 128


def composite_bucket_torch(ew_t: torch.Tensor, params_t: torch.Tensor,
                           ct_t: torch.Tensor | None, bg_vec: torch.Tensor,
                           *, tile_w: int, flags: tuple) -> torch.Tensor:
    """One bucket's painter scan -> fb_t (4*NPX, Nb), channel-major: the
    plain twin of vgtpu's composite_bucket_pallas(..., add_backdrop=True)
    with the rows kernel at ss=1, and of kernel K2.

    ew_t (MO, NPX, Nb) raw chunk coverage per slot; params_t (MO, NPP, Nb);
    ct_t (MO, 4*NPX, Nb) or None; bg_vec (4*NPX, 1).  Expressions follow
    _kernel_rows per pixel, in its order."""
    has_grad, has_tri, has_tex, has_clip, has_eo, has_noaa, has_scissor = flags
    mo, npx, nb = ew_t.shape
    th = npx // tile_w
    dev = ew_t.device
    flat = torch.arange(npx, device=dev)
    pxl = (flat % tile_w).to(torch.float32)[:, None] + 0.5   # (NPX, 1)
    pyl = (flat // tile_w).to(torch.float32)[:, None] + 0.5

    out = bg_vec.expand(4 * npx, nb)
    fr, fg, fb_, fa = (out[i * npx : (i + 1) * npx] for i in range(4))
    if has_clip:
        mask = torch.ones((npx, nb), dtype=torch.float32, device=dev)
        accum = torch.zeros((npx, nb), dtype=torch.float32, device=dev)

    for j in range(mo):
        pp = params_t[j]                       # (NPP, Nb)

        def row(k, pp=pp):
            return pp[k : k + 1, :]            # (1, Nb)

        valid = row(_P_VALID)
        kind = row(_P_KIND)
        rule = row(_P_RULE)
        aa = row(_P_AA)
        pk = row(_P_PK)
        inner_r = row(_P_PAINT + 10)
        inner_g = row(_P_PAINT + 11)
        inner_b = row(_P_PAINT + 12)
        inner_a = row(_P_PAINT + 13)

        # per-pixel backdrop row: pixel p sits on tile row p // tile_w
        w = ew_t[j] + pp[_P_BD : _P_BD + th].repeat_interleave(tile_w, dim=0)
        cov = torch.clamp_max(torch.abs(w), 1.0)
        if has_eo:
            cov_eo = 1.0 - torch.abs(torch.remainder(w, 2.0) - 1.0)
            cov = torch.where(rule == 0, cov, cov_eo)
        if has_noaa:
            cov = torch.where(aa != 0, cov, (cov >= 0.5).to(torch.float32))
        if has_tex:
            is_quad_tex = pk == float(P_TEXTURE)
            use_ct = (row(_P_CTILE) > 0) & (is_quad_tex | (pk == float(P_IMAGE)))
            cov = torch.where(is_quad_tex, 1.0, cov)
        ox = row(_P_OX)
        oy = row(_P_OY)
        if has_scissor:
            inside_y = (pyl >= row(_P_SC + 1) - oy) & (pyl < row(_P_SC + 3) - oy)
            inside = (pxl >= row(_P_SC) - ox) & inside_y & (pxl < row(_P_SC + 2) - ox)
            cov = cov * inside.to(torch.float32)

        if has_clip:
            is_draw = (valid > 0) & (kind == float(K_DRAW))
            is_cadd = (valid > 0) & (kind == float(K_CLIP_ADD))
            is_ccommit = (valid > 0) & (kind == float(K_CLIP_COMMIT))
            is_creset = (valid > 0) & (kind == float(K_CLIP_RESET))
            c = torch.where(is_draw, cov, 0.0) * mask
            acc = torch.where(is_cadd, accum + cov, accum)
            inside_f = (acc > 0.5).to(torch.float32)
            committed = torch.where(rule == 0, inside_f, 1.0 - inside_f)
            mask = torch.where(is_creset, 1.0, torch.where(is_ccommit, committed, mask))
            accum = torch.where(is_ccommit, 0.0, acc)
        else:
            c = torch.where(valid > 0, cov, 0.0)

        col_r, col_g, col_b, col_a = inner_r, inner_g, inner_b, inner_a
        if has_grad or has_tri:
            pxc = pxl + ox                     # (NPX, Nb) screen-space centres
            pyc = pyl + oy
        if has_grad:
            is_grad = pk == float(P_GRADIENT)
            feather = torch.clamp_min(row(_P_PAINT + 9), 1e-6)
            # one FMA per coordinate, where XLA (and K2) contract: u is ~1e5
            # for linear gradients, where an ulp moves d by ~3e-5
            ux = fma(row(_P_PAINT + 0), pxc, row(_P_PAINT + 2) * pyc) + row(_P_PAINT + 4)
            uy = fma(row(_P_PAINT + 1), pxc, row(_P_PAINT + 3) * pyc) + row(_P_PAINT + 5)
            ex = row(_P_PAINT + 6)
            ey = row(_P_PAINT + 7)
            rad = row(_P_PAINT + 8)
            dx = torch.abs(ux) - (ex - rad)
            dy = torch.abs(uy) - (ey - rad)
            mx = torch.clamp_min(dx, 0.0)
            my = torch.clamp_min(dy, 0.0)
            # sqrt in float64, rounded once: the correctly rounded float32
            # sqrt (IEEE, as sqrtf in K2); torch's float32 CPU sqrt varies in
            # the last ulp from one process to the next
            sd = (torch.clamp_max(torch.maximum(dx, dy), 0.0)
                  + torch.sqrt((mx * mx + my * my).double()).float() - rad)
            d = torch.clamp((sd + feather * 0.5) / feather, 0.0, 1.0)
            col_r = torch.where(is_grad, inner_r * (1.0 - d) + row(_P_PAINT + 14) * d, col_r)
            col_g = torch.where(is_grad, inner_g * (1.0 - d) + row(_P_PAINT + 15) * d, col_g)
            col_b = torch.where(is_grad, inner_b * (1.0 - d) + row(_P_PAINT + 16) * d, col_b)
            col_a = torch.where(is_grad, inner_a * (1.0 - d) + row(_P_PAINT + 17) * d, col_a)
        if has_tri:
            is_tri = pk == float(P_TRI)
            col_r = torch.where(is_tri, row(_P_PAINT + 0) * pxc + row(_P_PAINT + 4) * pyc + row(_P_PAINT + 8), col_r)
            col_g = torch.where(is_tri, row(_P_PAINT + 1) * pxc + row(_P_PAINT + 5) * pyc + row(_P_PAINT + 9), col_g)
            col_b = torch.where(is_tri, row(_P_PAINT + 2) * pxc + row(_P_PAINT + 6) * pyc + row(_P_PAINT + 10), col_b)
            col_a = torch.where(is_tri, row(_P_PAINT + 3) * pxc + row(_P_PAINT + 7) * pyc + row(_P_PAINT + 11), col_a)

        if has_tex:
            ct = ct_t[j]                       # (4*NPX, Nb) channel-major
            src_r = torch.where(use_ct, ct[0:npx], col_r * col_a)
            src_g = torch.where(use_ct, ct[npx : 2 * npx], col_g * col_a)
            src_b = torch.where(use_ct, ct[2 * npx : 3 * npx], col_b * col_a)
            src_a = torch.where(use_ct, ct[3 * npx : 4 * npx], col_a)
        else:
            src_r = col_r * col_a
            src_g = col_g * col_a
            src_b = col_b * col_a
            src_a = col_a

        a = src_a * c
        one_minus_a = 1.0 - a
        fr = src_r * c + fr * one_minus_a
        fg = src_g * c + fg * one_minus_a
        fb_ = src_b * c + fb_ * one_minus_a
        fa = a + fa * one_minus_a
    return torch.cat([t.expand(npx, nb) for t in (fr, fg, fb_, fa)], dim=0)


def composite_bucket_into_torch(fb, cov_all, pteb, params, ct_flat, ctile,
                                ids, background, *, tile_w: int,
                                flags: tuple) -> None:
    """Plain twin of K2 on the tensors' own device: gather the bucket's
    coverage (and colour tiles), run composite_bucket_torch, scatter the
    tiles into fb (T+1, TH, TW, 4) in place at rows ids.  background: the
    4 premultiplied RGBA floats."""
    nb, _mo = pteb.shape
    npx = cov_all.shape[1]
    th = npx // tile_w
    ew_t = cov_all[pteb].permute(1, 2, 0)                   # (MO, NPX, NbP)
    ct_t = ct_flat[ctile].permute(1, 2, 0) if flags[2] else None
    bg = torch.tensor(background, dtype=torch.float32, device=fb.device)
    bg_vec = bg.repeat_interleave(npx)[:, None]
    fb_t = composite_bucket_torch(ew_t, params, ct_t, bg_vec, tile_w=tile_w,
                                  flags=tuple(flags))
    fb[ids] = fb_t.reshape(4, th, tile_w, nb).permute(3, 1, 2, 0)


def composite_bucket(fb, cov_all, pteb, params, ct_flat, ctile, ids,
                     background, *, tile_w: int, flags: tuple) -> None:
    """Composite one bucket into fb (T+1, TH, TW, 4) in place (the update
    saves a per-bucket framebuffer copy): kernel K2 on CUDA, the plain twin
    on the CPU."""
    dev = fb.device
    if dev.type == "cuda":
        from vgtpu_torch.ops.composite_cuda import composite_bucket_cuda

        composite_bucket_cuda(fb, cov_all, pteb, params, ct_flat, ctile, ids,
                              background, tile_w=tile_w, flags=flags)
    elif dev.type == "cpu":
        composite_bucket_into_torch(fb, cov_all, pteb, params, ct_flat, ctile,
                                    ids, background, tile_w=tile_w, flags=flags)
    else:
        raise ValueError(f"composite_bucket: unsupported device {dev}")


def frame_fb(cov_all, bucket_ids, bucket_pteb, bucket_params, bucket_ctile,
             ct_flat, background, *, tile_h: int, tile_w: int, num_tiles: int,
             bucket_flags: tuple, bucket_fn=composite_bucket) -> torch.Tensor:
    """Fused frame composite -> (T, TH, TW, 4) tiles: the twin of vgtpu's
    frame_fb_pallas at ss=1.  Buckets gather straight from resolved chunk
    coverage via the host-built primary-chunk ids; the entry backdrop is
    added in the composite; tiles no bucket covers keep the background.

    background is the 4 premultiplied RGBA floats; bucket_ids are padded to
    NbP with the scratch row num_tiles; bucket_fn is composite_bucket (K2 on
    CUDA) or composite_bucket_into_torch."""
    background = tuple(float(v) for v in background)
    fb = torch.empty((num_tiles + 1, tile_h, tile_w, 4), dtype=torch.float32,
                     device=cov_all.device)
    fb.copy_(torch.tensor(background, dtype=torch.float32, device=fb.device)
             .expand(num_tiles + 1, tile_h, tile_w, 4))
    for ids, pteb, pp, ctile, flags in zip(
        bucket_ids, bucket_pteb, bucket_params, bucket_ctile, bucket_flags,
    ):
        bucket_fn(fb, cov_all, pteb, pp, ct_flat, ctile, ids, background,
                  tile_w=tile_w, flags=tuple(flags))
    return fb[:num_tiles]


def tiles_to_image(fb_tiles, *, ntx, nty, tile_h, tile_w, width, height):
    """(T, TH, TW, 4) -> (H, W, 4) cropped framebuffer."""
    img = fb_tiles.reshape(nty, ntx, tile_h, tile_w, 4)
    img = img.permute(0, 2, 1, 3, 4).reshape(nty * tile_h, ntx * tile_w, 4)
    return img[:height, :width].contiguous()
