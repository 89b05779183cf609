"""Fused painter composite (device half of the port): per-tile painter scan
+ shading + blending per bucket of tiles, gathering straight from resolved
chunk coverage.

Twin of the fused TPU formulation in vgtpu/ops/composite_pallas.py
(frame_fb_pallas -> composite_bucket_pallas -> _kernel_rows) in all its
forms: (a) ss=1 and (d) ss>1 over raw sub-row coverage, the per-entry
backdrop added in the composite; (e) over final resolved coverage
(ops/coverage_resolve.py); each with (b) per-tile init planes (a resident
layer the tiles start from, instead of the broadcast background) and (c)
k_rep variant blocks that share one block of coverage rows (raster/
batch.py).  On a CUDA tensor `composite_bucket` launches kernel K2
(csrc/composite.cu, via ops/composite_cuda.py); on a CPU tensor it runs the
plain torch twin.  `composite_bucket_flat`, the counterpart of vgtpu's flat
kernel over caller-gathered winding, launches kernel K7
(csrc/composite_flat.cu, via ops/composite_flat_cuda.py) on CUDA and the
same twin on the CPU.  Any other device raises.

composite_tiles_body / composite_bucketed_body are the plain torch twins
of vgtpu's XLA oracle composite, which its sharded paths run; they are no
kernel's twin, and only parallel/sharding.py and
raster/batch.VariantBatch.render_sharded take them.

Reference behaviour: the end() draw loop vg.cpp:1162-1287, the four shader
programs src/shaders/*.sc, and the stencil clip semantics vg.cpp:1193-1215.

Per-bucket static data (host-built by raster/frame.fused_tables):
  params: (MO, _npp(tile_h), NbP) f32 — per (slot, tile) metadata rows (_P_*)
  pteb:   (NbP, MO) i32 — coverage row per (tile, slot): the entry's primary
          chunk, or the dead row if none (rows of cov_final in form (e));
          one variant block of NbP/k_rep rows in form (c)
  ctile:  (NbP, MO) i32 — colour-tile id per (tile, slot) (NCT = zeros row),
          only for buckets whose texture lane is on
  ids:    (NbP,) i32 — framebuffer row per tile (pad rows: the scratch row)
  rbd:    (MO, RBR, NbP) f32 — form (e) only: resolved backdrop rows of the
          chunkless slots (raster/resolve.build_resolve_aux)
and the colour tiles every bucket's ctile indexes, ct_flat: (NCT+1,
4*NPX_OUT) f32 channel-major plus a zeros row, the layout this module owns
(color_tiles_flat, flat_color_tiles, color_tiles_view).
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


def color_tiles_flat(plan):
    """The plan's colour tiles in K2's layout: they live on the OUTPUT
    domain, (NCT, TH//ss, TW, 4) -> (NCT+1, 4*NPX_OUT) channel-major plus
    the zeros row that pad and untextured slots read.  Colour tiles the
    device sampler left on a device (a tensor) stay there: the result is
    flat_color_tiles' tensor on that device, with no copy through the host;
    numpy tiles give a numpy array."""
    ct = plan.color_tiles
    if isinstance(ct, torch.Tensor):
        return flat_color_tiles(ct)
    npx_out = (plan.tile_h // plan.supersample) * plan.tile_w
    ct = np.asarray(ct, np.float32)
    return np.concatenate([
        ct.transpose(0, 3, 1, 2).reshape(ct.shape[0], 4 * npx_out),
        np.zeros((1, 4 * npx_out), np.float32)])


def flat_color_tiles(ct: torch.Tensor) -> torch.Tensor:
    """(NCT, TH, TW, 4) colour tiles on a device -> (NCT+1, 4*TH*TW)
    channel-major plus the zeros row, on the same device.  Tiles that are
    color_tiles_view's view of a tensor in that layout (the sampler's
    output, S1's on CUDA) give that tensor back, no copy; other tiles are
    copied into a new one."""
    n, th, tw = ct.shape[:3]
    base = ct._base
    if (base is not None and base.shape == (n + 1, 4 * th * tw)
            and base.is_contiguous() and ct.data_ptr() == base.data_ptr()
            and ct.stride() == (4 * th * tw, tw, 1, th * tw)):
        return base
    flat = ct.new_zeros((n + 1, 4 * th * tw))
    flat[:n] = ct.permute(0, 3, 1, 2).reshape(n, -1)
    return flat


def color_tiles_view(flat: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """K2's layout, (NCT+1, 4*th*tw) channel-major plus the zeros row ->
    the (NCT, th, tw, 4) view of its tiles, no copy (flat_color_tiles'
    inverse)."""
    n = flat.shape[0] - 1
    return flat[:n].view(n, 4, th, tw).permute(0, 2, 3, 1)


_BACKGROUNDS: dict = {}    # (device, background) -> (4,) float32 tensor
_BACKGROUNDS_MAX = 16


def background_tensor(background: tuple, device) -> torch.Tensor:
    """The 4 background floats as a float32 tensor on `device`, uploaded
    once per (device, background) and kept (at most _BACKGROUNDS_MAX, the
    oldest dropped first).  A fresh torch.tensor(..., device=cuda) is a
    pageable host-to-device copy, which torch completes with a
    synchronisation of the current stream: uploaded per frame, it would make
    the host wait for the frame's coverage launches to drain before it
    could launch the first composite.  The tensor is only ever read."""
    key = (torch.device(device), tuple(float(v) for v in background))
    bg = _BACKGROUNDS.get(key)
    if bg is None:
        if len(_BACKGROUNDS) >= _BACKGROUNDS_MAX:
            del _BACKGROUNDS[next(iter(_BACKGROUNDS))]
        bg = torch.tensor(key[1], dtype=torch.float32, device=key[0])
        _BACKGROUNDS[key] = bg
    return bg


def _pad_tiles(nb: int) -> int:
    """Bucket row padding (copied from vgtpu/ops/composite_pallas.py, where
    the TPU lane blocks need it): buckets over 128 tiles pad to the next
    128-multiple.  Kept so both packages build identical bucket tables."""
    if nb <= 128:
        return nb
    return -(-nb // 128) * 128


def composite_bucket_torch(ew_t: torch.Tensor, params_t: torch.Tensor,
                           ct_t: torch.Tensor | None, bg_vec: torch.Tensor,
                           *, tile_w: int, flags: tuple, ss: int = 1,
                           cov_final: bool = False,
                           rbd_t: torch.Tensor | None = None,
                           k_rep: int = 1,
                           add_backdrop: bool = True) -> torch.Tensor:
    """One bucket's painter scan -> fb_t (4*NPX_OUT, k_rep*Nb),
    channel-major: the plain twin of vgtpu's composite_bucket_pallas and of
    kernels K2 and, at ss=1, K7.  Expressions follow _kernel_rows per pixel,
    in its order; vgtpu's flat kernel (_kernel) gives the same fb_t bit for
    bit (tests/test_torch_composite.py), so the twin stands for both.

    Form (a)/(d), cov_final=False: ew_t (MO, NPX, Nb) is raw SUB-row winding
    (NPX = TH*TW, TH = ss * output rows); add_backdrop adds the entry's
    per-sub-row backdrop rows (params rows _P_BD..), as the fused frame
    does; without it ew_t already holds entry winding with the backdrop
    (vgtpu's composite_bucketed_pallas_body).  Fill rule, AA, texture force,
    scissor and clip work per sub-row; the masked coverage of each group of
    ss sub-rows is summed in order and multiplied by 1/ss; shading and
    blending run once per output pixel.  At ss=1 this is form (a).

    Form (e), cov_final=True: ew_t (MO, NPX_OUT, Nb) is FINAL output-domain
    coverage (ops/coverage_resolve.py); chunkless slots add their resolved
    backdrop rows rbd_t (MO, RBR, Nb) times the x half of the scissor.  No
    rule, AA or clip work (clip buckets never take this form).

    bg_vec (4*NPX_OUT, 1) is the broadcast background column, or (form (b))
    a per-tile init plane (4*NPX_OUT, k_rep*Nb) the tiles start from.
    k_rep > 1 (form (c)): params_t, ct_t and the output have k_rep variant
    blocks of Nb lanes; every block reads the one block of ew_t (winding
    coverage is variant-invariant).  Not with cov_final.

    params_t (MO, NPP, k_rep*Nb); ct_t (MO, 4*NPX_OUT, k_rep*Nb) or None."""
    has_grad, has_tri, has_tex, has_clip, has_eo, has_noaa, has_scissor = flags
    if cov_final and (has_clip or rbd_t is None or k_rep != 1):
        raise ValueError("composite_bucket_torch: cov_final needs rbd rows, "
                         "no clip lane and k_rep=1")
    if k_rep > 1:
        ew_t = ew_t.repeat(1, 1, k_rep)
    mo, _rows, nb = ew_t.shape
    npx_out = bg_vec.shape[0] // 4
    th_out = npx_out // tile_w
    th = th_out * ss                          # sub-rows
    npx = th * tile_w
    inv_ss = 1.0 / ss
    dev = ew_t.device
    flat = torch.arange(npx_out, device=dev)
    pxl = (flat % tile_w).to(torch.float32)[:, None] + 0.5   # (NPX_OUT, 1)
    pyl_o = (flat // tile_w).to(torch.float32)[:, None] + 0.5
    if not cov_final:
        flat_s = torch.arange(npx, device=dev)
        pxl_s = (flat_s % tile_w).to(torch.float32)[:, None] + 0.5
        pyl_s = (flat_s // tile_w).to(torch.float32)[:, None] + 0.5

    out = bg_vec.expand(4 * npx_out, nb)
    fr, fg, fb_, fa = (out[i * npx_out : (i + 1) * npx_out] for i in range(4))
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
        ox = row(_P_OX)
        oy = row(_P_OY)
        if has_tex:
            is_quad_tex = pk == float(P_TEXTURE)
            use_ct = (row(_P_CTILE) > 0) & (is_quad_tex | (pk == float(P_IMAGE)))

        if cov_final:
            # final coverage; chunkless entries add their resolved backdrop
            # (x-constant per output row) times the x-scissor mask
            rbd = rbd_t[j][:th_out].repeat_interleave(tile_w, dim=0)
            if has_scissor:
                ins_x = ((pxl >= row(_P_SC) - ox)
                         & (pxl < row(_P_SC + 2) - ox)).to(torch.float32)
                c_out = ew_t[j] + rbd * ins_x
            else:
                c_out = ew_t[j] + rbd
            c_out = torch.where(valid > 0, c_out, 0.0)
        else:
            # per-sub-pixel backdrop row: sub-pixel p sits on sub-row p // tile_w
            w = ew_t[j]
            if add_backdrop:
                w = w + pp[_P_BD : _P_BD + th].repeat_interleave(tile_w, dim=0)
            cov = torch.clamp_max(torch.abs(w), 1.0)
            if has_eo:
                cov_eo = 1.0 - torch.abs(torch.remainder(w, 2.0) - 1.0)
                cov = torch.where(rule == 0, cov, cov_eo)
            if has_noaa:
                cov = torch.where(aa != 0, cov, (cov >= 0.5).to(torch.float32))
            if has_tex:
                cov = torch.where(is_quad_tex, 1.0, cov)
            if has_scissor:
                # sub-row centres against the sub-row scissor
                inside_y = (pyl_s >= row(_P_SC + 1) - oy) & (pyl_s < row(_P_SC + 3) - oy)
                inside = (pxl_s >= row(_P_SC) - ox) & inside_y & (pxl_s < row(_P_SC + 2) - ox)
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
            # sum the ss sub-rows of each output row in order, then 1/ss
            c = c.expand(npx, nb).reshape(th_out, ss, tile_w, nb)
            c_sum = c[:, 0]
            for k in range(1, ss):
                c_sum = c_sum + c[:, k]
            c_out = (c_sum * inv_ss).reshape(npx_out, nb)

        col_r, col_g, col_b, col_a = inner_r, inner_g, inner_b, inner_a
        if has_grad or has_tri:
            pxc = pxl + ox                     # (NPX_OUT, Nb) screen-space centres
            # paints are pixel-space: output rows sit at oy/ss (oy counts
            # sub-rows; 1/ss is a power of two, so the product is exact)
            pyc = oy * inv_ss + pyl_o
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
            ct = ct_t[j]                       # (4*NPX_OUT, Nb) channel-major
            src_r = torch.where(use_ct, ct[0:npx_out], col_r * col_a)
            src_g = torch.where(use_ct, ct[npx_out : 2 * npx_out], col_g * col_a)
            src_b = torch.where(use_ct, ct[2 * npx_out : 3 * npx_out], col_b * col_a)
            src_a = torch.where(use_ct, ct[3 * npx_out : 4 * npx_out], col_a)
        else:
            src_r = col_r * col_a
            src_g = col_g * col_a
            src_b = col_b * col_a
            src_a = col_a

        a = src_a * c_out
        one_minus_a = 1.0 - a
        fr = src_r * c_out + fr * one_minus_a
        fg = src_g * c_out + fg * one_minus_a
        fb_ = src_b * c_out + fb_ * one_minus_a
        fa = a + fa * one_minus_a
    return torch.cat([t.expand(npx_out, nb) for t in (fr, fg, fb_, fa)], dim=0)


def composite_bucket_flat(ew_t: torch.Tensor, params_t: torch.Tensor,
                          ct_t: torch.Tensor | None, bg_vec: torch.Tensor, *,
                          tile_w: int, flags: tuple, add_backdrop: bool = False,
                          k_rep: int = 1) -> torch.Tensor:
    """One bucket's painter scan over the flat (NPX, Nb) block -> fb_t
    (4*NPX, k_rep*Nb) channel-major: the counterpart of vgtpu's
    composite_bucket_pallas(variant="flat"), which has neither sub-rows nor
    final coverage, so ss is 1.  Kernel K7 on CUDA, the plain twin
    composite_bucket_torch on the CPU; any other device raises.

    ew_t (MO, NPX, Nb) winding, gathered by the caller; params_t (MO, NPP,
    k_rep*Nb); ct_t (MO, 4*NPX, k_rep*Nb) or None without the texture lane;
    bg_vec (4*NPX, 1) the background column or (4*NPX, k_rep*Nb) a per-tile
    init plane.  k_rep > 1 variant blocks share ew_t's one block and, as in
    vgtpu, need Nb % 128 == 0."""
    nb = ew_t.shape[2]
    if k_rep > 1 and nb % 128:
        raise ValueError(f"k_rep>1 requires 128-multiple lanes, got {nb}")
    dev = ew_t.device
    if dev.type == "cuda":
        from vgtpu_torch.ops.composite_flat_cuda import composite_bucket_flat_cuda

        return composite_bucket_flat_cuda(ew_t, params_t, ct_t, bg_vec,
                                          tile_w=tile_w, flags=tuple(flags),
                                          add_backdrop=add_backdrop, k_rep=k_rep)
    if dev.type == "cpu":
        return composite_bucket_torch(ew_t, params_t, ct_t, bg_vec,
                                      tile_w=tile_w, flags=tuple(flags),
                                      add_backdrop=add_backdrop, k_rep=k_rep)
    raise ValueError(f"composite_bucket_flat: unsupported device {dev}")


def composite_bucket_into_torch(fb, cov, pteb, params, ct_flat, ctile, ids,
                                background, *, tile_w: int, flags: tuple,
                                ss: int = 1, rbd=None, init: bool = False,
                                k_rep: int = 1, window=None) -> None:
    """Plain twin of K2 on the tensors' own device: gather the bucket's
    coverage (and colour tiles), run composite_bucket_torch, scatter the
    tiles into fb (T+1, TH//ss, TW, 4) in place at rows ids (the last row
    is the pad tiles' scratch row).  background: the 4 premultiplied RGBA
    floats.  cov is raw sub-row coverage (NC+1, TH*TW) (forms (a)/(d)), or
    final coverage (R, TH//ss*TW) when the bucket's resolved-backdrop rows
    rbd (MO, RBR, NbP) are given (form (e)).  init (form (b)): each tile
    starts from its own fb row, pad tiles from the background.  k_rep
    (form (c)): pteb holds one variant block, params/ctile/ids k_rep.
    window (ops/coverage.ViewWindow, forms (a) and (d)): fb is the view's
    output; only the tiles window.tiles holds are composited, each as it
    would be among all, and placed at its output position
    (ViewWindow.place), as K2 writes them."""
    nb = ids.shape[0]
    if pteb.shape[0] * k_rep != nb:
        raise ValueError(f"composite_bucket_into_torch: {nb} tiles for "
                         f"{pteb.shape[0]} coverage rows x k_rep={k_rep}")
    if window is not None:
        if init or k_rep != 1 or rbd is not None:
            raise ValueError("composite_bucket_into_torch: a view window takes "
                             "forms (a) and (d) only")
        keep = window.holds(ids.long()).nonzero().flatten()
        if not keep.numel():
            return
        pteb, params, ids = pteb[keep], params[:, :, keep], ids[keep]
        ctile = None if ctile is None else ctile[keep]
        nb = ids.shape[0]
    th_out = fb.shape[1] if window is None else window.th
    npx_out = th_out * tile_w
    ew_t = cov[pteb].permute(1, 2, 0)                       # (MO, NPX|NPX_OUT, NbP1)
    ct_t = ct_flat[ctile].permute(1, 2, 0) if flags[2] else None
    bg = torch.tensor(background, dtype=torch.float32, device=fb.device)
    bg_vec = bg.repeat_interleave(npx_out)[:, None]
    if init:
        plane = fb[ids].permute(3, 1, 2, 0).reshape(4 * npx_out, nb)
        bg_vec = torch.where(ids == fb.shape[0] - 1, bg_vec, plane)
    fb_t = composite_bucket_torch(ew_t, params, ct_t, bg_vec, tile_w=tile_w,
                                  flags=tuple(flags), ss=ss,
                                  cov_final=rbd is not None, rbd_t=rbd,
                                  k_rep=k_rep)
    tiles = fb_t.reshape(4, th_out, tile_w, nb).permute(3, 1, 2, 0)
    if window is None:
        fb[ids] = tiles
    else:
        window.place(fb, tiles, ids.long())


def composite_bucket(fb, cov, pteb, params, ct_flat, ctile, ids,
                     background, *, tile_w: int, flags: tuple, ss: int = 1,
                     rbd=None, init: bool = False, k_rep: int = 1,
                     window=None) -> None:
    """Composite one bucket into fb (T+1, TH//ss, TW, 4) in place (the
    update saves a per-bucket framebuffer copy): kernel K2 on CUDA, the plain
    twin on the CPU.  rbd given: form (e) over final coverage; init: form
    (b); k_rep > 1: form (c); window: into the view's output (forms (a)
    and (d))."""
    dev = fb.device
    kw = dict(tile_w=tile_w, flags=flags, ss=ss, rbd=rbd, init=init,
              k_rep=k_rep, window=window)
    if dev.type == "cuda":
        from vgtpu_torch.ops.composite_cuda import composite_bucket_cuda

        composite_bucket_cuda(fb, cov, pteb, params, ct_flat, ctile, ids,
                              background, **kw)
    elif dev.type == "cpu":
        composite_bucket_into_torch(fb, cov, pteb, params, ct_flat, ctile,
                                    ids, background, **kw)
    else:
        raise ValueError(f"composite_bucket: unsupported device {dev}")


def frame_fb(cov_all, bucket_ids, bucket_pteb, bucket_params, bucket_ctile,
             ct_flat, background, *, tile_h: int, tile_w: int, num_tiles: int,
             bucket_flags: tuple, bucket_fn=composite_bucket, ss: int = 1,
             cov_final_arr=None, bucket_rbd=None, init_tiles=None,
             k_rep: int = 1, window=None) -> torch.Tensor:
    """Fused frame composite -> (T, TH//ss, TW, 4) tiles: the twin of
    vgtpu's frame_fb_pallas.  Buckets gather straight from chunk coverage
    via the host-built primary-chunk ids; tiles no bucket covers keep the
    background (or their init tile).  tile_h counts sub-rows when ss > 1.

    init_tiles: optional (T, TH//ss, TW, 4) resident layer (the layer memo)
    the frame composites over: the framebuffer starts as a copy of it (plus
    the background scratch row) and every bucket takes form (b).

    k_rep > 1 (form (c), raster/batch.py): num_tiles counts all k_rep
    variants' tiles, each bucket's pteb one variant block.

    Without cov_final_arr every bucket takes form (a) (ss=1) or (d) over the
    raw sub-row cov_all, adding the entry backdrop in the composite.  With
    cov_final_arr / bucket_rbd (the resolve split, raster/resolve.py)
    cov_all holds only the RAW sub-row coverage, which the clip buckets read
    (form (d)); every other bucket's pteb indexes cov_final_arr (final
    output-domain coverage) and takes form (e) with its rbd rows.

    background is the 4 premultiplied RGBA floats; bucket_ids are padded to
    NbP with the scratch row num_tiles; bucket_fn is composite_bucket (K2 on
    CUDA) or composite_bucket_into_torch.

    window (ops/coverage.ViewWindow; forms (a) and (d), no init_tiles): the
    retained pan's view.  The result is then the view's output
    (window.out_shape()), filled with the background once; only the bucket
    rows of the window's tiles are composited, each straight into its
    output position, and no framebuffer of the scene is made."""
    background = tuple(float(v) for v in background)
    th_out = tile_h // ss
    bg = background_tensor(background, cov_all.device)
    if window is not None:
        if init_tiles is not None or cov_final_arr is not None or k_rep != 1:
            raise ValueError("frame_fb: a view window takes forms (a) and (d) only")
        if (window.th, window.tw) != (th_out, tile_w):
            raise ValueError(f"frame_fb: a window of {window.th}x{window.tw} "
                             f"tiles over {th_out}x{tile_w} output tiles")
        fb = torch.empty(window.out_shape(), dtype=torch.float32,
                         device=cov_all.device)
        fb.copy_(bg.expand(fb.shape))
    else:
        fb = torch.empty((num_tiles + 1, th_out, tile_w, 4), dtype=torch.float32,
                         device=cov_all.device)
        if init_tiles is None:
            fb.copy_(bg.expand(num_tiles + 1, th_out, tile_w, 4))
        else:
            if tuple(init_tiles.shape) != (num_tiles, th_out, tile_w, 4):
                raise ValueError(f"frame_fb: init_tiles {tuple(init_tiles.shape)}, "
                                 f"expected {(num_tiles, th_out, tile_w, 4)}")
            fb[:num_tiles].copy_(init_tiles)
            fb[num_tiles].copy_(bg.expand(th_out, tile_w, 4))
    if bucket_rbd is None:
        bucket_rbd = (None,) * len(bucket_pteb)
    for ids, pteb, pp, ctile, flags, rbd in zip(
        bucket_ids, bucket_pteb, bucket_params, bucket_ctile, bucket_flags,
        bucket_rbd,
    ):
        covf = cov_final_arr is not None and not flags[3]
        if covf and rbd is None:
            raise ValueError("frame_fb: a non-clip bucket of a resolve-split "
                             "plan has no rbd rows")
        bucket_fn(fb, cov_final_arr if covf else cov_all, pteb, pp, ct_flat,
                  ctile, ids, background, tile_w=tile_w, flags=tuple(flags),
                  ss=ss, rbd=rbd if covf else None,
                  init=init_tiles is not None, k_rep=k_rep, window=window)
    return fb if window is not None else fb[:num_tiles]


def _sdroundrect(ux, uy, ex, ey, rad):
    """fs_color_gradient.sc:12-18 (copied from vgtpu/ops/composite.py); the
    sqrt in float64, rounded once, as in composite_bucket_torch."""
    dx = torch.abs(ux) - (ex - rad)
    dy = torch.abs(uy) - (ey - rad)
    mx = torch.clamp_min(dx, 0.0)
    my = torch.clamp_min(dy, 0.0)
    return (torch.clamp_max(torch.maximum(dx, dy), 0.0)
            + torch.sqrt((mx * mx + my * my).double()).float() - rad)


def composite_tiles_body(entry_w, tile_entries, tile_ids, entry_kind,
                         entry_rule, entry_aa, entry_paint_kind, entry_paint,
                         entry_scissor, entry_color_tile, color_tiles,
                         background, *, ntx: int, tile_h: int, tile_w: int,
                         max_ops: int, lane_flags: tuple = (True,) * 7,
                         ss: int = 1, init_tiles=None) -> torch.Tensor:
    """The painter composite over whole tiles in plain torch: the twin of
    vgtpu's composite_tiles_body (its XLA oracle composite, which vgtpu's
    sharded frame runs on every platform).  This is not kernel K2's twin:
    it scans tile_entries slot by slot over (T, TH, TW) planes, and only the
    sharded frame (parallel/sharding.py) and VariantBatch.render_sharded
    take it.  Expressions follow vgtpu's in its order; the gradient's u/v
    take one FMA each and its sqrt runs in float64, the roundings of
    composite_bucket_torch.

    entry_w (NE, TH, TW) winding incl. backdrop; tile_entries (T, MAX_OPS)
    entry ids, -1 padded; tile_ids (T,) flat tile index (row * ntx + col);
    entry_* per-entry tables; color_tiles (NCT, TH//ss, TW, 4) premultiplied,
    on the output rows; background the 4 premultiplied RGBA floats.
    Returns (T, TH//ss, TW, 4) premultiplied tiles.

    lane_flags = (gradient, tri, texture, clip, evenodd, non_aa, scissor)
    leave out the lanes no entry of the call uses.  ss > 1: winding,
    coverage, scissor and clip live on tile_h sub-rows; the rule-applied
    coverage averages down to output rows before shading and blending.
    init_tiles: optional (T, TH//ss, TW, 4) initial values instead of the
    broadcast background."""
    has_grad, has_tri, has_tex, has_clip, has_eo, has_noaa = lane_flags[:6]
    has_scissor = lane_flags[6] if len(lane_flags) > 6 else True
    dev = entry_w.device
    th_out = tile_h // ss
    T = tile_entries.shape[0]
    tid = tile_ids.long()
    ox = ((tid % ntx) * tile_w).to(torch.float32)
    oy = ((tid // ntx) * tile_h).to(torch.float32)
    ix = torch.arange(tile_w, dtype=torch.float32, device=dev).expand(tile_h, tile_w)
    iy = torch.arange(tile_h, dtype=torch.float32, device=dev)[:, None].expand(tile_h, tile_w)
    # sub-row sample centres, scaled space: (T, TH, TW); scissors are scaled
    pxc = ox[:, None, None] + ix + 0.5
    pyc = oy[:, None, None] + iy + 0.5
    if ss == 1:
        pxc_o, pyc_o = pxc, pyc
    else:
        # output-pixel centres for shading (paints are pixel-space)
        pxc_o = ox[:, None, None] + ix[:th_out] + 0.5
        pyc_o = (oy / ss)[:, None, None] + iy[:th_out] + 0.5

    bg = torch.as_tensor(background, dtype=torch.float32, device=dev)
    if init_tiles is None:
        fb = bg.expand(T, th_out, tile_w, 4)
    else:
        fb = init_tiles.to(torch.float32)
    mask = torch.ones((T, tile_h, tile_w), dtype=torch.float32, device=dev)
    accum = torch.zeros((T, tile_h, tile_w), dtype=torch.float32, device=dev)

    for s in range(max_ops):
        eid = tile_entries[:, s].long()
        valid = (eid >= 0)[:, None, None]
        e = torch.clamp_min(eid, 0)

        w = entry_w[e]                                  # (T, TH, TW)
        kind = entry_kind[e][:, None, None]
        rule = entry_rule[e][:, None, None]
        aa = entry_aa[e][:, None, None]
        pk = entry_paint_kind[e][:, None, None]
        paint = entry_paint[e]                          # (T, 18)
        sc = entry_scissor[e]                           # (T, 4)

        is_quad_tex = pk == P_TEXTURE       # coverage lives in the colour tile
        if has_tex:
            has_ctile = (entry_color_tile[e] >= 0)[:, None, None]
            use_ctile = has_ctile & (is_quad_tex | (pk == P_IMAGE))
        cov = torch.clamp_max(torch.abs(w), 1.0)
        if has_eo:
            cov_eo = 1.0 - torch.abs(torch.remainder(w, 2.0) - 1.0)
            cov = torch.where(rule == 0, cov, cov_eo)
        if has_noaa:
            cov = torch.where(aa != 0, cov, (cov >= 0.5).to(torch.float32))
        if has_tex:
            cov = torch.where(is_quad_tex, 1.0, cov)
        if has_scissor:
            # scissor (pixel-centre test, like the GPU scissor rect)
            inside = ((pxc >= sc[:, 0, None, None]) & (pyc >= sc[:, 1, None, None])
                      & (pxc < sc[:, 2, None, None]) & (pyc < sc[:, 3, None, None]))
            cov = cov * inside.to(torch.float32)

        # shading, each lane gated by the call's lane flags
        inner = paint[:, None, None, 10:14]
        col = inner.expand(T, th_out, tile_w, 4)
        if has_grad:
            # gradient uv via the inverse paint matrix (vg.cpp:3712-3880)
            m = paint[:, 0:6, None, None]
            uxg = fma(m[:, 0], pxc_o, m[:, 2] * pyc_o) + m[:, 4]
            uyg = fma(m[:, 1], pxc_o, m[:, 3] * pyc_o) + m[:, 5]
            feather = torch.clamp_min(paint[:, 9, None, None], 1e-6)
            sd = _sdroundrect(uxg, uyg, paint[:, 6, None, None],
                              paint[:, 7, None, None], paint[:, 8, None, None])
            d = torch.clamp((sd + feather * 0.5) / feather, 0.0, 1.0)[..., None]
            grad = inner * (1.0 - d) + paint[:, None, None, 14:18] * d
            col = torch.where((pk == P_GRADIENT)[..., None], grad, col)
        if has_tri:
            # per-vertex-colour triangles: rgba(x, y) = A*x + B*y + C
            tri = (paint[:, None, None, 0:4] * pxc_o[..., None]
                   + paint[:, None, None, 4:8] * pyc_o[..., None]
                   + paint[:, None, None, 8:12])
            col = torch.where((pk == P_TRI)[..., None], tri, col)

        if has_tex:
            # textured entries: pre-sampled premultiplied colour tiles
            ct = color_tiles[torch.clamp_min(entry_color_tile[e], 0).long()]
            src_a = torch.where(use_ctile, ct[..., 3], col[..., 3])
            src_rgb = torch.where(use_ctile[..., None], ct[..., 0:3],
                                  col[..., 0:3] * col[..., 3:4])
        else:
            src_a = col[..., 3]
            src_rgb = col[..., 0:3] * col[..., 3:4]

        # op-kind state machine
        if has_clip:
            c = torch.where(valid & (kind == K_DRAW), cov * mask, 0.0)
        else:
            c = torch.where(valid, cov, 0.0)
        if ss > 1:
            # average the rule-applied sub-row coverage down to output rows,
            # the sub-rows summed in order
            c = c.reshape(T, th_out, ss, tile_w)
            c_sum = c[:, :, 0]
            for k in range(1, ss):
                c_sum = c_sum + c[:, :, k]
            c = c_sum / ss
        a = src_a * c
        fb = torch.cat([src_rgb * c[..., None] + fb[..., 0:3] * (1.0 - a)[..., None],
                        (a + fb[..., 3] * (1.0 - a))[..., None]], dim=-1)

        if has_clip:
            is_cadd = valid & (kind == K_CLIP_ADD)
            is_ccommit = valid & (kind == K_CLIP_COMMIT)
            is_creset = valid & (kind == K_CLIP_RESET)
            accum = torch.where(is_cadd, accum + cov, accum)
            committed = torch.where(rule == 0, accum > 0.5,
                                    ~(accum > 0.5)).to(torch.float32)
            mask = torch.where(is_ccommit, committed, mask)
            accum = torch.where(is_ccommit, 0.0, accum)
            mask = torch.where(is_creset, 1.0, mask)
    return fb


def composite_bucketed_body(entry_w, buckets, entry_kind, entry_rule,
                            entry_aa, entry_paint_kind, entry_paint,
                            entry_scissor, entry_color_tile, color_tiles,
                            background, *, ntx: int, tile_h: int, tile_w: int,
                            num_tiles: int, bucket_flags: tuple | None = None,
                            ss: int = 1, init_tiles=None) -> torch.Tensor:
    """composite_tiles_body over tiles grouped by op-count bucket (the twin
    of vgtpu's composite_bucketed_body): each bucket scans only as many
    painter slots as its busiest tile needs; op-free tiles keep the
    background (or their init tile).  buckets: [(tile_entries_b (Nb, MOb),
    tile_ids_b (Nb,))]; pad rows carry tile id num_tiles, a scratch row.
    Returns (num_tiles, TH//ss, TW, 4)."""
    dev = entry_w.device
    bg = torch.as_tensor(background, dtype=torch.float32, device=dev)
    th_out = tile_h // ss
    fb = bg.expand(num_tiles + 1, th_out, tile_w, 4).clone()
    if init_tiles is not None:
        fb[:num_tiles] = init_tiles
    if bucket_flags is None:
        bucket_flags = ((True,) * 7,) * len(buckets)
    for (te_b, ids_b), flags in zip(buckets, bucket_flags, strict=True):
        # gather the bucket's entries once, then scan its flat slot ids
        nb, mo = te_b.shape
        ef = torch.clamp_min(te_b, 0).reshape(-1).long()
        flat_ids = torch.arange(nb * mo, device=dev).reshape(nb, mo)
        flat_ids = torch.where(te_b >= 0, flat_ids, -1)
        ids = ids_b.long()
        fb[ids] = composite_tiles_body(
            entry_w[ef], flat_ids, ids_b, entry_kind[ef], entry_rule[ef],
            entry_aa[ef], entry_paint_kind[ef], entry_paint[ef],
            entry_scissor[ef], entry_color_tile[ef], color_tiles, bg,
            ntx=ntx, tile_h=tile_h, tile_w=tile_w, max_ops=mo,
            lane_flags=tuple(flags), ss=ss,
            init_tiles=None if init_tiles is None else fb[ids])
    return fb[:num_tiles]


def tiles_to_image(fb_tiles, *, ntx, nty, tile_h, tile_w, width, height):
    """(T, TH, TW, 4) -> (H, W, 4) cropped framebuffer."""
    img = fb_tiles.reshape(nty, ntx, tile_h, tile_w, 4)
    img = img.permute(0, 2, 1, 3, 4).reshape(nty * tile_h, ntx * tile_w, 4)
    return img[:height, :width].contiguous()
