# Copied from vgtpu/raster/retained.py: translate_ops, _op_fingerprints and
# _repack_ladder are the jax-free host half; the scene, its bake and its pan
# body are rewritten for the PyTorch device half.
"""Device-resident retained scenes with on-device panning (the port of
vgtpu/raster/retained.py).

A retained scene is a frame plan binned once over the scene bounds and kept
on the device; a translated view re-renders it with no host work on the
scene: no re-record, no re-bin, no upload of the plan.  Translation splits
into

  view origin (Vx, Vy)  =  whole tiles (vx, vy)  +  residual (rx, ry)

  * whole tiles: output tile (ty, tx) shows scene tile (ty+vy, tx+vx): the
    view window (ops/coverage.ViewWindow) of the scene's tiles;
  * the residual rx in [0, tile_w), ry in [0, tile_h) moves the content
    left/up by less than a tile.  The scene is binned with a pan margin
    (bin_frame_numpy(pan_margin=True)), so every tile's chunks already hold
    every edge that can reach it after the shift, and the analytic coverage
    is exact for any edge position: the shift is one subtract on the chunk
    edges.  Backdrops carry a 2*tile_h row window, so ry is a row offset.

Each pan frame runs the chunk-gather formulation, vgtpu's production pan
(its _render_pan_body with pan_chunk_gather), over the view window only:
the shifted pools through ops/coverage.cov_all_resolved (kernel K1 + the
extras fold on CUDA; K1 computes the chunks of the window's tiles, found
by the per-chunk scene tiles stored at bake), the per-offset backdrop
rows (_P_BD) and origin rows (_P_OX, _P_OY) patched into the bake-time
bucket params with one gather over tables concatenated at bake, textured
scenes resampled at the shifted origins (ops/sampling_device.
sample_tiles_flat: kernel S1 on CUDA, straight into K2's colour-tile
layout), then ops/composite.frame_fb over the window (kernel K2 per
bucket: form (a) at ss=1, form (d) on every bucket at ss>1, since the pan
does not split the resolve), which composites the bucket rows of the
window's tiles straight into the view's image or output tile grid, filled
once with the background.  vgtpu composites every scene tile into a
framebuffer and gathers the window from it; the images are the same, bit
for bit.  On CPU tensors the same calls take the plain twins.
use_pallas, vgtpu's keyword on render, render_tiles and render_views,
selects the route: None or True runs the kernels (on CUDA) and False the
plain twins, on any device.

The translated cached-list layer (api/command_list._layer_submit) renders
through PendingPanLayer: the pan body in its tiles-only form, the blend of
the transparent static overlay (_blend_over_tiles) and the suffix frame
over those tiles (raster/frame.execute_plan with init_tiles, K2 form (b)),
back to back on the current stream with the layer tiles kept on the device
(_pan_frame_fused).

Left out, as ROADMAP.md says: vgtpu's per-entry pan resolve
(VGTPU_PAN_ENTRY_RESOLVE), legacy entry-gather pan
(VGTPU_PAN_NO_CHUNKGATHER) and two-dispatch layer frame
(VGTPU_PAN_NO_FUSE), TPU experiments.
"""

from __future__ import annotations

import copy
import time
import zlib

import numpy as np
import torch

from vgtpu_torch.ops.composite import (
    _P_BD,
    _P_OX,
    _P_OY,
    build_bucket_aux,
    color_tiles_flat,
    composite_bucket_into_torch,
    frame_fb,
)
from vgtpu_torch.ops.coverage import (
    ViewWindow,
    cov_all_resolved,
    cov_all_resolved_torch,
)
from vgtpu_torch.raster.binning import (
    K_DRAW,
    P_GRADIENT,
    P_IMAGE,
    P_SOLID,
    P_TEXTURE,
    P_TRI,
    RasterOp,
    _bucket,
    bin_frame_numpy,
    compute_tile_buckets,
    expand_tri_batches,
    patch_entry_paint,
    scale_ops_y,
)
from vgtpu_torch.raster.frame import fused_tables


def translate_ops(ops: list[RasterOp], dx: float, dy: float) -> list[RasterOp]:
    """Translate recorded ops by (dx, dy) in screen space: geometry, scissor
    AND paints move together (unlike scale_ops_y, which keeps paints in pixel
    space).  Gradient/pattern paints store the INVERSE transform u = M.p + t
    (vg.cpp:3712-3931), so a scene translate is t -= M.d; tri paints store
    color planes c(p) = A.x + B.y + C, so C -= A*dx + B*dy."""
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
            q[:, 0] += dx    # p0; ex/ey direction vectors and uvs unchanged
            q[:, 1] += dy
            o.tex_quads = q

        def shift_paint(p, kind):
            p = np.asarray(p, np.float32).copy()
            if kind in (P_GRADIENT, P_IMAGE):
                # inverse paint transform u = M.p + t  ->  t -= M.d
                p[4] -= p[0] * dx + p[2] * dy
                p[5] -= p[1] * dx + p[3] * dy
            elif kind == P_TRI:
                p[8:12] -= p[0:4] * dx + p[4:8] * dy
            return p

        if o.paint is not None:
            o.paint = shift_paint(o.paint, o.paint_kind)
        if o.tri_paints is not None and len(o.tri_paints):
            tp = np.asarray(o.tri_paints, np.float32).copy()
            tp[:, 8:12] -= tp[:, 0:4] * dx + tp[:, 4:8] * dy
            o.tri_paints = tp
        out.append(o)
    return out


def _op_fingerprints(ops) -> list:
    """Per-op (structural_crc, paint_crc) pairs over PRE-translate ops —
    update_paint_values' structural-identity check (collisions are not
    adversarial here, same argument as Context._frame_fingerprint)."""
    out = []
    for op in ops:
        c = 0
        for a in (op.edges, op.tex_quads, op.tri_paints):
            if a is not None:
                a = np.asarray(a)
                if not a.flags.c_contiguous:
                    a = np.ascontiguousarray(a)
                c = zlib.crc32(a, c)
        c ^= hash((op.kind, op.fill_rule, op.aa, op.paint_kind,
                   op.image_id, op.scissor)) & 0xFFFFFFFF
        p = 0
        if op.paint is not None:
            p = zlib.crc32(np.ascontiguousarray(
                np.asarray(op.paint, np.float32)))
        out.append((c, p))
    return out


def _repack_ladder(chunk_pools, num_entries: int, ladder=(2, 4, 8, 24)):
    """Repack the numpy binner's single fixed-size chunk pool into the
    finer slot ladder the coverage kernels like (one-time, at bake): each
    entry's live edges, in (chunk, slot) order, are cut into blocks of the
    largest size while more than that remains, the rest into the smallest
    size that holds it; each pool keeps its blocks in entry order.  Order
    within an entry may change — coverage is a sum."""
    ladder = sorted(ladder)
    big = ladder[-1]
    # every live edge of a real entry, grouped by entry in (chunk, slot) order
    ents, edges = [], []
    for ce, cent in chunk_pools:
        live = np.abs(ce[:, :, 3] - ce[:, :, 1]) > 1e-12
        ent = np.broadcast_to(cent[:, None], live.shape)
        keep = live & (ent >= 0) & (ent < num_entries)
        ents.append(ent[keep].astype(np.int64))
        edges.append(ce[keep])
    ent = np.concatenate(ents) if ents else np.zeros(0, np.int64)
    edges = np.concatenate(edges) if edges else np.zeros((0, 4), np.float32)
    order = np.argsort(ent, kind="stable")
    ent, edges = ent[order], edges[order]
    # blocks: per entry, (n - 1) // big full blocks, then the rest
    uniq, first, n = np.unique(ent, return_index=True, return_counts=True)
    nfull = (n - 1) // big
    rest = n - nfull * big
    rest_size = np.asarray(ladder)[np.searchsorted(ladder, rest)]
    nblk = nfull + 1
    b_ent = np.repeat(np.arange(len(uniq)), nblk)
    b_k = np.arange(int(nblk.sum())) - np.repeat(np.cumsum(nblk) - nblk, nblk)
    b_start = first[b_ent] + b_k * big
    last = b_k == nfull[b_ent]
    b_take = np.where(last, rest[b_ent], big)
    b_size = np.where(last, rest_size[b_ent], big)
    out = []
    for size in ladder:
        sel = np.nonzero(b_size == size)[0]          # in entry order
        nc = _bucket(max(len(sel), 1))
        ce = np.zeros((nc, size, 4), np.float32)
        cent = np.full(nc, num_entries - 1, np.int32)
        if len(sel):
            take = b_take[sel]
            blk = np.repeat(np.arange(len(sel)), take)
            slot = np.arange(int(take.sum())) - np.repeat(np.cumsum(take) - take, take)
            ce[blk, slot] = edges[np.repeat(b_start[sel], take) + slot]
            cent[: len(sel)] = uniq[b_ent[sel]].astype(np.int32)
        out.append((ce, cent))
    return out


def _patch_tables(params_l, te_pads, ne: int, th: int) -> dict:
    """Flat positions, in the concatenated params buffer, of every bucket's
    _P_OX and _P_OY rows and _P_BD rows, the base values of the origin rows,
    and each backdrop position's source in the flattened (NE+1, 2*th)
    backdrop window table (its entry's row, or the appended zeros row NE for
    invalid and pad slots) at ry = 0.  A pan frame then patches every
    bucket with one gather and one copy (RetainedScene._patch_params)."""
    ox_pos, oy_pos, bd_pos, bd_src = [], [], [], []
    off = 0
    r = np.arange(th, dtype=np.int64)
    for pp, te_p in zip(params_l, te_pads):
        mo, npp, nb = pp.shape
        j = np.arange(mo, dtype=np.int64)[:, None]
        n = np.arange(nb, dtype=np.int64)[None, :]
        ox_pos.append((off + (j * npp + _P_OX) * nb + n).ravel())
        oy_pos.append((off + (j * npp + _P_OY) * nb + n).ravel())
        # (MO, th, NbP): slot j, backdrop row r, lane n
        bd_pos.append((off + (j[:, :, None] * npp + _P_BD + r[None, :, None]) * nb
                       + n[:, None, :]).ravel())
        e = np.where(te_p >= 0, te_p, ne).T.astype(np.int64)      # (MO, NbP)
        bd_src.append((e[:, None, :] * (2 * th) + r[None, :, None]).ravel())
        off += pp.size
    cat = (lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int64))
    ox_pos, oy_pos = cat(ox_pos), cat(oy_pos)
    flat = (np.concatenate([pp.ravel() for pp in params_l]) if params_l
            else np.zeros(0, np.float32))
    return {"pos": np.concatenate([ox_pos, oy_pos, cat(bd_pos)]),
            "ox_base": flat[ox_pos], "oy_base": flat[oy_pos],
            "bd_src": cat(bd_src), "flat": flat}


class RetainedScene:
    """A baked, device-resident scene renderable at any view offset without
    host work on the scene: integer (or fractional-x: smooth horizontal
    scrolling) offsets in render() and render_views().  Build with
    `bake(ctx)` after recording a frame (begin ... draw calls ... bake
    instead of end); the scene lives on ctx.device.  Its renders report
    the pan's stages to `profiler`, the baking context's (`ctx.profiler`)."""

    def __init__(self, plan, d: dict, device, out_w: int, out_h: int,
                 background, off=(0, 0), *, profiler):
        self.plan = plan
        self.profiler = profiler
        self.d = d
        self.device = torch.device(device)
        self.out_w = out_w
        self.out_h = out_h
        self.background = tuple(float(v) for v in background)
        self.tile_w = plan.tile_w
        self.tile_h = plan.tile_h      # SUB-rows (pixel rows * supersample)
        self.ss = int(plan.supersample)
        self.off = off          # baked-grid origin in view coords (PIXEL tile-multiples)
        self.samp_meta = None   # sampling-group signature (textured scenes)
        self.samp_nct = 0
        self._ops_fp = None       # per-op (structural, paint) crc pairs
        self._op_solid_cls = None  # per-op solid alpha>=1 class at bake

    @staticmethod
    def bake(ctx, scene_width: int | None = None, scene_height: int | None = None,
             background=(1.0, 1.0, 1.0, 1.0), ops=None) -> "RetainedScene":
        """Bin the recorded frame over the scene bounds with pan margins and
        upload it to ctx.device.  The scene may be larger than the viewport
        (content scrolled into view must be binned); view offsets beyond it
        show background.

        ops: optional already-FINALIZED op list to bake instead of ctx.ops
        (ctx still provides config + texture/font access)."""
        ss = int(ctx.cfg.coverage_supersample)
        if ops is None:
            ctx._finalize_ops()
            ops = ctx.ops
        scene_w = int(scene_width or ctx.fb_width)
        scene_h = int(scene_height or ctx.fb_height)
        tw, th = ctx.cfg.tile_w, ctx.cfg.tile_h
        ops = expand_tri_batches(ops)
        for op in ops:
            if isinstance(op.edges, list):
                op.edges = np.concatenate(op.edges, axis=0)
        # ops recorded under the untouched viewport default scissor carry
        # scissor=None (Context._op_scissor) and pan freely; explicit
        # setScissor rects ride scene space.  The baked grid covers the
        # CONTENT bbox (plus a 1-tile border so sub-tile residuals at the
        # edges stay in-grid), not just the viewport
        xmin = ymin = 0.0
        xmax, ymax = float(scene_w), float(scene_h)
        for o in ops:
            if o.edges is not None and len(o.edges):
                e = np.asarray(o.edges)
                xmin = min(xmin, float(e[:, [0, 2]].min()) - 2.0)
                xmax = max(xmax, float(e[:, [0, 2]].max()) + 2.0)
                ymin = min(ymin, float(e[:, [1, 3]].min()) - 2.0)
                ymax = max(ymax, float(e[:, [1, 3]].max()) + 2.0)
            if o.tex_quads is not None and len(o.tex_quads):
                q = np.asarray(o.tex_quads, np.float64)
                cx = np.concatenate([q[:, 0], q[:, 0] + q[:, 2],
                                     q[:, 0] + q[:, 4],
                                     q[:, 0] + q[:, 2] + q[:, 4]])
                cy = np.concatenate([q[:, 1], q[:, 1] + q[:, 3],
                                     q[:, 1] + q[:, 5],
                                     q[:, 1] + q[:, 3] + q[:, 5]])
                xmin = min(xmin, float(cx.min()) - 2.0)
                xmax = max(xmax, float(cx.max()) + 2.0)
                ymin = min(ymin, float(cy.min()) - 2.0)
                ymax = max(ymax, float(cy.max()) + 2.0)
        offx = tw * (1 + int(np.ceil(-xmin / tw)))
        offy = th * (1 + int(np.ceil(-ymin / th)))
        # fingerprints PRE-translate, so update_paint_values compares
        # re-records without re-translating; paint alpha (row 13) is
        # translate-invariant, so the solid class is captured here too
        ops_fp = _op_fingerprints(ops)
        solid_cls = [
            (op.paint is not None
             and float(np.asarray(op.paint)[13]) >= 1.0)
            for op in ops
        ]
        ops = translate_ops(ops, float(offx), float(offy))
        # supersampled scenes: translate in PIXEL space, then scale y
        # geometry into sub-rows as the frame path does and bin on tile_h*ss
        # sub-rows; plan.height stays the pixel height.  The sampler reads
        # the unscaled ops (quads live in output pixels)
        plan_h = int(np.ceil(ymax)) + offy
        ops_px = ops
        if ss > 1:
            ops = scale_ops_y(ops, ss)
        plan = bin_frame_numpy(
            ops, int(np.ceil(xmax)) + offx, plan_h * ss,
            tile_h=th * ss, tile_w=tw,
            chunk=ctx.cfg.edges_per_chunk, pan_margin=True)
        plan.height = plan_h
        plan.supersample = ss
        if ss > 1 and plan.color_tiles.shape[1] != th:
            plan.color_tiles = np.zeros((1, th, tw, 4), np.float32)
        # view_static: occlusion culling in its view-invariant form; the
        # context's depth cap, its cuts counted on the context's profiler
        plan.depth_cap = ctx.cfg.max_ops_per_tile_cap
        plan.tile_buckets = compute_tile_buckets(
            plan.tile_entries, plan.tile_entries.shape[0], plan.entry_kind,
            plan=plan, view_static=True, profiler=ctx.profiler)
        ne = plan.entry_backdrop.shape[0]
        plan.chunk_pools = _repack_ladder(
            plan.chunk_pools, ne, ladder=ctx.cfg.chunk_pools)
        plan.stats["chunks"] = sum(len(ce) for ce, _ in plan.chunk_pools)
        dev = torch.device(ctx.device)

        # textured/text layers: colour tiles are tile-local, so every view
        # RESAMPLES them; the bake uploads the sampling groups (with the
        # reachable-window pair set) and the textures, in stage
        # bake.textures; counter texture_bytes: the textures' device bytes
        samp = None
        n_real = plan.n_real_entries
        pk = plan.entry_paint_kind[:n_real]
        if ((pk == P_IMAGE) | (pk == P_TEXTURE)).any():
            from vgtpu_torch.ops.sampling_device import build_sampling_plan, upload_groups

            with ctx.profiler.stage("bake.textures"):
                image_map = {
                    idx: (img.data, img.flags, img.generation)
                    for idx, img in ctx.images.items()
                }
                if ctx.font_system is not None:
                    image_map.update(ctx.font_system.atlas_image_map())
                sp = build_sampling_plan(plan, ops_px, image_map, pan_margin=True)
                if sp.num_tiles:
                    tex = ctx._device_textures(image_map, {g.image_id for g in sp.groups})
                    samp = upload_groups(sp, (tex[g.image_id] for g in sp.groups), dev,
                                         (th, tw))
                    ctx.profiler.counters["texture_bytes"] = sum(
                        t.numel() * t.element_size() for t in tex.values())
        nct = samp.num_tiles if samp is not None else plan.color_tiles.shape[0]
        # the view-invariant tables over the plan's own pools, which the
        # bake does not compact (vgtpu's bake does not either)
        host = fused_tables(plan, nct)
        pt = _patch_tables(host["params"], host["te"], ne, th * ss)

        def put(x):
            return torch.as_tensor(x).to(dev)

        edges = np.concatenate([ce.reshape(-1, 4) for ce, _cent in plan.chunk_pools])
        chunk_tiles = _chunk_tiles(plan)
        bd_pan = np.concatenate([plan.entry_backdrop_pan,
                                 np.zeros((1, 2 * th * ss), np.float32)])
        d = {
            "edges": put(edges),
            "pool_shapes": [tuple(ce.shape) for ce, _cent in plan.chunk_pools],
            "cov_map": {k: put(host["cov_map"][k])
                        for k in ("extra_chunk", "extra_primary")},
            "bd_pan": put(bd_pan.reshape(-1)),
            "bd_src": put(pt["bd_src"]),
            "patch_pos": put(pt["pos"]),
            "ox_base": put(pt["ox_base"]),
            "oy_base": put(pt["oy_base"]),
            "params": put(pt["flat"]),
            "param_shapes": [pp.shape for pp in host["params"]],
            "bucket_ids": [put(x) for x in host["ids"]],
            "bucket_pteb": [put(x) for x in host["pteb"]],
            "bucket_ctile": [None if x is None else put(x) for x in host["ctile"]],
            "bucket_flags": tuple(host["flags"]),
            "chunk_tiles": [put(t) for t in chunk_tiles],
            "ux": put(np.array([1, 0, 1, 0], np.float32)),
            "uy": put(np.array([0, 1, 0, 1], np.float32)),
        }
        d["bucket_params"] = _param_views(d["params"], d["param_shapes"])
        d["counts"] = _pan_count_tables(plan, chunk_tiles)
        if samp is None:
            d["ct_flat"] = put(color_tiles_flat(plan))
        else:
            d["samp"] = samp
        scene = RetainedScene(plan, d, dev, ctx.fb_width, ctx.fb_height,
                              background, off=(offx, offy), profiler=ctx.profiler)
        scene._ops_fp = ops_fp
        scene._op_solid_cls = solid_cls
        if samp is not None:
            scene.samp_meta = samp.meta
            scene.samp_nct = samp.num_tiles
        return scene

    def update_paint_values(self, ctx) -> None:
        """Patch solid/gradient paint VALUES into the baked scene — the
        pan-plus-colour-animation pattern (a scrolling map with pulsing
        markers).  Record the scene again through the same context (same
        geometry, draw order, scissors, texture content; only solid/gradient
        paint values may differ), then call this instead of re-baking: the
        binned plan, coverage chunks and sampling groups are reused; only
        the paint table and the base params refresh (one host build and one
        upload).  The structural check is per-op crc fingerprints."""
        if self._ops_fp is None:
            raise ValueError("this scene was baked without retained "
                             "fingerprints")
        ctx._finalize_ops()
        ops2 = expand_tri_batches(ctx.ops)
        for op in ops2:
            if isinstance(op.edges, list):
                op.edges = np.concatenate(op.edges, axis=0)
        fp2 = _op_fingerprints(ops2)
        old = self._ops_fp
        if len(fp2) != len(old):
            raise ValueError(
                f"scene structure changed: {len(old)} -> {len(fp2)} draws")
        changed = []
        for i, ((s1, p1), (s2, p2)) in enumerate(zip(old, fp2)):
            if s1 != s2:
                raise ValueError(f"draw {i} changed structurally; only "
                                 "solid/gradient paint values may differ")
            if p1 == p2:
                continue
            op = ops2[i]
            if not (op.kind == K_DRAW
                    and op.paint_kind in (P_SOLID, P_GRADIENT)
                    and op.paint is not None):
                raise ValueError(
                    f"draw {i}: only solid/gradient paint VALUES can be "
                    "patched into a retained scene (texture/text tints need "
                    "a re-bake)")
            # occlusion covers are NonZero solids with alpha>=1 (the
            # binner's solid_opaque test): only those classes must hold
            if (op.paint_kind == P_SOLID and op.fill_rule == 0
                    and self._op_solid_cls[i]
                    != (float(np.asarray(op.paint)[13]) >= 1.0)):
                raise ValueError(
                    f"draw {i}: opacity-class flip would invalidate the "
                    "bake's view-invariant occlusion culling")
            changed.append(i)
        self._ops_fp = fp2
        if not changed:
            return
        # translate ONLY the changed ops (gradient rows carry scene-space
        # inverse transforms; solid rows are translate-invariant)
        tr = translate_ops([ops2[i] for i in changed],
                           float(self.off[0]), float(self.off[1]))
        new_rows = np.stack([np.asarray(o.paint, np.float32) for o in tr])
        plan = self.plan
        patch_entry_paint(plan, len(ops2), changed, new_rows)
        params = [build_bucket_aux(plan, te_b)[0] for te_b, _ids, _fl in plan.tile_buckets]
        flat = (np.concatenate([pp.ravel() for pp in params]) if params
                else np.zeros(0, np.float32))
        # in place: the bucket params are views of this buffer
        self.d["params"].copy_(torch.as_tensor(flat))

    # -- views ---------------------------------------------------------------
    def _offsets(self, view_x, view_y) -> tuple:
        """(vx, vy, rx, ry) of a view: whole tiles, the float32 x residual
        in pixels and the y residual in sub-rows."""
        vy, ry = self._view_y_subrows(view_y)
        ox = float(view_x) + self.off[0]
        vx = int(np.floor(ox / self.tile_w))
        rx = float(np.float32(ox - vx * self.tile_w))
        return vx, vy, rx, ry

    def render(self, view_x: float = 0, view_y: float = 0,
               use_pallas: bool | None = None) -> torch.Tensor:
        """Premultiplied (out_h, out_w, 4) of the scene viewed at offset
        (view_x, view_y): output pixel (x, y) shows scene point
        (view_x + x, view_y + y).  All device work on the scene's device:
        kernels K1 and K2 on CUDA; use_pallas=False (vgtpu's switch to its
        plain XLA path), or a CPU scene, the plain twins.

        view_x may be FRACTIONAL (smooth horizontal scrolling): backdrop
        rows are x-shift-invariant and the coverage is analytic in edge
        position.  view_y must be a multiple of 1/supersample (whole
        sub-rows: integer pixels at ss=1, quarter pixels at ss=4)."""
        return self._render(*self._offsets(view_x, view_y), self.background,
                            plain=use_pallas is False)

    def render_tiles(self, view_x: float = 0, view_y: float = 0,
                     background=None, use_pallas: bool | None = None) -> torch.Tensor:
        """The view as its OUTPUT TILE GRID (nty_o*ntx_o, th, tw, 4), the
        init_tiles contract of raster/frame.execute_plan.  Same offset and
        use_pallas semantics as render(); background: what off-scene tiles
        show (defaults to the bake background)."""
        bg = self.background if background is None else tuple(background)
        return self._render(*self._offsets(view_x, view_y), bg,
                            plain=use_pallas is False, tiles_only=True)

    def render_views(self, views, use_pallas: bool | None = None) -> torch.Tensor:
        """V viewports of the scene -> (V, out_h, out_w, 4): each view as
        render() gives it, stacked (vgtpu scans them in one dispatch; here
        the views run back to back on the scene's stream).  views: a
        non-empty sequence of (view_x, view_y) offsets; use_pallas as in
        render()."""
        views = np.asarray(views, np.float64)
        if views.ndim != 2 or views.shape[1] != 2 or not len(views):
            raise ValueError(
                "views must be a non-empty sequence of (view_x, view_y) pairs")
        offs = [self._offsets(x, y) for x, y in views]
        return torch.stack([self._render(*o, self.background,
                                         plain=use_pallas is False)
                            for o in offs])

    def _view_y_subrows(self, view_y) -> tuple[int, int]:
        """(whole-tile, sub-row residual) of a pixel-space vertical offset.
        Representable offsets are whole SUB-rows: multiples of 1/ss pixels
        (backdrop row windows are per sub-row; the texture resample shifts
        by ry/ss output pixels)."""
        oys = (float(view_y) + self.off[1]) * self.ss
        if abs(oys - round(oys)) > 1e-6:
            raise ValueError(
                "fractional view_y is only representable in whole sub-rows "
                f"(multiples of 1/{self.ss} px at coverage_supersample="
                f"{self.ss}); backdrop row windows are piecewise-linear in y")
        return divmod(int(round(oys)), self.tile_h)

    # -- the pan body ----------------------------------------------------------
    def _patch_params(self, rx: float, ry: int) -> None:
        """The per-offset rows of every bucket's params, in place: _P_OX +=
        rx and _P_OY += ry on the base origins, and the _P_BD rows from the
        backdrop window's rows ry .. ry+th, gathered for every (bucket,
        slot, row, lane) at once (invalid and pad slots read the zeros
        row)."""
        d = self.d
        bd = d["bd_pan"].index_select(0, d["bd_src"] + ry)
        vals = torch.cat([d["ox_base"] + rx, d["oy_base"] + float(ry), bd])
        d["params"].index_copy_(0, d["patch_pos"], vals)

    def _window(self, vx: int, vy: int, tiles_only: bool = False) -> ViewWindow:
        """The view window at whole-tile offset (vx, vy): the output's
        tiles over the scene grid, and its layout, the (out_h, out_w)
        image or (tiles_only) the output tile grid."""
        th_out = self.tile_h // self.ss
        return ViewWindow(vx, vy, -(-self.out_w // self.tile_w),
                          -(-self.out_h // th_out), self.plan.ntx, self.plan.nty,
                          th_out, self.tile_w,
                          0 if tiles_only else self.out_w,
                          0 if tiles_only else self.out_h)

    def _shifted_pools(self, rx: float, ry: int) -> list:
        """The chunk pools at residual (rx, ry): the content moves left/up
        by (rx, ry); pad rows keep y0 == y1, so they still add exactly
        zero."""
        d = self.d
        edges = d["edges"].sub(d["ux"], alpha=rx).sub_(d["uy"], alpha=float(ry))
        pools, k0 = [], 0
        for shape in d["pool_shapes"]:
            n = shape[0] * shape[1]
            pools.append(edges[k0 : k0 + n].view(shape))
            k0 += n
        return pools

    def _pan_inputs(self, rx: float, ry: int, window: ViewWindow | None = None,
                    plain: bool = False) -> tuple:
        """The composite's inputs at residual (rx, ry): the folded chunk
        coverage of the shifted pools (K1 + the fold, or the plain twin),
        over a view window only the rows of its tiles and the dead row
        (the others unspecified), else every row, and the colour tiles in K2's
        layout (resampled at the shifted tile origins when the scene is
        textured); the bucket params are patched in place for this offset.
        Stages pan.shift, pan.coverage, pan.patch and pan.resample."""
        d = self.d
        th, tw, ss = self.tile_h, self.tile_w, self.ss
        stage = self.profiler.stage
        with stage("pan.shift"):
            pools = self._shifted_pools(rx, ry)
        with stage("pan.coverage"):
            resolve = cov_all_resolved_torch if plain else cov_all_resolved
            cov = resolve(pools, d["cov_map"], th, tw, window,
                          None if window is None else d["chunk_tiles"])
        with stage("pan.patch"):
            self._patch_params(rx, ry)
        if self.samp_meta is None:
            return cov, d["ct_flat"]
        from vgtpu_torch.ops.sampling_device import sample_tiles_flat

        with stage("pan.resample"):
            # the sampler works on OUTPUT pixels: the y residual is ry/ss
            return cov, sample_tiles_flat(d["samp"], shift=(rx, ry / ss), plain=plain,
                                          profiler=self.profiler)

    def _render(self, vx: int, vy: int, rx: float, ry: int, background,
                plain: bool = False, tiles_only: bool = False) -> torch.Tensor:
        """One pan frame over the view window: vgtpu's chunk-gather pan body
        (_render_pan_body with pan_chunk_gather) and its window, in one
        pass; stage pan, holding the stages of _pan_inputs and
        pan.composite, and the counters pan_tiles, pan_entries and
        pan_edges of the window's tiles (_pan_count_tables: four lookups
        of host integers each, no read of the device)."""
        d, plan = self.d, self.plan
        th, tw, ss = self.tile_h, self.tile_w, self.ss
        stage = self.profiler.stage
        window = self._window(vx, vy, tiles_only)
        x0, y0, x1, y1 = window.tiles
        for name, p in d["counts"]:
            self.profiler.count(name, int(p[y1, x1] - p[y0, x1] - p[y1, x0] + p[y0, x0]))
        with stage("pan"):
            cov, ct_flat = self._pan_inputs(rx, ry, window, plain)
            kw = {"bucket_fn": composite_bucket_into_torch} if plain else {}
            with stage("pan.composite"):
                return frame_fb(cov, d["bucket_ids"], d["bucket_pteb"], d["bucket_params"],
                                d["bucket_ctile"], ct_flat, background, tile_h=th,
                                tile_w=tw, num_tiles=plan.ntx * plan.nty,
                                bucket_flags=d["bucket_flags"], ss=ss, window=window,
                                **kw)


def _chunk_tiles(plan) -> list:
    """Each pool's (NC,) int32 scene tile of its chunks (ty * ntx + tx): the
    tile of the chunk's entry, an (op, tile) pair.  Pad chunks belong to
    the last entry, and take its tile."""
    ne = plan.entry_tile.shape[0]
    return [plan.entry_tile[np.clip(cent, 0, ne - 1)].astype(np.int32)
            for _ce, cent in plan.chunk_pools]


def _pan_count_tables(plan, chunk_tiles) -> tuple:
    """2-D prefix sums over the scene grid, (NTY+1, NTX+1) each, of what a
    view adds to its counters: the scene tiles K2 writes (pan_tiles: real
    rows of the tile buckets), the (op, tile) entries it composites there
    (pan_entries) and the edge rows K1 walks (pan_edges: every slot of the
    tile's chunks, padding included).  A view's count over scene columns
    [x0, x1) and rows [y0, y1) is p[y1, x1] - p[y0, x1] - p[y1, x0] +
    p[y0, x0]."""
    n_tiles = plan.ntx * plan.nty
    grids = {k: np.zeros(n_tiles, np.int64) for k in ("tiles", "entries", "edges")}
    for te_b, ids, _flags in plan.tile_buckets:
        real = ids < n_tiles
        np.add.at(grids["tiles"], ids[real], 1)
        np.add.at(grids["entries"], ids[real], (te_b[real] >= 0).sum(axis=1))
    for (ce, _cent), t in zip(plan.chunk_pools, chunk_tiles):
        np.add.at(grids["edges"], t, ce.shape[1])
    out = []
    for key in ("tiles", "entries", "edges"):
        p = np.zeros((plan.nty + 1, plan.ntx + 1), np.int64)
        p[1:, 1:] = grids[key].reshape(plan.nty, plan.ntx).cumsum(0).cumsum(1)
        out.append(("pan_" + key, p))
    return tuple(out)


def _param_views(flat: torch.Tensor, shapes) -> list:
    """The buckets' (MO, NPP, NbP) params as contiguous views of the
    concatenated buffer (each block a multiple of 8 floats, so every view
    keeps the buffer's 16-byte alignment)."""
    out, k0 = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(flat[k0 : k0 + n].view(shape))
        k0 += n
    return out


def measure_pan_ms_per_frame(scene: RetainedScene, reps_hi: int = 32,
                             reps_lo: int = 2) -> float:
    """Device ms per pan frame: loops of reps_hi and reps_lo renders of a
    scrolling view (vgtpu's sequence: frame i at view_x = 37 i mod span_x,
    view_y = 23 i mod span_y sub-rows, spans over the scene's tiles beyond
    the viewport), timed with CUDA events on a CUDA scene (the host clock
    on the CPU); (t(reps_hi) - t(reps_lo)) / (reps_hi - reps_lo), so the
    fixed cost of a timed window cancels."""
    if reps_hi <= reps_lo:
        raise ValueError(f"reps_hi {reps_hi} must exceed reps_lo {reps_lo}")
    tw, th = scene.tile_w, scene.tile_h
    th_px = th // scene.ss
    ntx_o = -(-scene.out_w // tw)
    nty_o = -(-scene.out_h // th_px)
    span_x = max(scene.plan.ntx - ntx_o, 1) * tw
    span_y = max(scene.plan.nty - nty_o, 1) * th
    offx_t, offy_t = scene.off[0] // tw, scene.off[1] // th_px

    def frames(n):
        for i in range(n):
            view_x, view_y = (i * 37) % span_x, (i * 23) % span_y
            scene._render(view_x // tw + offx_t, view_y // th + offy_t,
                          float(view_x % tw), view_y % th, scene.background)

    dev = scene.device

    def run(n: int) -> float:
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                frames(n)
                b.record()
                b.synchronize()
            return a.elapsed_time(b)
        t0 = time.perf_counter()
        frames(n)
        return (time.perf_counter() - t0) * 1e3

    run(reps_lo)          # warm-up
    lo = run(reps_lo)
    hi = run(reps_hi)
    return (hi - lo) / (reps_hi - reps_lo)


def _blend_over_tiles(over, base):
    """Premultiplied src-over of a baked transparent layer over per-frame
    tiles: out = over + base * (1 - over_alpha)."""
    return over + base * (1.0 - over[..., 3:4])


def _pan_frame_fused(scene, offsets, layer_bg, plan, device_arrays,
                     background, over=None) -> torch.Tensor:
    """The translated cached-list frame: the scene's pan body at `offsets`
    ((vx, vy, rx, ry), RetainedScene._offsets) in its tiles-only form over
    layer_bg, the transparent overlay tiles `over` blended on top, then the
    frame plan's dynamic suffix composited over them (execute_plan
    init_tiles: K1, K3 at ss>1, K2 form (b) on CUDA).  vgtpu compiles the
    three into one program; here they launch back to back on the current
    stream, the layer tiles stay on the device and nothing waits on the
    host."""
    from vgtpu_torch.raster.frame import execute_plan

    tiles = scene._render(*offsets, layer_bg, tiles_only=True)
    if over is not None:
        tiles = _blend_over_tiles(over, tiles)
    return execute_plan(plan, background, device_arrays=device_arrays,
                        init_tiles=tiles)


class PendingPanLayer:
    """Lazy stand-in for the translated cached-list layer's tile grid
    (api/context end()): carries (scene, view) so _maybe_dispatch renders
    the pan, the overlay blend and the frame in one chain
    (_pan_frame_fused).  materialize() gives the tiles themselves, for
    renderFrames.

    over_tiles: resident transparent-baked static-UI tiles
    (Context._layer_split(transparent=True)) blended over the pan tiles."""

    def __init__(self, scene, view, background, over_tiles=None):
        self.scene = scene
        self.view = tuple(view)
        self.background = tuple(background)
        self.over_tiles = over_tiles

    def _offsets(self) -> tuple:
        return self.scene._offsets(*self.view)

    def materialize(self) -> torch.Tensor:
        tiles = self.scene.render_tiles(view_x=self.view[0],
                                        view_y=self.view[1],
                                        background=self.background)
        if self.over_tiles is not None:
            tiles = _blend_over_tiles(self.over_tiles, tiles)
        return tiles

    def execute_over(self, plan, device_arrays, background) -> torch.Tensor:
        """The frame plan composites its dynamic suffix over this layer,
        rendered at the pending view offset."""
        return _pan_frame_fused(self.scene, self._offsets(), self.background,
                                plan, device_arrays, background,
                                over=self.over_tiles)
