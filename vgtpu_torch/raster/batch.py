"""Batched variant rendering: K value-variants of one scene in one pass
(the fused formulation of vgtpu/raster/batch.py).

The serving / throughput mode.  The batch axis folds into the composite's
TILE axis, which the engine already treats as fully independent:

  * geometry is identical across variants, so chunk coverage (kernel K1 and
    the extras fold) is computed ONCE;
  * every bucket runs kernel K2 once for all K variants in form (c): its
    params, colour-tile ids and framebuffer rows are K blocks of one
    variant's tiles, and every block reads the one block of coverage rows
    (pteb), so no K-fold copy of the coverage is gathered;
  * colour tiles (text / pattern pre-samples) stack per variant: the K
    ct_flat tables concatenate and each variant block's ctile ids are offset
    by k * (NCT + 1) on the host side of the bake.

What may vary between variants is exactly what the paint-value memo patch
(Context._value_only_update) accepts: solid/gradient paint rows (same
opacity class) and texture/pattern/text-colour values.  Geometry, draw
order, clips and scissors are shared.

Bake protocol: each draw_fn records its variant through the ordinary API;
frame 0 establishes the structural plan and every later frame must hit the
value-patch (or full-memo) path, anything structural raises.

vgtpu's portable XLA formulation (entry-axis folding, _host_folded_tables)
is not ported: the port always takes the fused one.  render_sharded splits
the variant axis over a mesh (parallel/sharding.Mesh), as vgtpu's does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vgtpu_torch.ops.composite import (
    composite_bucketed_body,
    frame_fb,
    tiles_to_image,
)
from vgtpu_torch.ops.coverage import cov_all_resolved, entry_coverage_from_pools
from vgtpu_torch.raster.frame import fused_tables, patch_bucket_paint


def _record_snaps(ctx, draw_fns, width, height, dpr, background,
                  expect_plan=None, expect_d=None):
    """Record the K variants through the ordinary API and snapshot the
    value tables after each frame.  Every frame after the first (or ALL
    frames, when re-recording against an existing bake via expect_plan)
    must leave the resident plan object untouched, i.e. hit the memo or
    paint-value-patch path, or ValueError."""
    snaps = []
    plan0, d0 = expect_plan, expect_d
    # the batch renders plans WITHOUT layer tiles: prefix-layer splitting
    # is suppressed for the bake records (full single plans)
    suppress0 = ctx._suppress_layer
    ctx._suppress_layer = True
    try:
        for k, fn in enumerate(draw_fns):
            ctx.begin(0, width, height, dpr)
            fn(ctx)
            # only the resident plan + paint tables are needed: skip the K
            # per-variant device renders
            ctx.end(background=background, dispatch=False)
            if ctx._layer_render is not None:
                raise ValueError(
                    "a resident layer (layer memo) is active on this "
                    "context's frames: layered frames cannot bake into a "
                    "VariantBatch (the batch renders plans without layer "
                    "tiles)")
            plan = ctx.last_plan
            if plan0 is None:
                plan0, d0 = plan, ctx.last_device_arrays
            elif plan is not plan0 or ctx.last_device_arrays is not d0:
                raise ValueError(
                    f"variant {k} changed the frame structure (geometry, "
                    "draw order, clips, texture topology or an opacity "
                    "class); only paint/texture VALUES may differ")
            snaps.append({
                "entry_paint": plan.entry_paint.copy(),
                "ct_flat": d0["ct_flat"],
            })
    finally:
        ctx._suppress_layer = suppress0
    return plan0, d0, snaps


def _batch_tables(plan, d, K: int) -> dict:
    """Static (value-independent) batched bucket tables on the plan's device.

    Coverage: fused_tables' gather map and per-bucket coverage rows (pteb)
    over plan.chunk_pools, the order of d["chunk_edges"].  A split plan
    (ss > 1) keeps its own resident tables against cov_final/cov_sub; the
    batch, as vgtpu's fused batch, runs K1 + the fold over all pools and K2
    form (d) on every bucket, so it takes the unsplit tables.

    Per bucket: ids are K blocks of the padded framebuffer rows, variant k
    offset by k*T, pad rows to the batch scratch row K*T."""
    dev = d["ct_flat"].device
    T = plan.ntx * plan.nty
    t = fused_tables(plan, plan.color_tiles.shape[0])
    m = t["cov_map"]
    ids_k = [torch.cat([torch.where(ids >= T, K * T, ids + k * T)
                        for k in range(K)]).to(torch.int32)
             for ids in d["bucket_ids"]]
    return {
        "cov_map": {"extra_chunk": torch.as_tensor(m["extra_chunk"]).to(dev),
                    "extra_primary": torch.as_tensor(m["extra_primary"]).to(dev)},
        "pteb": [torch.as_tensor(p).to(dev) for p in t["pteb"]],
        "ids": ids_k,
    }


def _batch_values(d, snaps) -> tuple:
    """Per-variant value planes: each bucket's params as K lane blocks (the
    resident params with variant k's paint rows, frame.patch_bucket_paint
    on a copy), the K
    ct_flat tables stacked, and each texture bucket's colour-tile ids
    offset by k * (NCT + 1) per block."""
    dev = d["ct_flat"].device
    K = len(snaps)
    blocks = []                     # per variant: every bucket's params
    for s in snaps:
        pps = [pp.clone() for pp in d["bucket_params"]]
        patch_bucket_paint(pps, d["bucket_te"],
                           torch.as_tensor(s["entry_paint"]).to(dev))
        blocks.append(pps)
    params = [torch.cat(b, dim=2).contiguous() for b in zip(*blocks)]
    nct1 = d["ct_flat"].shape[0]
    if any(s["ct_flat"].shape[0] != nct1 for s in snaps):
        raise ValueError("variants differ in their colour-tile count")
    ct_flat = torch.cat([s["ct_flat"] for s in snaps]).contiguous()
    ctiles = [None if ct is None else
              torch.cat([ct + k * nct1 for k in range(K)]).contiguous()
              for ct in d["bucket_ctile"]]
    return params, ct_flat, ctiles


class VariantBatch:
    """K baked value-variants of one structural plan; render() produces all
    K frames -> (K, H, W, 4) premultiplied f32 on the plan's device."""

    def __init__(self, plan, d, snaps):
        self.K = len(snaps)
        self._plan = plan
        self._d = d
        self._snaps = snaps
        self._tables = _batch_tables(plan, d, self.K)
        self._params, self._ct_flat, self._ctile = _batch_values(d, snaps)
        self._record = None   # (ctx, w, h, dpr, background) from bake
        self._sharded = {}    # mesh -> render_sharded's uploaded tables

    @property
    def device(self) -> torch.device:
        return self._d["ct_flat"].device

    @staticmethod
    def bake(ctx, draw_fns, width: int, height: int, dpr: float = 1.0,
             background=(0.0, 0.0, 0.0, 1.0)) -> "VariantBatch":
        """Record each variant through the ordinary API and fold the batch.

        draw_fns: sequence of callables f(ctx); each records ONE variant
        frame.  The first defines the structure; every later one must be a
        value-only delta (the paint-memo eligibility rules) or ValueError.
        Bake cost is K ordinary frame records; render() amortizes from then
        on."""
        draw_fns = list(draw_fns)
        if not draw_fns:
            raise ValueError("need at least one variant")
        if not (ctx.cfg.frame_memo and ctx.cfg.paint_memo):
            raise ValueError("VariantBatch.bake requires frame_memo and "
                             "paint_memo enabled (they gate the value-patch "
                             "path the bake snapshots)")
        plan0, d0, snaps = _record_snaps(ctx, draw_fns, width, height, dpr,
                                         background)
        vb = VariantBatch(plan0, d0, snaps)
        vb._record = (ctx, width, height, dpr, background)
        return vb

    def update_values(self, draw_fns) -> None:
        """Refresh the K variants' VALUES in place, the per-tick serving
        loop.  Re-records each variant (every frame must hit the memo or
        paint-value-patch path against the baked structure, else ValueError)
        and rebuilds only the value planes: the coverage and framebuffer-row
        tables are reused."""
        if self._record is None:
            raise ValueError("update_values needs a bake()-built batch")
        draw_fns = list(draw_fns)
        if len(draw_fns) != self.K:
            raise ValueError(f"{len(draw_fns)} draw_fns for K={self.K}")
        ctx, w, h, dpr, bg = self._record
        _plan, _d, snaps = _record_snaps(ctx, draw_fns, w, h, dpr, bg,
                                         expect_plan=self._plan,
                                         expect_d=self._d)
        self._snaps = snaps
        self._params, self._ct_flat, self._ctile = _batch_values(self._d, snaps)
        for entry in self._sharded.values():
            entry["values"] = None       # render_sharded uploads them anew

    def render(self, background=(0.0, 0.0, 0.0, 1.0)) -> torch.Tensor:
        """All K variant frames -> (K, H, W, 4): coverage once (K1 + the
        extras fold over all pools), then K2 form (c) per bucket (form (d)
        sub-rows at ss > 1), then one gather of the K*T tiles into image
        layout."""
        plan, d, tb = self._plan, self._d, self._tables
        K, ss = self.K, plan.supersample
        th, tw = plan.tile_h, plan.tile_w
        T = plan.ntx * plan.nty
        cov = cov_all_resolved(d["chunk_edges"], tb["cov_map"], th, tw)
        fb = frame_fb(cov, tb["ids"], tb["pteb"], self._params, self._ctile,
                      self._ct_flat, background, tile_h=th, tile_w=tw,
                      num_tiles=K * T, bucket_flags=d["bucket_flags"], ss=ss,
                      k_rep=K)
        th_out = th // ss
        img = (fb.view(K, plan.nty, plan.ntx, th_out, tw, 4)
               .permute(0, 1, 3, 2, 4, 5)
               .reshape(K, plan.nty * th_out, plan.ntx * tw, 4))
        return img[:, : plan.height, : plan.width]

    def render_sharded(self, mesh, background=(0.0, 0.0, 0.0, 1.0)) -> torch.Tensor:
        """All K variants data-parallel over a mesh (parallel/sharding.Mesh)
        -> (K, H, W, 4) on mesh.devices[0]: the port of vgtpu's
        render_sharded.  The variant axis splits over the mesh; K pads to a
        multiple of the mesh size by repeating the last variant (pad frames
        are rendered and dropped).  Each shard computes entry coverage once
        (kernel K4 through entry_coverage_from_pools), adds the backdrop and
        runs the plain torch oracle composite (composite_bucketed_body) for
        each of its variants; no collective, then one copy of each shard's
        images to devices[0].  The structural tables upload once per mesh
        device, the value tables once per mesh until update_values."""
        plan = self._plan
        n, K = mesh.size, self.K
        entry = self._sharded.get(mesh)
        if entry is None:
            entry = self._sharded[mesh] = {
                "struct": {dev: _sharded_structure(plan, dev)
                           for dev in dict.fromkeys(mesh.devices)},
                "values": None}
        if entry["values"] is None:
            kl = -(-K // n)
            snaps_p = list(self._snaps) + [self._snaps[-1]] * (kl * n - K)
            entry["values"] = [
                [_sharded_values(plan, s, dev) for s in snaps_p[k * kl:(k + 1) * kl]]
                for k, dev in enumerate(mesh.devices)]
        th, tw, ss = plan.tile_h, plan.tile_w, plan.supersample
        ne = plan.entry_backdrop.shape[0]
        geo = dict(ntx=plan.ntx, nty=plan.nty, tile_h=th // ss, tile_w=tw,
                   width=plan.width, height=plan.height)
        background = tuple(float(v) for v in background)
        outs = []
        for dev, values in zip(mesh.devices, entry["values"]):
            st = entry["struct"][dev]
            ew = entry_coverage_from_pools(st["chunk_edges"], st["chunk_entry"],
                                           ne, th, tw)
            ew = ew + st["entry_backdrop"][:, :, None]
            outs.append(torch.stack([tiles_to_image(composite_bucketed_body(
                ew, st["buckets"], st["entry_kind"], st["entry_rule"],
                st["entry_aa"], st["entry_paint_kind"], ep, st["entry_scissor"],
                st["entry_color_tile"], ct, background, ntx=plan.ntx,
                tile_h=th, tile_w=tw, num_tiles=plan.ntx * plan.nty,
                bucket_flags=st["bucket_flags"], ss=ss), **geo)
                for ep, ct in values]))
        dev0 = mesh.devices[0]
        return torch.cat([o.to(dev0) for o in outs])[:K]


def _sharded_structure(plan, dev) -> dict:
    """The variant-invariant tables render_sharded reads, on one device:
    the chunk pools, the per-entry tables and the tile buckets."""
    ne = plan.entry_backdrop.shape[0]
    for _ce, cent in plan.chunk_pools:
        if len(cent) and (cent.min() < 0 or cent.max() >= ne):
            raise ValueError("render_sharded: a chunk's entry id is outside "
                             "the entry tables")

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    return {
        "chunk_edges": [put(ce) for ce, _cent in plan.chunk_pools],
        "chunk_entry": [put(cent) for _ce, cent in plan.chunk_pools],
        **{k: put(getattr(plan, k)) for k in (
            "entry_backdrop", "entry_kind", "entry_rule", "entry_aa",
            "entry_paint_kind", "entry_scissor", "entry_color_tile")},
        "buckets": [(put(te), put(ids)) for te, ids, _fl in plan.tile_buckets],
        "bucket_flags": tuple(tuple(bool(f) for f in fl)
                              for _te, _ids, fl in plan.tile_buckets),
    }


def _sharded_values(plan, snap, dev) -> tuple:
    """One variant's value tables on one device: its (NE, 18) paint table
    and its colour tiles (NCT, TH//ss, TW, 4), unpacked from the snapshot's
    K2-layout ct_flat."""
    th_out = plan.tile_h // plan.supersample
    ct = snap["ct_flat"][:-1].reshape(-1, 4, th_out, plan.tile_w)
    return (torch.as_tensor(snap["entry_paint"]).to(dev),
            ct.permute(0, 2, 3, 1).to(dev).contiguous())


def measure_batch_ms_per_frame(vb: VariantBatch, background=(0, 0, 0, 1),
                               reps_hi: int = 16, reps_lo: int = 2) -> float:
    """Device ms per VARIANT FRAME: repeated render() calls on the batch's
    own device, (t(reps_hi) - t(reps_lo)) / (reps_hi - reps_lo) / K, so the
    fixed cost of a timed window cancels.  CUDA events on a CUDA batch; the
    host clock on the CPU."""
    if reps_hi <= reps_lo:
        raise ValueError(f"reps_hi {reps_hi} must exceed reps_lo {reps_lo}")
    dev = vb.device

    def run(n: int) -> float:
        if dev.type == "cuda":
            # the events record on the batch's device, not the current one
            with torch.cuda.device(dev):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(n):
                    vb.render(background)
                b.record()
                b.synchronize()
            return a.elapsed_time(b)
        t0 = time.perf_counter()
        for _ in range(n):
            vb.render(background)
        return (time.perf_counter() - t0) * 1e3

    run(reps_lo)          # warm-up
    lo = run(reps_lo)
    hi = run(reps_hi)
    return (hi - lo) / (reps_hi - reps_lo) / vb.K
