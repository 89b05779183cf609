"""Frame executor: FramePlan -> framebuffer on a torch device (the device side
of end(), vg.cpp:1076-1288, minus bgfx).

Twin of vgtpu/raster/frame.py for the fused formulation, which the port
takes on every device: upload the plan once (plan_to_device), then per
frame compute chunk coverage (kernel K1 on CUDA), composite every bucket of
tiles gathering straight from it (kernel K2 on CUDA) and assemble the image.
Supersampled plans (ss > 1) split the chunk pools first
(raster/resolve.py): kernel K3 resolves the RES chunks and the XE rows into
output-domain coverage, K1 computes the RAW pools on sub-rows, and K2
composites non-clip buckets from final coverage (form (e)) and clip buckets
from sub-row coverage (form (d)).
vgtpu's TPU-only pieces (the packed upload arena, the persisted-executable
cache, the fused-platform gate) have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from vgtpu_torch.ops.composite import (
    _P_PAINT,
    _pad_tiles,
    background_tensor,
    build_bucket_aux,
    build_bucket_pteb,
    color_tiles_flat,
    composite_bucket,
    composite_bucket_flat,
    composite_bucket_into_torch,
    frame_fb,
    tiles_to_image,
)
from vgtpu_torch.ops.coverage import (
    build_cov_gather_map,
    cov_all_resolved,
    cov_all_resolved_torch,
    coverage_chunks,
    coverage_chunks_t,
)
from vgtpu_torch.ops.coverage_resolve import (
    cov_split_resolved,
    cov_split_resolved_torch,
)
from vgtpu_torch.raster.binning import PAINT_NF, FramePlan, compute_tile_buckets
from vgtpu_torch.raster.resolve import build_resolve_aux, build_resolve_split
from vgtpu_torch.utils.profiler import stage_of


def _bucket128(n: int) -> int:
    """128-aligned pool size with proportional quantization (copied from
    vgtpu/raster/frame.py so compacted plans stay identical): the step grows
    with the size (128 up to 1k, 256 to 2k, 512 to 4k, then 1024)."""
    n = max(n, 1)
    step = 128
    while step * 8 < n:
        step *= 2
    return -(-n // step) * step


def _compact_culled_chunks(plan: FramePlan) -> None:
    """Drop chunks whose entry no bucket references (occlusion / static-clip
    culled draws): their coverage would be computed and never gathered
    (copied unchanged from vgtpu/raster/frame.py).  Pads pools to the
    _bucket128 sizes; pad chunks are all-zero edges -> exactly zero coverage
    by the binning invariant, so pointing them at any entry is harmless."""
    if plan.stats.get("chunks_compacted"):
        return
    plan.stats["chunks_compacted"] = True
    ne = plan.entry_backdrop.shape[0]
    ref = np.zeros(ne, bool)
    for te_b, _ids, _fl in plan.tile_buckets:
        ref[te_b[te_b >= 0]] = True
    new_pools = []
    live = 0
    for ce, cent in plan.chunk_pools:
        ce = np.asarray(ce)
        cent = np.asarray(cent)
        keep = (cent >= 0) & (cent < ne) & ref[np.clip(cent, 0, ne - 1)]
        ce2, cent2 = ce[keep], cent[keep]
        live += len(ce2)
        nc = _bucket128(len(ce2))
        cep = np.zeros((nc,) + ce.shape[1:], ce.dtype)
        cep[: len(ce2)] = ce2
        centp = np.full(nc, ne - 1, cent.dtype)
        centp[: len(cent2)] = cent2
        new_pools.append((cep, centp))
    plan.stats["chunks_live"] = live
    plan.chunk_pools = new_pools


def _prepare_plan(plan: FramePlan, profiler=None):
    """Tile buckets, chunk compaction and, at ss > 1, the resolve split
    (raster/resolve.build_resolve_split: RES pools first, then RAW pools),
    in vgtpu's order: after compaction, before any pool is taken.  Each step
    is idempotent; returns the split's host aux or None.  profiler: where
    the buckets count the tiles the depth cap cut (depth_capped_tiles)."""
    if plan.tile_buckets is None:
        plan.tile_buckets = compute_tile_buckets(
            plan.tile_entries, plan.tile_entries.shape[0], plan.entry_kind, plan,
            profiler=profiler)
    _compact_culled_chunks(plan)
    if plan.supersample > 1 and plan.entry_backdrop_pan is None:
        return build_resolve_split(plan)
    return None


def plan_host_arrays(plan: FramePlan) -> dict:
    """The fused path's host arrays for one plan: tile buckets, chunk
    compaction and the resolve split (ss > 1), then fused_tables' tables,
    each bucket's entry table clamped to 0 (the rows patch_bucket_paint
    reads the paint from), and ct_flat in K2's layout (a tensor on its
    device when the device sampler left the colour tiles there, else
    numpy).  Without a split "cov_map" is the fold's map and "res" None;
    with one, "cov_map" is None and "res" holds the K3 inputs."""
    split = _prepare_plan(plan)
    t = fused_tables(plan, plan.color_tiles.shape[0], split)
    m = t["cov_map"]
    return {
        "chunk_edges": [np.ascontiguousarray(ce, np.float32)
                        for ce, _cent in plan.chunk_pools],
        "cov_map": None if split is not None else {
            "extra_chunk": m["extra_chunk"],
            "extra_primary": m["extra_primary"]},
        "res": t["res"],
        "bucket_ids": t["ids"],
        "bucket_te": [np.maximum(te, 0) for te in t["te"]],
        "bucket_pteb": t["pteb"],
        "bucket_params": t["params"],
        "bucket_ctile": t["ctile"],
        "bucket_rbd": t["rbd"],
        "ct_flat": color_tiles_flat(plan),
        "bucket_flags": t["flags"],
    }


def fused_tables(plan: FramePlan, nct: int, split: dict | None = None) -> dict:
    """K2's per-bucket input tables, and the gather map K1's fold reads,
    over the plan's chunk pools as they stand: the one builder of the tables
    the frame, the pan bake, VariantBatch and the sharded fused frame hand
    to kernels that index them without bounds checks, so every id is
    checked here.

    "cov_map": build_cov_gather_map's map; "dead_id": the all-zeros
    coverage row after the last chunk.  Per tile bucket, padded to
    _pad_tiles rows: "ids", the framebuffer rows (pad rows: the scratch row
    ntx*nty); "te", the entry table (-1 where no entry); "params", the
    host-built params (build_bucket_aux, bit-identical to vgtpu's
    device-side build_bucket_params_jnp); "ctile", a texture bucket's
    colour-tile ids against nct tiles (untextured and pad slots: row nct,
    the zeros row of K2's colour-tile layout), else None; "pteb", the
    coverage row of each slot; "rbd", the resolved-backdrop rows or None;
    and "flags", the lane flags.

    split: build_resolve_split's aux of a split plan (ss > 1), else None.
    Without it "pteb" holds each slot's primary chunk (invalid slots:
    dead_id) and "res" is None; with it "pteb" and "rbd" are
    build_resolve_aux's, against cov_sub (clip buckets) or cov_final, and
    "res" holds the K3 inputs and the extras/XE tables against the RAW
    rows."""
    num_tiles = plan.ntx * plan.nty
    m = build_cov_gather_map(plan.chunk_pools, plan.entry_backdrop.shape[0])
    dead_id = int(sum(len(cent) for _ce, cent in plan.chunk_pools))
    out = {"cov_map": m, "dead_id": dead_id, "ids": [], "te": [],
           "params": [], "ctile": [], "flags": []}
    for te_b, ids_b, flags in plan.tile_buckets:
        nbp = _pad_tiles(te_b.shape[0])
        ids = np.full(nbp, num_tiles, np.int32)
        ids[: len(ids_b)] = ids_b
        te_p = np.full((nbp, te_b.shape[1]), -1, np.int32)
        te_p[: len(te_b)] = te_b
        ctile = None
        if flags[2]:
            ct = np.where(te_p >= 0, plan.entry_color_tile[np.maximum(te_p, 0)], -1)
            ctile = np.where(ct >= 0, ct, nct).astype(np.int32)
        if ids.size and (ids.min() < 0 or ids.max() > num_tiles):
            raise ValueError("fused_tables: bucket tile id outside the framebuffer")
        if ctile is not None and ctile.size and (ctile.min() < 0 or ctile.max() > nct):
            raise ValueError("fused_tables: colour-tile id out of range")
        out["ids"].append(ids)
        out["te"].append(te_p)
        out["params"].append(build_bucket_aux(plan, te_b)[0])
        out["ctile"].append(ctile)
        out["flags"].append(tuple(bool(f) for f in flags))
    out["flags"] = tuple(out["flags"])
    if split is None:
        out["res"] = None
        out["pteb"] = [build_bucket_pteb(te_b, m["primary"], dead_id)
                       for te_b, _ids, _fl in plan.tile_buckets]
        out["rbd"] = [None] * len(out["pteb"])
        ncr = [dead_id + 1] * len(out["pteb"])   # coverage rows each bucket indexes
    else:
        aux = build_resolve_aux(plan, m, split, dead_id)
        res = {k: aux[k] for k in ("rparams", "extra_chunk_raw",
                                   "extra_primary_raw", "xe_primary_raw",
                                   "xe_rparams")}
        for k in ("extra_chunk_raw", "extra_primary_raw", "xe_primary_raw"):
            if res[k].size and (res[k].min() < 0 or res[k].max() > split["nraw"]):
                raise ValueError(f"fused_tables: {k} outside the raw rows")
        out["res"] = res
        out["pteb"], out["rbd"] = list(aux["pteb"]), list(aux["rbd"])
        n_final = split["nres"] + len(aux["xe_primary_raw"]) + 1
        ncr = [split["nraw"] + 1 if fl[3] else n_final for fl in out["flags"]]
    for pteb, n in zip(out["pteb"], ncr):
        if pteb.size and (pteb.min() < 0 or pteb.max() >= n):
            raise ValueError("fused_tables: chunk id outside coverage rows")
    return out


def plan_to_device(plan: FramePlan, device, profiler=None) -> dict:
    """Upload the plan's arrays once: every host array of plan_host_arrays
    goes through torch.as_tensor(...).to(device).  The per-bucket params
    are built on the host (build_bucket_aux), bit-identical to vgtpu's
    device-side build_bucket_params_jnp, so no device expansion runs.

    profiler: optional FrameProfiler for sub-stage attribution (upload.*),
    the bytes put (upload_bytes) and the host-to-device copies issued
    (upload_copies, one per numpy array), and the tiles the depth cap cut
    (depth_capped_tiles)."""
    stage = stage_of(profiler)
    with stage("upload.resolve_split"):
        _prepare_plan(plan, profiler)
    with stage("upload.aux"):
        host = plan_host_arrays(plan)
    arrays = {k: v for k, v in host.items() if k != "bucket_flags"}
    with stage("upload.put"):
        d = put_arrays(arrays, device, profiler)
        d["bucket_flags"] = host["bucket_flags"]
    return d


def put_arrays(arrays: dict, device, profiler=None) -> dict:
    """A dict of (nested) numpy arrays -> the same dict of tensors on
    `device`, counting on `profiler` (if any) the bytes put (upload_bytes)
    and the host-to-device copies issued (upload_copies, one per numpy
    array).  Tensors, such as device-sampled colour tiles, are already on
    the device: they pass through with neither bytes nor a copy."""
    device = torch.device(device)
    d = {k: _put(v, device) for k, v in arrays.items()}
    if profiler is not None:
        put = [x for x in _leaves(arrays) if isinstance(x, np.ndarray)]
        profiler.count("upload_bytes", sum(x.nbytes for x in put))
        profiler.count("upload_copies", len(put))
    return d


def _put(x, device):
    """Nested dicts, lists and tuples of numpy arrays (or None) -> the same
    structure of tensors on `device`."""
    if isinstance(x, dict):
        return {k: _put(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_put(v, device) for v in x)
    return None if x is None else torch.as_tensor(x).to(device)


def _leaves(x) -> list:
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _leaves(v)]
    return [] if x is None else [x]


def patch_bucket_paint(bucket_params, bucket_te, entry_paint: torch.Tensor) -> None:
    """Rewrite the 18 paint rows of each bucket params tensor in place from
    an (NE, 18) entry paint table on the same device: one gather per bucket
    through its padded entry table (plan_host_arrays' bucket_te).  The rows
    equal a fresh build_bucket_aux: that does not mask paint by validity
    either, so invalid and pad slots carry entry 0's paint on both sides."""
    for pp, te in zip(bucket_params, bucket_te):
        pp[:, _P_PAINT : _P_PAINT + PAINT_NF, :] = entry_paint[te].permute(1, 2, 0)


def _render(plan, d, background, plain, init_tiles=None, tiles=False):
    th, tw, ss = plan.tile_h, plan.tile_w, plan.supersample
    if d["res"] is not None:
        split = cov_split_resolved_torch if plain else cov_split_resolved
        cov_final, cov = split(d["chunk_edges"], d["res"], th, tw, ss)
    else:
        resolve = cov_all_resolved_torch if plain else cov_all_resolved
        cov, cov_final = resolve(d["chunk_edges"], d["cov_map"], th, tw), None
    fb = frame_fb(
        cov, d["bucket_ids"], d["bucket_pteb"], d["bucket_params"],
        d["bucket_ctile"], d["ct_flat"], background,
        tile_h=th, tile_w=tw, num_tiles=plan.ntx * plan.nty,
        bucket_flags=d["bucket_flags"],
        bucket_fn=composite_bucket_into_torch if plain else composite_bucket,
        ss=ss, cov_final_arr=cov_final, bucket_rbd=d["bucket_rbd"],
        init_tiles=init_tiles)
    if tiles:
        return fb
    return tiles_to_image(fb, ntx=plan.ntx, nty=plan.nty, tile_h=th // ss,
                          tile_w=tw, width=plan.width, height=plan.height)


def _arrays(plan, device_arrays, device, who):
    if device_arrays is None:
        if device is None:
            raise ValueError(f"{who}: pass device_arrays or a device")
        device_arrays = plan_to_device(plan, device)
    return device_arrays


def execute_plan(plan: FramePlan, background=(1.0, 1.0, 1.0, 1.0),
                 device_arrays=None, device=None,
                 init_tiles=None) -> torch.Tensor:
    """Run the device pipeline; returns (H, W, 4) premultiplied f32 RGBA on
    the arrays' device: kernels K1, K3 and K2 on CUDA, the plain twins on
    the CPU.  Without device_arrays the plan is uploaded to `device` first.
    init_tiles: optional resident layer (execute_plan_tiles output) the plan
    composites over instead of the background (K2 form (b))."""
    d = _arrays(plan, device_arrays, device, "execute_plan")
    return _render(plan, d, background, plain=False, init_tiles=init_tiles)


def execute_plan_torch(plan: FramePlan, background=(1.0, 1.0, 1.0, 1.0),
                       device_arrays=None, device=None,
                       init_tiles=None) -> torch.Tensor:
    """execute_plan through the plain torch twins on the arrays' own device:
    the reference the CUDA kernels are held against on the card."""
    d = _arrays(plan, device_arrays, device, "execute_plan_torch")
    return _render(plan, d, background, plain=True, init_tiles=init_tiles)


def execute_plan_tiles(plan: FramePlan, background=(1.0, 1.0, 1.0, 1.0),
                       device_arrays=None, device=None) -> torch.Tensor:
    """Render a plan to its (T, TH//ss, TW, 4) tile framebuffer, no image
    assembly: the layer memo's bake, which later frames pass to execute_plan
    as init_tiles."""
    d = _arrays(plan, device_arrays, device, "execute_plan_tiles")
    return _render(plan, d, background, plain=False, tiles=True)


def execute_plan_flat(plan: FramePlan, device_arrays: dict, chunk_entry,
                      background=(1.0, 1.0, 1.0, 1.0),
                      coverage: str = "K5") -> torch.Tensor:
    """An ss=1 plan rendered through the entry points of kernels K5 or K6
    and K7, a second route to execute_plan's image: per pool chunk coverage
    through coverage_chunks_t(variant="flat") (K5) or coverage_chunks (K6),
    the chunk -> entry index_add_, + backdrop -> entry_w (NE, NPX); per
    bucket ew_t = entry_w gathered by the bucket's entry table, then
    composite_bucket_flat (K7, add_backdrop=False); the tiles scattered into
    the framebuffer, then tiles_to_image.  device_arrays: plan_to_device's;
    chunk_entry: each pool's chunk -> entry ids on the same device."""
    if plan.supersample != 1 or coverage not in ("K5", "K6"):
        raise ValueError(f"execute_plan_flat: ss={plan.supersample}, "
                         f"coverage={coverage!r} (ss=1, 'K5' or 'K6')")
    d = device_arrays
    th, tw = plan.tile_h, plan.tile_w
    npx, nt = th * tw, plan.ntx * plan.nty
    dev = d["ct_flat"].device
    bd = torch.as_tensor(plan.entry_backdrop, device=dev)
    entry_w = torch.zeros((bd.shape[0], npx), dtype=torch.float32, device=dev)
    for ce, cent in zip(d["chunk_edges"], chunk_entry, strict=True):
        if coverage == "K5":
            cov = coverage_chunks_t(ce, th, tw, variant="flat").t()
        else:
            cov = coverage_chunks(ce, th, tw).reshape(-1, npx)
        entry_w.index_add_(0, cent, cov)
    entry_w += bd.repeat_interleave(tw, dim=1)
    bg = background_tensor(background, dev)
    fb = bg.expand(nt + 1, th, tw, 4).clone()
    bg_vec = bg.repeat_interleave(npx)[:, None]
    for te, ids, pp, ctile, flags in zip(d["bucket_te"], d["bucket_ids"],
                                         d["bucket_params"], d["bucket_ctile"],
                                         d["bucket_flags"]):
        ew_t = entry_w[te].permute(1, 2, 0).contiguous()
        ct_t = d["ct_flat"][ctile].permute(1, 2, 0).contiguous() if flags[2] else None
        fb_t = composite_bucket_flat(ew_t, pp, ct_t, bg_vec, tile_w=tw, flags=flags)
        fb[ids] = fb_t.reshape(4, th, tw, -1).permute(3, 1, 2, 0)
    return tiles_to_image(fb[:nt], ntx=plan.ntx, nty=plan.nty, tile_h=th,
                          tile_w=tw, width=plan.width, height=plan.height)


def image_to_u8(img) -> np.ndarray:
    """Premultiplied f32 -> straight u8 RGBA (a torch tensor on any device,
    or an array)."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    img = np.asarray(img)
    a = np.maximum(img[..., 3:4], 1e-6)
    rgb = np.clip(img[..., 0:3] / a, 0.0, 1.0)
    out = np.concatenate([rgb, np.clip(img[..., 3:4], 0.0, 1.0)], axis=-1)
    return (out * 255.0 + 0.5).astype(np.uint8)
