"""Frame executor: FramePlan -> framebuffer on a torch device (the device side
of end(), vg.cpp:1076-1288, minus bgfx).

Twin of vgtpu/raster/frame.py for the fused formulation at ss=1, which the
port takes on every device: upload the plan once (plan_to_device), then per
frame resolve chunk coverage (kernel K1 on CUDA), composite every bucket of
tiles gathering straight from it (kernel K2 on CUDA) and assemble the image.
vgtpu's TPU-only pieces (the packed upload arena, the persisted-executable
cache, the fused-platform gate) have no counterpart here.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from vgtpu_torch.ops.composite import (
    build_bucket_aux,
    build_bucket_pteb,
    composite_bucket,
    composite_bucket_into_torch,
    frame_fb,
    tiles_to_image,
)
from vgtpu_torch.ops.coverage import (
    build_cov_gather_map,
    cov_all_resolved,
    cov_all_resolved_torch,
)
from vgtpu_torch.raster.binning import FramePlan, compute_tile_buckets


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


def plan_host_arrays(plan: FramePlan) -> dict:
    """The fused path's host arrays for one plan (numpy): tile buckets,
    chunk compaction, the chunk->entry gather map, and per bucket its padded
    framebuffer rows, primary-chunk ids, params and colour-tile ids.

    Raises NotImplementedError for supersampled plans (ss > 1)."""
    if plan.supersample != 1:
        from vgtpu_torch.api.context import _unported

        raise _unported("supersampled frames (coverage_supersample > 1)",
                        "ss>1 with K3 and K2 (d)/(e)")
    if plan.tile_buckets is None:
        plan.tile_buckets = compute_tile_buckets(
            plan.tile_entries, plan.tile_entries.shape[0], plan.entry_kind, plan)
    _compact_culled_chunks(plan)
    ne = plan.entry_backdrop.shape[0]
    num_tiles = plan.ntx * plan.nty
    m = build_cov_gather_map(plan.chunk_pools, ne)
    dead_id = int(sum(len(cent) for _ce, cent in plan.chunk_pools))
    nct = plan.color_tiles.shape[0]
    ids_l, pteb_l, pp_l, ctile_l, flags_l = [], [], [], [], []
    for te_b, ids_b, flags in plan.tile_buckets:
        pp, _unused = build_bucket_aux(plan, te_b, need_ct=False)
        pteb = build_bucket_pteb(te_b, m["primary"], dead_id)
        nbp = pteb.shape[0]
        ids = np.full(nbp, num_tiles, np.int32)
        ids[: len(ids_b)] = ids_b
        ctile = None
        if flags[2]:
            te_p = np.full((nbp, te_b.shape[1]), -1, te_b.dtype)
            te_p[: len(te_b)] = te_b
            ct = np.where(te_p >= 0,
                          plan.entry_color_tile[np.maximum(te_p, 0)], -1)
            ctile = np.where(ct >= 0, ct, nct).astype(np.int32)
        ids_l.append(ids)
        pteb_l.append(pteb)
        pp_l.append(pp)
        ctile_l.append(ctile)
        flags_l.append(tuple(bool(f) for f in flags))
    # indices come from the host binner: check them here, the kernels don't
    ncr = dead_id + 1
    for ids in ids_l:
        if ids.size and (ids.min() < 0 or ids.max() > num_tiles):
            raise ValueError("plan_to_device: bucket tile id outside the framebuffer")
    for pteb in pteb_l:
        if pteb.size and (pteb.min() < 0 or pteb.max() >= ncr):
            raise ValueError("plan_to_device: chunk id outside coverage rows")
    for ctile in ctile_l:
        if ctile is not None and ctile.size and (ctile.min() < 0 or ctile.max() > nct):
            raise ValueError("plan_to_device: colour-tile id out of range")
    th, tw = plan.tile_h, plan.tile_w
    ct = np.asarray(plan.color_tiles, np.float32)
    # (NCT, TH, TW, 4) -> (NCT+1, 4*NPX) channel-major + the zeros row
    ct_flat = np.concatenate([
        ct.transpose(0, 3, 1, 2).reshape(ct.shape[0], 4 * th * tw),
        np.zeros((1, 4 * th * tw), np.float32)])
    return {
        "chunk_edges": [np.ascontiguousarray(ce, np.float32)
                        for ce, _cent in plan.chunk_pools],
        "cov_map": {"extra_chunk": m["extra_chunk"],
                    "extra_primary": m["extra_primary"]},
        "bucket_ids": ids_l,
        "bucket_pteb": pteb_l,
        "bucket_params": pp_l,
        "bucket_ctile": ctile_l,
        "ct_flat": ct_flat,
        "bucket_flags": tuple(flags_l),
    }


def plan_to_device(plan: FramePlan, device, profiler=None) -> dict:
    """Upload the plan's arrays once: every host array of plan_host_arrays
    goes through torch.as_tensor(...).to(device).  The per-bucket params
    are built on the host (build_bucket_aux), bit-identical to vgtpu's
    device-side build_bucket_params_jnp, so no device expansion runs.

    profiler: optional FrameProfiler for sub-stage attribution (upload.*)."""
    stage = profiler.stage if profiler is not None else (
        lambda _n: contextlib.nullcontext())
    with stage("upload.aux"):
        host = plan_host_arrays(plan)
    device = torch.device(device)

    def put(x):
        return None if x is None else torch.as_tensor(x).to(device)

    lists = ("chunk_edges", "bucket_ids", "bucket_pteb", "bucket_params",
             "bucket_ctile")
    with stage("upload.put"):
        d = {k: [put(x) for x in host[k]] for k in lists}
        d["cov_map"] = {k: put(v) for k, v in host["cov_map"].items()}
        d["ct_flat"] = put(host["ct_flat"])
        d["bucket_flags"] = host["bucket_flags"]
    if profiler is not None:
        arrays = [x for k in lists for x in host[k] if x is not None]
        arrays += [*host["cov_map"].values(), host["ct_flat"]]
        profiler.count("upload_bytes", sum(x.nbytes for x in arrays))
    return d


def _render(plan, d, background, resolve, bucket_fn):
    th, tw = plan.tile_h, plan.tile_w
    cov = resolve(d["chunk_edges"], d["cov_map"], th, tw)
    fb = frame_fb(
        cov, d["bucket_ids"], d["bucket_pteb"], d["bucket_params"],
        d["bucket_ctile"], d["ct_flat"], background,
        tile_h=th, tile_w=tw, num_tiles=plan.ntx * plan.nty,
        bucket_flags=d["bucket_flags"], bucket_fn=bucket_fn)
    return tiles_to_image(fb, ntx=plan.ntx, nty=plan.nty, tile_h=th,
                          tile_w=tw, width=plan.width, height=plan.height)


def execute_plan(plan: FramePlan, background=(1.0, 1.0, 1.0, 1.0),
                 device_arrays=None, device=None) -> torch.Tensor:
    """Run the device pipeline; returns (H, W, 4) premultiplied f32 RGBA on
    the arrays' device: kernels K1 + K2 on CUDA, the plain twins on the CPU.
    Without device_arrays the plan is uploaded to `device` first."""
    if device_arrays is None:
        if device is None:
            raise ValueError("execute_plan: pass device_arrays or a device")
        device_arrays = plan_to_device(plan, device)
    return _render(plan, device_arrays, background, cov_all_resolved,
                   composite_bucket)


def execute_plan_torch(plan: FramePlan, background=(1.0, 1.0, 1.0, 1.0),
                       device_arrays=None, device=None) -> torch.Tensor:
    """execute_plan through the plain torch twins on the arrays' own device:
    the reference the CUDA kernels are held against on the card."""
    if device_arrays is None:
        if device is None:
            raise ValueError("execute_plan_torch: pass device_arrays or a device")
        device_arrays = plan_to_device(plan, device)
    return _render(plan, device_arrays, background, cov_all_resolved_torch,
                   composite_bucket_into_torch)


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
