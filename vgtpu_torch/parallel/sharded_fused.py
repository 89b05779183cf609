"""The sharded single-device path: per shard, kernel K1 chunk coverage, the
extras fold and kernel K2 per bucket (the port of
vgtpu/parallel/sharded_fused.py).

parallel/sharding.py shards the frame with the plain torch oracle
composite; this module shards the path a single device takes
(raster/frame.execute_plan):

  - the tile/entry/chunk co-partition comes from
    sharding.partition_plan_for_mesh;
  - the single-device fused tables (coverage gather map, per-bucket pteb,
    params and colour-tile ids) are built globally on the host by the
    single-device builder (raster/frame.fused_tables), then COLUMN-SELECTED
    per device: each bucket keeps its global depth and lane flags, so every
    tile's kernel math is the single-device path's;
  - per-device bucket widths pad to the across-device max; pad columns
    carry valid=0 params, dead-chunk pteb rows and the scratch tile row;
  - chunk ids in pteb are remapped to device-local coverage rows (a
    device's pools are the partition's order-preserving groups, so its
    per-chunk coverage rows equal the global ones);
  - the body is collective-free; the framebuffers are copied to
    mesh.devices[0], unpermuted and assembled there.

At ss > 1 this is vgtpu's RAW formulation: every pool on sub-rows, every
bucket K2 form (d); no resolve split and no K3.
"""

from __future__ import annotations

import numpy as np

from vgtpu_torch.ops.composite import _pad_tiles, color_tiles_flat, frame_fb
from vgtpu_torch.ops.coverage import cov_all, fold_extras
from vgtpu_torch.parallel.sharding import (
    Mesh,
    ShardedFrame,
    _put,
    partition_plan_for_mesh,
    plan_dense_arrays,
)
from vgtpu_torch.raster.frame import fused_tables


def build_sharded_fused(plan, d: dict, n: int):
    """Partition a plan's fused tables for an n-device mesh (a host copy of
    vgtpu's build_sharded_fused over the port's builders).

    Returns (stacked, reps, static): `stacked` host arrays with leading axis
    n (one slice per device), `reps` the replicated colour tiles in K2's
    layout, `static` the body's shapes, bucket flags and the output
    unpermute map.  Unlike vgtpu, each class's ids are padded to the
    bucket's padded width (K2 takes one id per pteb row) and no
    device-local entry table is kept (K2 reads the params)."""
    arrays, meta = partition_plan_for_mesh(d, plan, n)
    dev_of_tile = meta["dev_of_tile"]
    local_of = meta["local_of"]
    owner_e = meta["owner_e"]
    pool_maps = meta["pool_maps"]
    ne = plan.entry_backdrop.shape[0]
    ts = meta["t_pad"] // n

    # ---- global fused tables (the single-device builder) ----
    nct = plan.color_tiles.shape[0]
    t = fused_tables(plan, nct)
    m = t["cov_map"]
    pool_lens = [len(cent) for _ce, cent in plan.chunk_pools]
    glob_dead = t["dead_id"]

    # global chunk id -> owning device's local coverage row.  Local coverage
    # concatenates the device's per-pool groups in pool order + a dead row.
    nc_devs = [pm[2] for pm in pool_maps]
    loc_dead = int(sum(nc_devs))
    glob2loc = np.full(glob_dead + 1, loc_dead, np.int64)
    goff = 0
    loff = 0
    for (keep, slot, nc_dev), ln in zip(pool_maps, pool_lens):
        glob2loc[goff + keep] = loff + (slot % nc_dev)
        goff += ln
        loff += nc_dev

    # ---- per-device column selection of every bucket class ----
    classes = []
    for (te_b, ids_b, flags), pp_glob, pteb_glob, ctile_glob in zip(
            plan.tile_buckets, t["params"], t["pteb"], t["ctile"]):
        mo = te_b.shape[1]
        # bucket rows whose tile is the scratch id (== num_tiles) are global
        # padding, re-created per device below, so exclude them here
        real = ids_b < dev_of_tile.shape[0]
        cols = [np.nonzero(real & (dev_of_tile[np.minimum(
            ids_b, dev_of_tile.shape[0] - 1)] == k))[0] for k in range(n)]
        nbd = max(1, max(len(c) for c in cols))
        nbdp = _pad_tiles(nbd)
        ids_s = np.full((n, nbdp), ts, np.int32)           # pad -> scratch row
        pteb_s = np.full((n, nbdp, mo), loc_dead, np.int32)
        pp_s = np.zeros((n, mo, pp_glob.shape[1], nbdp), np.float32)
        ct_s = np.full((n, nbdp, mo), nct, np.int32) if flags[2] else None
        for k, ck in enumerate(cols):
            c = len(ck)
            if not c:
                continue
            # device-local fb row of each tile (rows are device-contiguous)
            ids_s[k, :c] = meta["row_of_tile"][ids_b[ck]] - k * ts
            pteb_s[k, :c] = glob2loc[pteb_glob[ck]]
            pp_s[k, :, :, :c] = pp_glob[:, :, ck]
            if ct_s is not None:
                ct_s[k, :c] = ctile_glob[ck]
        classes.append({"ids": ids_s, "pteb": pteb_s, "params": pp_s,
                        "ctile": ct_s})

    # ---- per-device extras of the coverage fold ----
    alive_x = m["extra_chunk"] < glob_dead
    own_x = np.where(alive_x, owner_e[np.clip(m["extra_entry"], 0, ne - 1)], -1)
    kmax = max(1, int(np.bincount(own_x[own_x >= 0], minlength=n).max())
               if (own_x >= 0).any() else 1)
    ec_s = np.full((n, kmax), loc_dead, np.int32)
    et_s = np.full((n, kmax), loc_dead, np.int32)
    for k in range(n):
        sel = np.nonzero(own_x == k)[0]
        ec_s[k, : len(sel)] = glob2loc[m["extra_chunk"][sel]]
        et_s[k, : len(sel)] = glob2loc[m["extra_primary"][sel]]

    pools_s = tuple(
        np.asarray(ce).reshape((n, -1) + np.asarray(ce).shape[1:])
        for ce, _cent in arrays["chunk_pools"])

    stacked = {
        "pools": pools_s,
        "extra_chunk": ec_s,
        "extra_target": et_s,
        "classes": tuple(classes),
    }
    reps = {"ct_flat": color_tiles_flat(plan)}
    static = {
        "ts": ts,
        "tile_h": plan.tile_h,
        "tile_w": plan.tile_w,
        "ss": plan.supersample,
        "bucket_flags": t["flags"],
        "row_of_tile": meta["row_of_tile"],
        "meta": meta,
    }
    return stacked, reps, static


def shard_frame_fused(plan, mesh: Mesh) -> ShardedFrame:
    """Partition the plan's fused tables over the mesh and upload each
    shard to its device (render_frame_sharded_fused)."""
    stacked, reps, static = build_sharded_fused(
        plan, plan_dense_arrays(plan), mesh.size)
    shards = []
    for k, dev in enumerate(mesh.devices):
        classes = [{name: None if v is None else _put(v[k], dev)
                    for name, v in c.items()} for c in stacked["classes"]]
        shards.append({
            "pools": [_put(ce[k], dev) for ce in stacked["pools"]],
            "cov_map": {"extra_chunk": _put(stacked["extra_chunk"][k], dev),
                        "extra_primary": _put(stacked["extra_target"][k], dev)},
            "classes": classes,
            "ct_flat": _put(reps["ct_flat"], dev),
        })
    th, tw, ss, ts = static["tile_h"], static["tile_w"], static["ss"], static["ts"]
    bucket_flags = static["bucket_flags"]

    def body(s, background):
        cov = fold_extras(cov_all(s["pools"], th, tw), s["cov_map"])
        cl = s["classes"]
        return frame_fb(
            cov, [c["ids"] for c in cl], [c["pteb"] for c in cl],
            [c["params"] for c in cl], [c["ctile"] for c in cl], s["ct_flat"],
            background, tile_h=th, tile_w=tw, num_tiles=ts,
            bucket_flags=bucket_flags, ss=ss)

    return ShardedFrame(plan, mesh, shards, static["meta"], body)


def render_frame_sharded_fused(plan, mesh: Mesh,
                               background=(1.0, 1.0, 1.0, 1.0),
                               return_meta: bool = False):
    """The sharded fused frame -> (H, W, 4) premultiplied image on
    mesh.devices[0] (and the partition's meta with return_meta)."""
    sf = shard_frame_fused(plan, mesh)
    img = sf.render(background)
    return (img, sf.meta) if return_meta else img
