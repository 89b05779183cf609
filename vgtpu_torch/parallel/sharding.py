"""Multi-GPU frame rendering over a tuple of torch devices: collective-free.

The port of vgtpu/parallel/sharding.py.  The screen-tile grid is the data
axis, and ownership is a tree: each edge CHUNK feeds exactly one (tile, op)
ENTRY and each entry belongs to exactly one TILE.  So one partition of the
tiles induces a partition of entries and chunks under which every stage of
the frame is device-local (partition_plan_for_mesh, copied from vgtpu):

  - tiles are assigned to devices by LPT greedy on per-tile chunk load and
    their rows permuted device-contiguous;
  - entries are permuted so each device's entries are contiguous, and the
    tile tables rewritten to device-local entry ids;
  - chunks are grouped by the device that owns their entry, order kept.

vgtpu runs the shards as one shard_map program.  Here one process places
each shard's tensors on its own device (Mesh.devices[k]) and launches that
shard's work there; launches are asynchronous, so the devices run
concurrently.  The frame body has no collective: the one cross-device
movement is the copy of the shard framebuffers to devices[0], where the
LPT row order is undone and the image assembled.  No torch.distributed.

A Mesh may repeat a device: Mesh((torch.device("cuda", 0),) * 4) runs four
shards on one card, and Mesh((torch.device("cpu"),) * n) on the CPU, the
counterpart of the virtual CPU mesh vgtpu's tests use.

Per shard, render_frame_sharded computes entry coverage through kernel K4
(ops/coverage.entry_coverage_from_pools), adds the backdrop and runs the
plain torch oracle composite (ops/composite.composite_tiles_body), as
vgtpu's sharded frame does; parallel/sharded_fused.py shards the
single-device path (K1, the extras fold, K2) instead.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from vgtpu_torch.ops.composite import composite_tiles_body, tiles_to_image
from vgtpu_torch.ops.coverage import entry_coverage_from_pools


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices the shards run on, in shard order."""

    devices: tuple

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("Mesh: no devices")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n: int | None = None) -> Mesh:
    """The first n CUDA devices (all of them when n is None).  Raises when
    fewer exist: it never repeats a card and never takes the CPU — build a
    Mesh with repeated devices for that."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n is None else n
    if not 1 <= n <= count:
        raise RuntimeError(f"make_mesh({n}): torch sees {count} CUDA "
                           f"device(s); build Mesh(devices) explicitly to "
                           f"repeat a device or to run on the CPU")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def _bucket_up(n: int, minimum: int = 8) -> int:
    """Pad a per-device count to a stable bucket (copied from vgtpu):
    128-multiples from 128 on, the binner's {2^k, 1.5*2^k} sizes below."""
    from vgtpu_torch.raster.binning import _bucket

    if n >= 128:
        return -(-n // 128) * 128
    return _bucket(max(n, 1), minimum=minimum)


def plan_dense_arrays(plan) -> dict:
    """The dense host arrays the partition reads, from the plan itself (as
    vgtpu's bench_multichip.py builds them): its chunk pools — the ones the
    single-device frame uses, after raster/frame._prepare_plan — the
    per-entry tables, the colour tiles and the raw tile table."""
    from vgtpu_torch.raster.frame import _prepare_plan

    _prepare_plan(plan)
    return {
        "chunk_pools": tuple((np.asarray(ce), np.asarray(cent))
                             for ce, cent in plan.chunk_pools),
        "entry_backdrop": plan.entry_backdrop,
        "entry_kind": plan.entry_kind,
        "entry_rule": plan.entry_rule,
        "entry_aa": plan.entry_aa,
        "entry_paint_kind": plan.entry_paint_kind,
        "entry_paint": plan.entry_paint,
        "entry_scissor": plan.entry_scissor,
        "entry_color_tile": plan.entry_color_tile,
        "color_tiles": _tiles(plan.color_tiles),
        "tile_entries": plan.tile_entries,
    }


def _tiles(ct):
    """Colour tiles as they are: a tensor the device sampler left on a
    device stays a tensor (each shard copies it device to device), anything
    else becomes a numpy array."""
    return ct if isinstance(ct, torch.Tensor) else np.asarray(ct)


# ---------------------------------------------------------------------------
# partition_plan_for_mesh: copied from vgtpu/parallel/sharding.py (host numpy)
# ---------------------------------------------------------------------------

def partition_plan_for_mesh(d: dict, plan, n: int) -> tuple[dict, dict]:
    """Co-partition tiles, entries and chunks for an n-device mesh.

    Returns (arrays, meta): arrays holds the permuted/padded host arrays
    (first axis of every sharded array is n * per-device-count, device k's
    slice contiguous); meta holds the shapes, the partition maps and the
    imbalance stats."""
    te0 = np.asarray(d["tile_entries"])
    T = te0.shape[0]
    ts = -(-T // n)                       # tile rows per device
    t_pad = ts * n

    entry_tile = np.asarray(plan.entry_tile).astype(np.int64)
    ne = np.asarray(d["entry_backdrop"]).shape[0]

    # --- tile -> device assignment: LPT greedy on per-tile chunk load ---
    # contiguous blocks correlate with scene density (the busy region lands
    # on one device); assigning the heaviest tiles first to the least-loaded
    # device with spare capacity gets balance close to 1.0.  The tile rows
    # are then PERMUTED so each device's tiles are contiguous; tile_ids
    # carries the original flat index (pixel positions derive from it) and
    # the output gather unpermutes.
    load = np.zeros(T, np.int64)
    for ce, cent in d["chunk_pools"]:
        ce = np.asarray(ce)
        cent = np.asarray(cent).astype(np.int64)
        alive = (np.abs(ce[:, :, 3] - ce[:, :, 1]) > 0).any(axis=1)
        tl = entry_tile[np.clip(cent[alive], 0, ne - 1)]
        np.add.at(load, np.clip(tl, 0, T - 1), 1)
    order_t = np.argsort(-load, kind="stable")
    dev_of_tile = np.empty(T, np.int64)
    dev_load = np.zeros(n, np.int64)
    dev_count = np.zeros(n, np.int64)
    for t in order_t:
        cands = np.nonzero(dev_count < ts)[0]
        k = cands[np.argmin(dev_load[cands])]
        dev_of_tile[t] = k
        dev_load[k] += load[t]
        dev_count[k] += 1
    # row layout: device-grouped, original order within a device, padded
    # with empty rows to ts per device
    rows = np.full(t_pad, -1, np.int64)          # original tile id per row
    row_of_tile = np.empty(T, np.int64)
    for k in range(n):
        mine = np.nonzero(dev_of_tile == k)[0]
        rows[k * ts: k * ts + len(mine)] = mine
        row_of_tile[mine] = k * ts + np.arange(len(mine))
    te = np.full((t_pad, te0.shape[1]), -1, te0.dtype)
    te[rows >= 0] = te0[rows[rows >= 0]]
    tile_ids = np.where(rows >= 0, rows, 0).astype(np.int32)

    # owner device per entry follows its tile.  PADDING entries (rows
    # n_real..ne of the bucket-padded arrays) carry entry_tile=0 and are
    # never referenced by any tile row: spread them to the devices with the
    # fewest real entries, which equalizes NE_dev
    owner_e = dev_of_tile[np.clip(entry_tile[:ne], 0, T - 1)]
    n_real = getattr(plan, "n_real_entries", 0) or ne
    if n_real < ne:
        counts_real = np.bincount(owner_e[:n_real], minlength=n)
        order_fill = np.argsort(counts_real, kind="stable")
        deficit = counts_real.max() - counts_real
        pads = ne - n_real
        # top up the emptiest devices first, then round-robin the rest
        assign = np.full(pads, -1, np.int64)
        pos = 0
        for k in order_fill:
            t = int(min(deficit[k], pads - pos))
            assign[pos: pos + t] = k
            pos += t
        if pos < pads:
            assign[pos:] = np.arange(pads - pos) % n
        owner_e[n_real:] = assign
    # contract check: every entry a tile references is owned by that tile
    valid = te >= 0
    if valid.any():
        ref_dev = np.repeat(np.arange(t_pad) // ts, te.shape[1])[valid.ravel()]
        if not (owner_e[te[valid]] == ref_dev).all():
            raise ValueError("partition_plan_for_mesh: tile_entries references "
                             "an entry owned by another tile shard")

    counts_e = np.bincount(owner_e, minlength=n)
    ne_dev = _bucket_up(int(counts_e.max()))
    # stable grouping by owner: order within a device (hence within every
    # entry) is preserved -> per-entry float adds keep their order
    order_e = np.argsort(owner_e, kind="stable")
    # local id of each (global) entry: position within its device's group
    local_of = np.empty(ne, np.int64)
    local_of[order_e] = np.concatenate([np.arange(c) for c in counts_e])

    def scatter_entries(a, fill=0):
        a = np.asarray(a)
        out = np.full((n * ne_dev,) + a.shape[1:], fill, a.dtype)
        out[owner_e * ne_dev + local_of] = a[:ne]
        return out

    # tile tables -> local entry ids
    te_local = np.where(valid, local_of[np.maximum(te, 0)], -1).astype(np.int32)

    # chunks: group by owner device, preserving order (stable) so multi-chunk
    # entries sum in the same order as the single-device frame
    pools = []
    chunk_counts = []
    pool_maps = []
    for ce, cent in d["chunk_pools"]:
        ce = np.asarray(ce)
        cent = np.asarray(cent).astype(np.int64)
        nc, chunk_sz = ce.shape[0], ce.shape[1]
        alive = (np.abs(ce[:, :, 3] - ce[:, :, 1]) > 0).any(axis=1)
        owner_c = np.where(alive, owner_e[np.clip(cent, 0, ne - 1)], 0)
        order_c = np.argsort(np.where(alive, owner_c, n), kind="stable")
        keep = order_c[alive[order_c]]            # dead chunks dropped (cov == 0)
        counts_c = np.bincount(owner_c[keep], minlength=n)
        nc_dev = _bucket_up(int(counts_c.max()))
        ce_out = np.zeros((n * nc_dev, chunk_sz, 4), ce.dtype)
        cent_out = np.zeros(n * nc_dev, np.int32)  # pad: local entry 0, zero edges
        base = np.repeat(np.arange(n) * nc_dev, counts_c)
        slot = base + np.concatenate([np.arange(c) for c in counts_c])
        ce_out[slot] = ce[keep]
        cent_out[slot] = local_of[cent[keep]].astype(np.int32)
        pools.append((ce_out, cent_out))
        chunk_counts.append(counts_c)
        pool_maps.append((keep, slot, nc_dev))

    arrays = {
        "chunk_pools": tuple(pools),
        "entry_backdrop": scatter_entries(d["entry_backdrop"]),
        "entry_kind": scatter_entries(d["entry_kind"]),
        "entry_rule": scatter_entries(d["entry_rule"]),
        "entry_aa": scatter_entries(d["entry_aa"]),
        "entry_paint_kind": scatter_entries(d["entry_paint_kind"]),
        "entry_paint": scatter_entries(d["entry_paint"]),
        "entry_scissor": scatter_entries(d["entry_scissor"]),
        "entry_color_tile": scatter_entries(d["entry_color_tile"]),
        "color_tiles": _tiles(d["color_tiles"]),          # replicated
        "tile_entries": te_local,
        "tile_ids": tile_ids,
    }
    live = [int(c.sum()) for c in chunk_counts]
    padded = [len(pools[i][1]) for i in range(len(pools))]
    meta = {
        "t_pad": t_pad,
        "ne_dev": ne_dev,
        "row_of_tile": row_of_tile,    # output gather: fb[row_of_tile]
        "entries_per_dev": counts_e.tolist(),
        "chunks_per_dev": [c.tolist() for c in chunk_counts],
        # fraction of padded chunk slots that are real work on the busiest
        # device vs the mean: 1.0 = perfectly balanced
        "chunk_balance": (
            float(np.mean([c.mean() / max(c.max(), 1) for c in chunk_counts]))
            if chunk_counts else 1.0),
        # REAL-entry balance (pad rows are spread to equalize NE_dev)
        "entry_balance": float(
            np.bincount(owner_e[:n_real], minlength=n).mean()
            / max(np.bincount(owner_e[:n_real], minlength=n).max(), 1)),
        "chunk_slots_live": live,
        "chunk_slots_padded": padded,
        "ici_bytes_per_frame": 0,   # no collective in the frame body
        # partition maps for the sharded fused frame (sharded_fused.py):
        # which device owns each tile/entry, each entry's device-local id,
        # and per pool (kept global chunk ids, their packed device-major
        # slots, per-device padded count)
        "dev_of_tile": dev_of_tile,
        "owner_e": owner_e,
        "local_of": local_of,
        "pool_maps": pool_maps,
    }
    return arrays, meta


# ---------------------------------------------------------------------------
# running the shards
# ---------------------------------------------------------------------------

class ShardedFrame:
    """A plan partitioned over a mesh, each shard's tensors resident on its
    device.  render(background) launches every shard's body on its own
    device, copies the shard framebuffers to mesh.devices[0], undoes the LPT
    row order and assembles the (H, W, 4) image there."""

    def __init__(self, plan, mesh: Mesh, shards: list, meta: dict, body):
        self.mesh = mesh
        self.shards = shards            # per device: a dict of its tensors
        self.meta = meta
        self._body = body               # (shard dict, background) -> tiles
        self._row_of_tile = torch.as_tensor(meta["row_of_tile"]).to(mesh.devices[0])
        self._geometry = dict(ntx=plan.ntx, nty=plan.nty,
                              tile_h=plan.tile_h // plan.supersample,
                              tile_w=plan.tile_w, width=plan.width,
                              height=plan.height)

    def render(self, background=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
        background = tuple(float(v) for v in background)
        fbs = [self._body(s, background) for s in self.shards]
        dev0 = self.mesh.devices[0]
        fb = torch.cat([f.to(dev0) for f in fbs])[self._row_of_tile]
        return tiles_to_image(fb, **self._geometry)


def _put(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x)).to(device)


def shard_frame(plan, mesh: Mesh) -> ShardedFrame:
    """Partition the plan over the mesh and upload each shard to its
    device, for the oracle-composite body (render_frame_sharded)."""
    n = mesh.size
    arrays, meta = partition_plan_for_mesh(plan_dense_arrays(plan), plan, n)
    ts, ne_dev = meta["t_pad"] // n, meta["ne_dev"]
    shards = []
    for k, dev in enumerate(mesh.devices):
        def rows(a, per, k=k):
            return _put(np.asarray(a)[k * per:(k + 1) * per], dev)

        pools = [(rows(ce, len(ce) // n), rows(cent, len(cent) // n))
                 for ce, cent in arrays["chunk_pools"]]
        s = {name: rows(arrays[name], ne_dev) for name in (
            "entry_backdrop", "entry_kind", "entry_rule", "entry_aa",
            "entry_paint_kind", "entry_paint", "entry_scissor",
            "entry_color_tile")}
        s.update(chunk_edges=[ce for ce, _ in pools],
                 chunk_entry=[cent for _, cent in pools],
                 tile_entries=rows(arrays["tile_entries"], ts),
                 tile_ids=rows(arrays["tile_ids"], ts),
                 color_tiles=_put(arrays["color_tiles"], dev))
        shards.append(s)
    th, tw, ss = plan.tile_h, plan.tile_w, plan.supersample
    ntx = plan.ntx

    def body(s, background):
        # local chunks cover exactly the local entries: no reduction across
        # devices
        entry_w = entry_coverage_from_pools(
            s["chunk_edges"], s["chunk_entry"], ne_dev, th, tw)
        entry_w = entry_w + s["entry_backdrop"][:, :, None]
        return composite_tiles_body(
            entry_w, s["tile_entries"], s["tile_ids"], s["entry_kind"],
            s["entry_rule"], s["entry_aa"], s["entry_paint_kind"],
            s["entry_paint"], s["entry_scissor"], s["entry_color_tile"],
            s["color_tiles"], background, ntx=ntx, tile_h=th, tile_w=tw,
            max_ops=s["tile_entries"].shape[1], ss=ss)

    return ShardedFrame(plan, mesh, shards, meta, body)


def render_frame_sharded(plan, mesh: Mesh, background=(1.0, 1.0, 1.0, 1.0),
                         return_meta: bool = False):
    """The tile-sharded frame -> (H, W, 4) premultiplied image on
    mesh.devices[0] (and the partition's meta with return_meta)."""
    sf = shard_frame(plan, mesh)
    img = sf.render(background)
    return (img, sf.meta) if return_meta else img
