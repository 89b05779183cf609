"""Analytic winding-coverage accumulation (device half of the port).

Twin of vgtpu/ops/coverage.py: each edge's exact box-filtered signed-area
contribution is accumulated per pixel of an 8x128 tile, chunk by chunk (see
ARCHITECTURE.md for the derivation).  Chunks of the same entry sum
independently, so every chunk is CHUNK edges by TH*TW pixels.

Input layout (from vgtpu_torch.raster.binning):
  chunk_edges: (NC, CHUNK, 4) f32 — edge segments, tile-origin-relative

On a CUDA tensor `cov_all` launches kernel K1 (csrc/coverage.cu, via
ops/coverage_cuda.py; one launch over every pool), `coverage_chunks`
kernel K6 (csrc/coverage_slots.cu, via ops/coverage_slots_cuda.py),
`coverage_pools_t` kernel K4 (csrc/coverage_t.cu, via
ops/coverage_t_cuda.py; one launch over every pool) and `coverage_chunks_t`
K4 on one pool or, with variant="flat", K5 (csrc/coverage_t_flat.cu, via
ops/coverage_t_flat_cuda.py); on a CPU tensor they run the plain torch
twins `cov_all_torch`, `coverage_chunks_torch` and
`coverage_chunks_t_torch`.  Any other device raises.

ViewWindow is the view of a retained pan (raster/retained.py): `cov_all`
computes only the chunks of the scene tiles it reaches, and
ops/composite.frame_fb composites only their bucket rows, straight into the
view's output.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

_EPS = 1e-6


def fma(a, b, c):
    """a*b + c rounded once to float32 (a fused multiply-add), computed in
    float64: the 48-bit product is exact there."""
    return (a.double() * b.double() + c.double()).float()


@dataclass(frozen=True)
class ViewWindow:
    """The view of a retained pan: output tile (oy, ox), oy < rows and ox <
    cols, shows scene tile (vy + oy, vx + ox) of a scene grid ntx x nty
    tiles of th output rows by tw columns.  `tiles` are the scene tiles the
    view reaches, clipped to the grid.  The output is an image of width x
    height pixels (width > 0: the last column and row of tiles clipped to
    it) or, width == 0, the (rows * cols, th, tw, 4) output tile grid."""

    vx: int
    vy: int
    cols: int
    rows: int
    ntx: int
    nty: int
    th: int
    tw: int
    width: int = 0
    height: int = 0

    @cached_property
    def tiles(self) -> tuple:
        """(x0, y0, x1, y1): scene columns [x0, x1) and rows [y0, y1), empty
        (x0 == x1 or y0 == y1) for a view off the scene."""
        x0 = min(max(self.vx, 0), self.ntx)
        y0 = min(max(self.vy, 0), self.nty)
        x1 = max(min(self.vx + self.cols, self.ntx), x0)
        y1 = max(min(self.vy + self.rows, self.nty), y0)
        return x0, y0, x1, y1

    def holds(self, tile: torch.Tensor) -> torch.Tensor:
        """Whether each flat scene tile id (ty * ntx + tx) lies in `tiles`
        (the scratch id ntx * nty never does)."""
        x0, y0, x1, y1 = self.tiles
        tx, ty = tile % self.ntx, tile // self.ntx
        return (tx >= x0) & (tx < x1) & (ty >= y0) & (ty < y1)

    def out_shape(self) -> tuple:
        if self.width:
            return (self.height, self.width, 4)
        return (self.rows * self.cols, self.th, self.tw, 4)

    def layout(self) -> tuple:
        """(s_ty, s_tx, s_r, clip_w, clip_h): output pixel (row r, column c)
        of output tile (oy, ox) sits at pixel oy * s_ty + ox * s_tx + r *
        s_r + c of the output, and is written only where ox * tw + c <
        clip_w and oy * th + r < clip_h (kernel K2's addressing)."""
        th, tw = self.th, self.tw
        if self.width:
            return th * self.width, tw, self.width, self.width, self.height
        return (self.cols * th * tw, th * tw, tw, self.cols * tw,
                self.rows * th)

    def place(self, out: torch.Tensor, tiles: torch.Tensor,
              tile_ids: torch.Tensor) -> None:
        """Writes tiles (n, th, tw, 4) of scene tiles tile_ids (inside
        `tiles`) at their output positions in out, K2's addressing."""
        s_ty, s_tx, s_r, clip_w, clip_h = self.layout()
        dev = out.device
        ox = (tile_ids % self.ntx - self.vx)[:, None, None]
        oy = (tile_ids // self.ntx - self.vy)[:, None, None]
        r = torch.arange(self.th, device=dev)[None, :, None]
        c = torch.arange(self.tw, device=dev)[None, None, :]
        keep = (ox * self.tw + c < clip_w) & (oy * self.th + r < clip_h)
        pix = oy * s_ty + ox * s_tx + r * s_r + c
        out.view(-1, 4)[pix[keep]] = tiles[keep]


def _edge_contribution(px, py, x0, y0, x1, y1):
    """Signed pixel-area contribution of one edge batch to pixel grid
    (px, py); the expressions and their order are vgtpu's
    _edge_contribution.

    The G-form divides by m, so an ulp of error in u is amplified up to
    1/0.01 = 100x in the result (pixels far right of a near-vertical edge).
    The two a*b+c sites that XLA on the CPU contracts into fused
    multiply-adds — x(ytop) and u1 — are therefore written as explicit FMAs
    here and in kernel K1, which is built without other contraction; the
    twin then tracks XLA's rounding instead of differing by ~1e-4."""
    ymin = torch.minimum(y0, y1)
    ymax = torch.maximum(y0, y1)
    s = torch.sign(y1 - y0)
    dy = y1 - y0
    m = (x1 - x0) / torch.where(torch.abs(dy) < _EPS, 1.0, dy)
    steep = torch.abs(m) < 0.01
    s_over_m = s / torch.where(steep, 1.0, m)     # per-edge scalars

    # maximum/minimum against 0-d tensors, not clamp: the same values, and
    # at a tie the gradient splits in half as jax's does (diff.render_edges)
    zero, one = ymin.new_zeros(()), ymin.new_ones(())
    ytop = torch.maximum(ymin, py)
    h = torch.maximum(torch.minimum(ymax, py + 1.0) - ytop, zero)
    u0 = (px + 1.0) - fma(m, ytop - y0, x0)
    u1 = fma(-m, h, u0)

    c0 = torch.minimum(torch.maximum(u0, zero), one)
    c1 = torch.minimum(torch.maximum(u1, zero), one)
    g0 = c0 * (u0 - 0.5 * c0)
    g1 = c1 * (u1 - 0.5 * c1)
    general = (g0 - g1) * s_over_m
    vertical = s * h * c0
    return torch.where(steep, vertical, general)


def edge_row_live(chunk_edges: torch.Tensor, tile_h: int,
                  row0: int = 0) -> torch.Tensor:
    """(NC, CH, TH) bool: edge e of chunk c spans tile row row0 + r (h > 0,
    by _edge_contribution's own expressions).  These are the row masks
    kernels K1, K3 and K4 walk, a window of rows from row0 at a time: an
    edge with h == 0 on a row adds exactly +0 or -0 to each of its pixels,
    which leaves the edge-order sum bit for bit as it was."""
    y0, y1 = chunk_edges[:, :, 1:2], chunk_edges[:, :, 3:4]
    py = torch.arange(row0, row0 + tile_h, dtype=torch.float32,
                      device=chunk_edges.device)
    ytop = torch.maximum(torch.minimum(y0, y1), py)
    h = torch.clamp_min(torch.minimum(torch.maximum(y0, y1), py + 1.0) - ytop, 0.0)
    return h > 0


def _live_slots(chunk_edges: torch.Tensor) -> torch.Tensor:
    """(NC, CH) bool: the edge in slot e of chunk c has y0 != y1.  A
    horizontal edge (a pool's padding: all zeros, or the pan's padding
    shifted by the residual) adds +0 or -0 at every pixel: s = 0 and h = 0.
    A sum that starts at +0 never becomes -0, so adding such an edge leaves
    it bit for bit as it was, and the twins skip them: the dense result at
    a fraction of its cost for deep pools padded to 128 chunks."""
    return chunk_edges[:, :, 1].ne(chunk_edges[:, :, 3])


def coverage_chunks_torch(chunk_edges: torch.Tensor, tile_h: int = 8,
                          tile_w: int = 128) -> torch.Tensor:
    """(NC, CH, 4) edges -> (NC, TH, TW) summed winding contributions: the
    plain twin of vgtpu's coverage_chunks_body and of kernels K1 and K6.
    Edges are summed in slot order, as the scan does (the horizontal ones
    skipped: _live_slots)."""
    nc, ch, _ = chunk_edges.shape
    dev = chunk_edges.device
    px = torch.arange(tile_w, dtype=torch.float32, device=dev).expand(tile_h, tile_w)
    py = torch.arange(tile_h, dtype=torch.float32, device=dev)[:, None].expand(tile_h, tile_w)
    acc = torch.zeros((nc, tile_h, tile_w), dtype=torch.float32, device=dev)
    live = _live_slots(chunk_edges)
    for e in range(ch):
        idx = live[:, e].nonzero().flatten()
        if not idx.numel():
            continue
        full = idx.numel() == nc
        edge = chunk_edges[:, e] if full else chunk_edges[idx, e]
        x0, y0, x1, y1 = (edge[:, k][:, None, None] for k in range(4))
        c = _edge_contribution(px, py, x0, y0, x1, y1)
        if full:
            acc = acc + c
        else:
            acc[idx] = acc[idx] + c
    return acc


def coverage_chunks_t_torch(chunk_edges: torch.Tensor, tile_h: int = 8,
                            tile_w: int = 128) -> torch.Tensor:
    """(NC, CH, 4) edges -> (TH*TW, NC) pixel-major coverage: the plain twin
    of kernels K4 and K5 and of vgtpu's coverage_chunks_pallas_t_raw
    (_kernel_t2 and _kernel_t).  The same arithmetic as
    coverage_chunks_torch, in edge order: _kernel_t2's
    (g0 - g1) * b_gen + a_vert * c0 always has one exact-zero term, so it
    equals the select form of _edge_contribution bit for bit."""
    nc, ch, _ = chunk_edges.shape
    dev = chunk_edges.device
    flat = torch.arange(tile_h * tile_w, device=dev)
    px = (flat % tile_w).to(torch.float32)[:, None]        # (NPX, 1)
    py = (flat // tile_w).to(torch.float32)[:, None]
    acc = torch.zeros((tile_h * tile_w, nc), dtype=torch.float32, device=dev)
    live = _live_slots(chunk_edges)
    for e in range(ch):
        idx = live[:, e].nonzero().flatten()
        if not idx.numel():
            continue
        full = idx.numel() == nc
        edge = chunk_edges[:, e] if full else chunk_edges[idx, e]
        x0, y0, x1, y1 = (edge[:, k][None, :] for k in range(4))
        c = _edge_contribution(px, py, x0, y0, x1, y1)
        if full:
            acc = acc + c
        else:
            acc[:, idx] = acc[:, idx] + c
    return acc


def coverage_chunks(chunk_edges: torch.Tensor, tile_h: int = 8,
                    tile_w: int = 128) -> torch.Tensor:
    """(NC, TH, TW) chunk coverage: the counterpart of vgtpu's
    coverage_chunks_pallas, kernel K6 on CUDA, the plain twin on the CPU.
    Both sum the edges in slot order."""
    dev = chunk_edges.device
    if dev.type == "cuda":
        from vgtpu_torch.ops.coverage_slots_cuda import coverage_chunks_slots_cuda

        return coverage_chunks_slots_cuda(chunk_edges, tile_h, tile_w)
    if dev.type == "cpu":
        return coverage_chunks_torch(chunk_edges, tile_h, tile_w)
    raise ValueError(f"coverage_chunks: unsupported device {dev}")


def coverage_chunks_t(chunk_edges: torch.Tensor, tile_h: int, tile_w: int,
                      variant: str = "row", unroll: int = 0) -> torch.Tensor:
    """(TH*TW, NC) pixel-major chunk coverage: the counterpart of vgtpu's
    coverage_chunks_pallas_t_raw.  On CUDA variant "row" launches kernel K4
    (the TPU kernel _kernel_t2) and "flat" kernel K5 (_kernel_t); on the
    CPU both take the plain twin.  Every route sums the edges in edge order:
    `unroll` is accepted for vgtpu's signature, and its grouping of edges
    (a reassociation of the TPU kernel's sum) is ignored, as K1 and K4
    ignore it."""
    if variant not in ("row", "flat"):
        raise ValueError(f"coverage_chunks_t: unknown variant {variant!r}")
    dev = chunk_edges.device
    if dev.type == "cuda":
        if variant == "flat":
            from vgtpu_torch.ops.coverage_t_flat_cuda import (
                coverage_chunks_t_flat_cuda,
            )

            return coverage_chunks_t_flat_cuda(chunk_edges, tile_h, tile_w)
        from vgtpu_torch.ops.coverage_t_cuda import coverage_chunks_t_cuda

        return coverage_chunks_t_cuda(chunk_edges, tile_h, tile_w)
    if dev.type == "cpu":
        return coverage_chunks_t_torch(chunk_edges, tile_h, tile_w)
    raise ValueError(f"coverage_chunks_t: unsupported device {dev}")


def coverage_pools_t(chunk_edges: list, tile_h: int, tile_w: int) -> list:
    """[(TH*TW, NC_i)] pixel-major coverage of every pool: kernel K4 on CUDA
    (one launch over all the pools), the plain twin per pool on the CPU."""
    dev = chunk_edges[0].device
    if dev.type == "cuda":
        from vgtpu_torch.ops.coverage_t_cuda import coverage_pools_t_cuda

        return coverage_pools_t_cuda(chunk_edges, tile_h, tile_w)
    if dev.type == "cpu":
        return [coverage_chunks_t_torch(ce, tile_h, tile_w) for ce in chunk_edges]
    raise ValueError(f"coverage_pools_t: unsupported device {dev}")


def entry_coverage_from_pools(chunk_edges: list, chunk_entry: list,
                              num_entries: int, tile_h: int,
                              tile_w: int) -> torch.Tensor:
    """Per-entry coverage (NE, TH, TW) of pooled chunks: the twin of vgtpu's
    entry_coverage_from_pools, which the sharded frame and the variant-sharded
    batch take.  Every pool's pixel-major coverage (kernel K4 on CUDA, one
    launch over the pools) is segment-summed over its chunk -> entry map
    (index_add_ over chunks into an (NE, NPX) accumulator), and the pools'
    sums add in pool order.  On CUDA index_add_ is atomic, so a multi-chunk
    entry's adds land in no fixed order; on the CPU they run in chunk order,
    as XLA's segment_sum does."""
    npx = tile_h * tile_w
    if not chunk_edges:
        raise ValueError("entry_coverage_from_pools: no chunk pools")
    acc = None
    covs = coverage_pools_t(chunk_edges, tile_h, tile_w)
    for cov_t, cent in zip(covs, chunk_entry, strict=True):
        part = torch.zeros((num_entries, npx), dtype=torch.float32,
                           device=cov_t.device)
        part.index_add_(0, cent, cov_t.t())
        acc = part if acc is None else acc + part
    return acc.reshape(num_entries, tile_h, tile_w)


def build_cov_gather_map(chunk_pools, num_entries: int) -> dict:
    """Host-side (numpy) inverse of the chunk->entry map (copied from
    vgtpu/ops/coverage.py).

    Most entries own exactly ONE chunk, so the chunk->entry reduction is a
    near-permutation: entry coverage = one gather of each entry's primary
    chunk + a small scatter-add of the leftover chunks of multi-chunk
    entries.

    Returns numpy arrays:
      primary (NE,) i32   — global chunk id per entry (dead id = all-zeros)
      extra_chunk (K,)    — leftover chunk ids (padded with the dead id)
      extra_entry (K,)    — their entries (padded with NE-1, a pad entry)
      extra_primary (K,)  — the rows the extras fold into (cov_all_resolved)
    """
    from vgtpu_torch.raster.binning import _bucket

    cents = [np.asarray(cent) for _ce, cent in chunk_pools]
    cent_all = np.concatenate(cents) if cents else np.zeros(0, np.int64)
    total = len(cent_all)
    # liveness: a chunk with only zero-height edges contributes exactly zero
    alive = np.concatenate([
        (np.abs(np.asarray(ce)[:, :, 3] - np.asarray(ce)[:, :, 1]) > 1e-12).any(axis=1)
        for ce, _cent in chunk_pools
    ]) if cents else np.zeros(0, bool)

    dead_id = total             # index of the appended all-zeros row
    primary = np.full(num_entries, dead_id, np.int32)
    # first chunk per entry without a sort: reversed assignment makes the
    # FIRST occurrence win
    valid = (cent_all >= 0) & (cent_all < num_entries)
    idxs = np.arange(total, dtype=np.int32)
    primary[cent_all[valid][::-1]] = idxs[valid][::-1]
    is_first = np.zeros(total, bool)
    first_idx = primary[cent_all[valid]]
    is_first[first_idx] = True
    em = alive & ~is_first
    extra_chunk = np.nonzero(em)[0].astype(np.int32)
    extra_entry = cent_all[em].astype(np.int32)
    k = _bucket(max(len(extra_chunk), 1), minimum=8)
    ec = np.full(k, dead_id, np.int32)
    ee = np.full(k, num_entries - 1, np.int32)   # pad entry: zero adds land there
    ec[: len(extra_chunk)] = extra_chunk
    ee[: len(extra_entry)] = extra_entry
    return {
        "primary": primary,
        "extra_chunk": ec,
        "extra_entry": ee,
        "extra_primary": primary[ee],
    }


def cov_all_torch(chunk_edges: list, tile_h: int, tile_w: int,
                  window: ViewWindow | None = None,
                  chunk_tiles: list | None = None) -> torch.Tensor:
    """All pools' per-chunk coverage as ONE (NC+1, NPX) tensor, the last row
    the all-zeros dead chunk that chunkless entries index: the plain twin of
    vgtpu's _cov_all, on the tensors' own device.  With a view window
    (chunk_tiles: each pool's (NC,) scene tile ids) only the chunks of the
    window's tiles are computed, each as it would be among all; the other
    rows hold zeros here (K1 leaves them unwritten)."""
    if (window is None) != (chunk_tiles is None) or (
            chunk_tiles is not None and len(chunk_tiles) != len(chunk_edges)):
        raise ValueError("cov_all_torch: a view window takes one chunk-tile "
                         "array a pool")
    npx = tile_h * tile_w
    covs = []
    for k, ce in enumerate(chunk_edges):
        if window is None:
            covs.append(coverage_chunks_torch(ce, tile_h, tile_w).reshape(-1, npx))
            continue
        keep = window.holds(chunk_tiles[k].long()).nonzero().flatten()
        part = ce.new_zeros((ce.shape[0], npx))
        if keep.numel():
            part[keep] = coverage_chunks_torch(ce[keep], tile_h, tile_w).reshape(-1, npx)
        covs.append(part)
    covs.append(torch.zeros((1, npx), dtype=torch.float32,
                            device=chunk_edges[0].device))
    return torch.cat(covs, dim=0)


def cov_all(chunk_edges: list, tile_h: int, tile_w: int,
            window: ViewWindow | None = None,
            chunk_tiles: list | None = None) -> torch.Tensor:
    """(NC+1, NPX) chunk coverage of every pool: kernel K1 on CUDA (one
    launch over every pool and the dead row, written in place into one
    preallocated tensor), the plain twin on the CPU.  With a view window
    and each pool's chunk tiles, only the chunks of the window's tiles and
    the dead row are computed (cov_all_torch)."""
    dev = chunk_edges[0].device
    if dev.type == "cuda":
        from vgtpu_torch.ops.coverage_cuda import cov_all_cuda

        return cov_all_cuda(chunk_edges, tile_h, tile_w, window, chunk_tiles)
    if dev.type == "cpu":
        return cov_all_torch(chunk_edges, tile_h, tile_w, window, chunk_tiles)
    raise ValueError(f"cov_all: unsupported device {dev}")


def fold_extras(cov: torch.Tensor, cov_map: dict) -> torch.Tensor:
    """Fold multi-chunk entries' extra chunk rows into their primary row, in
    place on `cov` (returned).  The sources are gathered before the add, as
    in vgtpu's `.at[extra_primary].add(cov_all[extra_chunk])`; primary rows
    are unique per entry and extra rows are only ever sources."""
    src = cov.index_select(0, cov_map["extra_chunk"])
    return cov.index_add_(0, cov_map["extra_primary"], src)


def cov_all_resolved(chunk_edges: list, cov_map: dict, tile_h: int,
                     tile_w: int, window: ViewWindow | None = None,
                     chunk_tiles: list | None = None) -> torch.Tensor:
    """Chunk coverage with extras folded in, so entry coverage ==
    cov_all[primary[e]]: the fused composite gathers straight from it and
    the (NE, NPX) entry coverage is never materialized.  Under a view
    window (cov_all) the rows of the window's entries are exact: an
    entry's extra chunks share its tile."""
    return fold_extras(cov_all(chunk_edges, tile_h, tile_w, window, chunk_tiles),
                       cov_map)


def cov_all_resolved_torch(chunk_edges: list, cov_map: dict, tile_h: int,
                           tile_w: int, window: ViewWindow | None = None,
                           chunk_tiles: list | None = None) -> torch.Tensor:
    """cov_all_resolved through the plain twin, on the tensors' own device
    (the reference the CUDA path is held against)."""
    return fold_extras(cov_all_torch(chunk_edges, tile_h, tile_w, window, chunk_tiles),
                       cov_map)
