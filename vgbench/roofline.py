"""The frozen roofline arithmetic: the least work a frame needs, from the
frame's own edges and the configuration's tile shape.

The counts come from the reference recorder's ops (reference/vg.py) of
the same frame, never from the program's chunks, pools, buckets or
launches, so they read the same work whatever kernel implements it.  The
arithmetic follows chip_smoke.py's bound, k2_work and live (edge, row)
count, restated on the frame:

coverage (K1, K3)
    Every edge is cut at the tile columns; a piece adds to a tile row only
    where its height in that row is above zero (a live (edge, row) pair,
    rows in sub-rows at coverage_supersample > 1).  Per live pair a row of
    tile_w pixels at ~12 operations each plus ~6 for the row; each piece
    read once (16 bytes) and each (op, tile) coverage plane with an edge
    written once at output rows (tile_h x tile_w x 4 bytes).
composite (K2)
    An (op, tile) entry is a tile an op's edges touch, a tile its fill
    reaches without an edge (the winding at a row's centre passes its
    rule), or a tile its glyph quads reach; entries outside the op's
    scissor are dropped.  Each entry reads its parameters (128 bytes), an
    edge entry its coverage plane, a textured entry its colour tile (16
    bytes a pixel); each tile with an entry is written once (16 bytes a
    pixel); ~20 operations per entry and output pixel.
static layer
    A prefix of ops the frame shares with the frame before it (fixed
    artwork under a live UI) needs no work again: only the ops after it
    count, and each tile they touch reads the kept layer once more.

A bound is the larger of bytes over the HBM rate and operations over the
FP32 rate of one H100 SXM (NVIDIA's data sheet, 700 W)."""

from __future__ import annotations

import numpy as np

PEAK_FLOPS = 67e12        # FP32, outside the tensor cores
PEAK_BYTES = 3.35e12      # HBM3

_K_DRAW, _K_CLIP_ADD = 0, 1
_P_TEXTURE = 3


def bound_ms(nbytes: float, ops: float) -> float:
    """The least milliseconds the card could take for the work."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_FLOPS) * 1e3


def _pieces(e: np.ndarray, tile_w: int, width: int):
    """Edges (E, 4) cut at the tile columns: (edge index, column, y top,
    y bottom) of each piece inside [0, width)."""
    x0, y0, x1, y1 = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
    xa = np.clip(np.minimum(x0, x1), 0.0, width - 1e-3)
    xb = np.clip(np.maximum(x0, x1), 0.0, width - 1e-3)
    c0 = np.floor(xa / tile_w).astype(np.int64)
    c1 = np.floor(xb / tile_w).astype(np.int64)
    inside = np.maximum(x0, x1) >= 0.0
    inside &= np.minimum(x0, x1) < width
    n = np.where(inside, c1 - c0 + 1, 0)
    idx = np.repeat(np.arange(len(e)), n)
    col = np.repeat(c0, n) + (np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n))
    ex0, ey0, ex1, ey1 = x0[idx], y0[idx], x1[idx], y1[idx]
    dx = ex1 - ex0
    # y where the edge crosses the column's two sides, clamped to the edge
    with np.errstate(divide="ignore", invalid="ignore"):
        ta = np.where(dx != 0, (col * tile_w - ex0) / dx, 0.0)
        tb = np.where(dx != 0, ((col + 1) * tile_w - ex0) / dx, 1.0)
    ta, tb = np.clip(np.minimum(ta, tb), 0, 1), np.clip(np.maximum(ta, tb), 0, 1)
    ya = ey0 + (ey1 - ey0) * ta
    yb = ey0 + (ey1 - ey0) * tb
    return idx, col, np.minimum(ya, yb), np.maximum(ya, yb)


def _fill_tiles(e: np.ndarray, rule: int, tile_w: int, th_s: int, ntx: int,
                nty: int) -> np.ndarray:
    """Flat ids of the tiles in which the fill passes its rule at some row
    centre and tile column centre (the winding there counts the edges
    crossing the row at or left of the point)."""
    y0, y1 = e[:, 1], e[:, 3]
    ymin, ymax = np.minimum(y0, y1), np.maximum(y0, y1)
    lo = max(int(np.floor(ymin.min())), 0)
    hi = min(int(np.ceil(ymax.max())), nty * th_s)
    if hi <= lo:
        return np.zeros(0, np.int64)
    # rows r whose centre r + 0.5 lies in [ymin, ymax)
    ra = np.maximum(np.ceil(ymin - 0.5).astype(np.int64), lo)
    rb = np.minimum(np.ceil(ymax - 0.5).astype(np.int64), hi)
    n = np.maximum(rb - ra, 0)
    idx = np.repeat(np.arange(len(e)), n)
    row = np.repeat(ra, n) + (np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n))
    x0, x1 = e[idx, 0], e[idx, 2]
    xc = x0 + (row + 0.5 - y0[idx]) * (x1 - x0) / (y1[idx] - y0[idx])
    col = np.clip(np.ceil((xc - tile_w / 2.0) / tile_w), 0, ntx).astype(np.int64)
    grid = np.zeros((hi - lo, ntx + 1), np.int64)
    np.add.at(grid, (row - lo, col), np.sign(y1[idx] - y0[idx]).astype(np.int64))
    w = np.cumsum(grid, axis=1)[:, :ntx]
    inside = (w != 0) if rule == 0 else (np.abs(w) % 2 == 1)
    band = np.arange(lo, hi) // th_s
    t_rows, cols = np.nonzero(inside)
    return np.unique(band[t_rows] * ntx + cols)


def _same_op(a, b) -> bool:
    def same(x, y):
        if x is None or y is None:
            return x is None and y is None
        return np.array_equal(np.asarray(x), np.asarray(y))

    return (a.kind == b.kind and a.fill_rule == b.fill_rule and a.aa == b.aa
            and a.paint_kind == b.paint_kind and a.scissor == b.scissor
            and a.image_id == b.image_id and same(a.edges, b.edges)
            and same(a.paint, b.paint) and same(a.tex_quads, b.tex_quads)
            and same(a.tri_paints, b.tri_paints))


def static_prefix(ops, prev_ops) -> int:
    """The number of leading ops the frame shares with the frame before."""
    n = 0
    for a, b in zip(ops, prev_ops or ()):
        if not _same_op(a, b):
            break
        n += 1
    return n


def frame_work(ops, width: int, height: int, ss: int, tile_w: int,
               tile_h: int, prev_ops=None) -> dict:
    """{"coverage": (bytes, ops), "composite": (bytes, ops)} of one frame
    from its recorded ops (screen space, output pixels).  With the frame
    before's ops, a prefix the two share is drawn once and kept: only the
    ops after it count, and each tile they touch reads the kept layer once
    more (16 bytes a pixel)."""
    n_static = static_prefix(ops, prev_ops)
    ops = ops[n_static:]
    th_s = tile_h * ss
    hs = height * ss
    ntx = -(-width // tile_w)
    nty = -(-hs // th_s)
    npx = tile_h * tile_w
    pieces_n = live_pairs = 0
    edge_entries = entries = tex_entries = 0
    touched = np.zeros(ntx * nty, bool)
    for op in ops:
        if op.kind not in (_K_DRAW, _K_CLIP_ADD):
            continue
        sc = op.scissor
        if op.paint_kind == _P_TEXTURE:
            if op.tex_quads is None or not len(op.tex_quads):
                continue
            q = np.asarray(op.tex_quads, np.float64)
            xs = np.stack([q[:, 0], q[:, 0] + q[:, 2], q[:, 0] + q[:, 4], q[:, 0] + q[:, 2] + q[:, 4]])
            ys = np.stack([q[:, 1], q[:, 1] + q[:, 3], q[:, 1] + q[:, 5], q[:, 1] + q[:, 3] + q[:, 5]])
            tiles = set()
            for xa, xb, ya, yb in zip(xs.min(0) - 1, xs.max(0) + 1, ys.min(0) - 1, ys.max(0) + 1):
                if sc is not None:
                    xa, xb = max(xa, sc[0]), min(xb, sc[2])
                    ya, yb = max(ya, sc[1]), min(yb, sc[3])
                cx = range(max(int(xa // tile_w), 0), min(int(xb // tile_w), ntx - 1) + 1)
                cy = range(max(int(ya * ss // th_s), 0), min(int(yb * ss // th_s), nty - 1) + 1)
                tiles.update(r * ntx + c for r in cy for c in cx if xb > xa and yb > ya)
            tex_entries += len(tiles)
            entries += len(tiles)
            touched[list(tiles)] = True
            continue
        e = np.asarray(op.edges, np.float64).reshape(-1, 4)
        e = e[e[:, 1] != e[:, 3]] * np.array([1.0, ss, 1.0, ss])
        if not len(e):
            continue
        idx, col, ya, yb = _pieces(e, tile_w, width)
        ya, yb = np.clip(ya, 0, hs), np.clip(yb, 0, hs)
        keep = yb > ya
        col, ya, yb = col[keep], ya[keep], yb[keep]
        # live rows of each piece, then the tile rows they fall in
        r0 = np.floor(ya).astype(np.int64)
        r1 = np.ceil(yb).astype(np.int64)
        t0, t1 = r0 // th_s, (r1 - 1) // th_s
        nt = t1 - t0 + 1
        tile_of = (np.repeat(t0, nt) + (np.arange(int(nt.sum())) - np.repeat(np.cumsum(nt) - nt, nt))) * ntx \
            + np.repeat(col, nt)
        pieces_n += int(nt.sum())
        live_pairs += int((r1 - r0).sum())
        etiles = np.unique(tile_of)
        # tiles the fill reaches without an edge crossing them
        cand = np.setdiff1d(_fill_tiles(e, op.fill_rule, tile_w, th_s, ntx, nty), etiles)
        tiles = np.concatenate([etiles, cand])
        if sc is not None:
            tx, ty = tiles % ntx, tiles // ntx
            ok = ((tx * tile_w < sc[2]) & ((tx + 1) * tile_w > sc[0])
                  & (ty * th_s < sc[3] * ss) & ((ty + 1) * th_s > sc[1] * ss))
            etiles = np.intersect1d(etiles, tiles[ok])
            tiles = tiles[ok]
        edge_entries += len(etiles)
        entries += len(tiles)
        touched[tiles] = True
    n_touched = int(touched.sum())
    coverage = (pieces_n * 16 + edge_entries * npx * 4, live_pairs * (tile_w * 12 + 6))
    composite = (edge_entries * npx * 4 + entries * 128 + tex_entries * npx * 16
                 + n_touched * npx * 16 * (2 if n_static else 1), entries * npx * 20)
    return {"coverage": coverage, "composite": composite,
            "counts": {"pieces": pieces_n, "live_pairs": live_pairs,
                       "edge_entries": edge_entries, "entries": entries,
                       "tex_entries": tex_entries, "tiles": n_touched,
                       "static_prefix": n_static}}
