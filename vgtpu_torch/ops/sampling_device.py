# Copied from vgtpu/ops/sampling_device.py: build_sampling_plan and its
# dataclasses are the jax-free host half; the sampler is rewritten in torch.
"""Device-side texture sampling: colour tiles for image-pattern fills and
textured text quads computed on the plan's device (the counterpart of
vgtpu/ops/sampling_device.py).

The reference computes pattern UVs in-shader from the inverse paint matrix
(src/shaders/vs_image_pattern.sc, rationale vg.cpp:104-111) and samples per
fragment; here, as in vgtpu, each tile or quad samples through a bilinear
SAMPLING MATRIX pair — hat-function interpolation weights contracted
against the texture with two matrix products:

    tile(r, c) = sum_h sum_w  Wr[r, h] * tex[h, w] * Wc[c, w]

The separable form needs an axis-aligned UV mapping (unrotated text and
patterns); rotated content takes an exact per-pixel gather, chosen per group
when the plan is built.  This is plain torch, as vgtpu's sampler is plain
XLA: no kernel of the TPU port is involved.  The products stay in float32
(the hat weights sum to one only there): run with torch's default float32
matmul precision ("highest"), never TF32.  The a*b+c sites that XLA on the
CPU contracts into fused multiply-adds (the texel coordinates) are explicit
FMAs (ops/coverage.fma), so the tiles track vgtpu's rounding: a texel
coordinate near 100 has an ulp of ~8e-6, which the bilinear weights carry
into the colour.

The host sampler (raster/sampling.py) stays the oracle: tests hold the two
to the same tolerance vgtpu's own test does.

On CUDA the sampler is kernel S1 (csrc/sample_tiles.cu, ops/sampling_cuda.py):
one launch for every group, tile-major, two taps per axis instead of dense
weights, each quad sampled only inside its footprint (footprint_boxes),
written straight into K2's colour-tile layout.  upload_groups packs what S1
reads (build_tile_index: each tile's pairs in index_add_'s order, the tiles
by falling pair count, the group table) into the same one host-to-device
copy as the groups; sample_tiles_flat routes CUDA groups to S1 and CPU
groups, or plain=True on any device, to sample_groups, which stays S1's
twin.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from vgtpu_torch.core import ImageFlags
from vgtpu_torch.ops.composite import color_tiles_view, flat_color_tiles
from vgtpu_torch.ops.coverage import fma
from vgtpu_torch.raster.binning import P_IMAGE, P_TEXTURE, FramePlan, _bucket

_IW_CHUNK = 1024      # weight-matrix lane chunk: caps the (K, TH, chunk, C) product


@dataclass
class SampleGroup:
    """One statically-shaped sampling batch: same image, same flags, same
    kind (quad / pattern), same path (separable / gather)."""

    image_id: int
    flags: int
    kind: int                   # P_TEXTURE (quads) or P_IMAGE (pattern)
    separable: bool
    ct: np.ndarray              # (K,) i32 target color-tile index
    params: np.ndarray          # (K, 12) f32, see build_sampling_plan
    color: np.ndarray           # (K, 4) f32 straight-alpha modulation color


@dataclass
class SamplingPlan:
    groups: list = field(default_factory=list)
    num_tiles: int = 0          # NCT
    tex_tile_mask: np.ndarray | None = None   # (NCT,) tiles that clip to 1


def build_sampling_plan(plan: FramePlan, ops, images,
                        pan_margin: bool = False) -> SamplingPlan:
    """Host pass (no sampling): assigns entry_color_tile and produces padded
    per-group parameter arrays for the device sampler.  `images` maps
    image id -> (data u8, flags[, generation]).

    pan_margin: generate (entry, quad) pairs for the tile's whole REACHABLE
    sample window [ox, ox+2*tw) x [oy, oy+2*th) — retained-pan scenes shift
    content left/up by sub-tile residuals (raster/retained.py), so a quad
    can enter a tile it does not overlap at rest."""
    ss = plan.supersample
    th, tw = plan.tile_h // ss, plan.tile_w   # OUTPUT-space tile rows
    n = plan.n_real_entries
    pk = plan.entry_paint_kind[:n]
    need = np.nonzero((pk == P_IMAGE) | (pk == P_TEXTURE))[0]
    sp = SamplingPlan()
    if len(need) == 0:
        return sp

    # color-tile ids in `need` order
    nct = len(need)
    plan.entry_color_tile[need] = np.arange(nct, dtype=np.int32)
    sp.num_tiles = nct
    sp.tex_tile_mask = pk[need] == P_TEXTURE

    raw: dict = {}   # (img, flags, kind, separable) -> [(ct, params, color)]
    tiles = plan.entry_tile[need]
    oxs = ((tiles % plan.ntx) * tw).astype(np.float64)
    oys = ((tiles // plan.ntx) * th).astype(np.float64)
    eop = plan.entry_op[need]
    # entries are op-major, so one pass per textured OP keeps the original
    # (entry, quad) row order
    starts = np.concatenate([[0], np.nonzero(np.diff(eop))[0] + 1, [len(need)]])
    for si in range(len(starts) - 1):
        a, b = int(starts[si]), int(starts[si + 1])
        ei0 = need[a]
        kind = int(pk[ei0])
        img_id = int(plan.entry_image[ei0])
        flags = int(images[img_id][1]) if img_id in images else 0
        paint = plan.entry_paint[ei0]
        col = np.asarray(paint[10:14], np.float32)
        cts = np.arange(a, b, dtype=np.int64)
        ox = oxs[a:b]
        oy = oys[a:b]

        if kind == P_IMAGE:
            m = np.asarray(paint[0:6], np.float64)
            separable = abs(float(m[1])) < 1e-12 and abs(float(m[2])) < 1e-12
            pr = np.zeros((b - a, 12), np.float64)
            pr[:, 0] = ox
            pr[:, 1] = oy
            pr[:, 2:8] = m[None, :]
            key = (img_id, flags, P_IMAGE, separable)
            g = raw.setdefault(key, {"ct": [], "params": [], "color": []})
            g["ct"].append(cts)
            g["params"].append(pr)
            g["color"].append(np.broadcast_to(col, (b - a, 4)))
            continue

        # P_TEXTURE: (entry, quad) pairs by bbox overlap.  These are the
        # caller's ORIGINAL ops (y unscaled): only tile origins needed
        # output-space correction under supersampling
        q = np.asarray(ops[int(eop[a])].tex_quads, np.float64)
        cxs = np.stack([q[:, 0], q[:, 0] + q[:, 2], q[:, 0] + q[:, 4],
                        q[:, 0] + q[:, 2] + q[:, 4]])
        cys = np.stack([q[:, 1], q[:, 1] + q[:, 3], q[:, 1] + q[:, 5],
                        q[:, 1] + q[:, 3] + q[:, 5]])
        qx0, qx1 = cxs.min(axis=0), cxs.max(axis=0)
        qy0, qy1 = cys.min(axis=0), cys.max(axis=0)
        exx, exy, eyx, eyy = q[:, 2], q[:, 3], q[:, 4], q[:, 5]
        q_ok = np.abs(exx * eyy - exy * eyx) >= 1e-12
        reach = 2 if pan_margin else 1
        overlap = (
            (qx0[None, :] < (ox + reach * tw + 1)[:, None])
            & (qx1[None, :] > (ox - 1)[:, None])
            & (qy0[None, :] < (oy + reach * th + 1)[:, None])
            & (qy1[None, :] > (oy - 1)[:, None])
            & q_ok[None, :]
        )
        pe, pq = np.nonzero(overlap)             # row-major = entry-major
        if not len(pe):
            continue
        q_sep = (np.abs(exy) < 1e-12) & (np.abs(eyx) < 1e-12)
        for separable in (False, True):
            m2 = q_sep[pq] == separable
            if not m2.any():
                continue
            e2, q2 = pe[m2], pq[m2]
            pr = np.zeros((len(e2), 12), np.float64)
            pr[:, 0] = ox[e2]
            pr[:, 1] = oy[e2]
            pr[:, 2:12] = q[q2, 0:10]
            key = (img_id, flags, P_TEXTURE, bool(separable))
            g = raw.setdefault(key, {"ct": [], "params": [], "color": []})
            g["ct"].append(cts[e2])
            g["params"].append(pr)
            g["color"].append(np.broadcast_to(col, (len(e2), 4)))

    for (img_id, flags, kind, separable), g in sorted(raw.items()):
        cti = np.concatenate(g["ct"])
        k = len(cti)
        kp = _bucket(k, minimum=8)
        ct = np.full(kp, nct, np.int32)          # pad -> scratch tile row NCT
        ct[:k] = cti
        params = np.zeros((kp, 12), np.float32)
        params[:k] = np.concatenate(g["params"]).astype(np.float32)
        if kind == P_TEXTURE:
            params[k:, 4] = 1.0                  # exx/eyy nonzero on pad rows
            params[k:, 7] = 1.0
        else:
            params[k:, 2] = 1.0                  # m0/m3
            params[k:, 5] = 1.0
        color = np.zeros((kp, 4), np.float32)
        color[:k] = np.concatenate(g["color"])
        sp.groups.append(SampleGroup(img_id, flags, kind, separable, ct, params, color))
    return sp


# ---------------------------------------------------------------------------
# device sampler
# ---------------------------------------------------------------------------

def _nearest(flags: int) -> bool:
    return (not (flags & ImageFlags.Filter_LinearUV)) and bool(flags & ImageFlags.Filter_NearestUV)


def _axis_weights(t, size: int, w0: int, wn: int, flags: int, clamp_flag: int,
                  nearest: bool):
    """Hat (bilinear) or indicator (nearest) weights of texel coordinates t
    (K, P) against texel indices [w0, w0+wn): returns (K, P, wn).

    Matches raster/sampling.py's _bilinear: x = t - 0.5; taps floor(x),
    floor(x)+1 with clamp or repeat wrap.  torch.remainder takes the
    divisor's sign, as jnp.mod does (torch.fmod would not)."""
    x = t - 0.5
    tx = (w0 + torch.arange(wn, dtype=torch.float32, device=t.device))[None, None, :]
    if nearest:
        xr = torch.round(x)
        if flags & clamp_flag:
            xr = torch.clamp(xr, 0.0, size - 1.0)
            d = xr[..., None] - tx
            return (torch.abs(d) < 0.5).to(torch.float32)
        d = torch.remainder(xr[..., None] - tx, float(size))
        return ((d < 0.5) | (d > size - 0.5)).to(torch.float32)
    if flags & clamp_flag:
        xc = torch.clamp(x, 0.0, size - 1.0)
        d = xc[..., None] - tx
        # at xc integer the hat gives weight 1 at one texel and 0 elsewhere,
        # the same as the two-tap form
        return torch.clamp_min(1.0 - torch.abs(d), 0.0)
    d = torch.remainder(x[..., None] - tx, float(size))
    return torch.clamp_min(1.0 - d, 0.0) + torch.clamp_min(1.0 - (float(size) - d), 0.0)


def _sample_separable(tex, tu, tv, flags: int):
    """tu (K, TW), tv (K, TH) texel coords -> (K, TH, TW, C) samples (quad
    coverage is applied by the caller): two float32 products per column
    chunk of the texture."""
    ih, iw = tex.shape[0], tex.shape[1]
    nearest = _nearest(flags)
    wr = _axis_weights(tv, ih, 0, ih, flags, ImageFlags.Clamp_V, nearest)  # (K,TH,IH)
    out = None
    for w0 in range(0, iw, _IW_CHUNK):
        wn = min(_IW_CHUNK, iw - w0)
        wc = _axis_weights(tu, iw, w0, wn, flags, ImageFlags.Clamp_U, nearest)  # (K,TW,wn)
        t = torch.einsum("krh,hwc->krwc", wr, tex[:, w0 : w0 + wn])
        part = torch.einsum("kcw,krwz->krcz", wc, t)
        out = part if out is None else out + part
    return out  # (K, TH, TW, C)


def _sample_gather(tex, u, v, flags: int):
    """Exact per-pixel bilinear/nearest gather (the rotated fallback)."""
    ih, iw = tex.shape[0], tex.shape[1]
    x = u - 0.5
    y = v - 0.5

    def wrapx(i):
        return torch.clamp(i, 0, iw - 1) if (flags & ImageFlags.Clamp_U) else torch.remainder(i, iw)

    def wrapy(i):
        return torch.clamp(i, 0, ih - 1) if (flags & ImageFlags.Clamp_V) else torch.remainder(i, ih)

    if _nearest(flags):
        return tex[wrapy(torch.round(y).long()), wrapx(torch.round(x).long())]
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    p00 = tex[wrapy(y0), wrapx(x0)]
    p10 = tex[wrapy(y0), wrapx(x0 + 1)]
    p01 = tex[wrapy(y0 + 1), wrapx(x0)]
    p11 = tex[wrapy(y0 + 1), wrapx(x0 + 1)]
    # XLA's contraction: each later product's last multiply fused into the
    # running sum
    acc = p00 * (1 - fx) * (1 - fy)
    acc = fma(p10 * fx, 1 - fy, acc)
    acc = fma(p01 * (1 - fx), fy, acc)
    return fma(p11 * fx, fy, acc)


# S1's input (ops/sampling_cuda.py, csrc/sample_tiles.cu): the words of ONE
# int32 upload, laid out as
#   group table   GROUP_WORDS a group: texture pointer (2 words), h, w, C,
#                 flags, kind, separable
#   rows          ROW_WORDS a row, float32 bits: params 12, colour 4, ct 1
#   tile offsets  NCT+1: tile t's pairs are pairs[offsets[t]:offsets[t+1]]
#   clip flags    NCT+1: 1 where the tile saturates (textured quads), 0 on
#                 the zeros row
#   tile order    NCT+1: the colour tiles (the zeros row NCT among them) by
#                 falling pair count, S1's block order
#   pairs         2 a pair: (row, group), sorted by tile
GROUP_WORDS = 8
ROW_WORDS = 17
MAX_SPAN = 1e6      # csrc/sample_tiles.cu kMaxSpan: px, past it a footprint is the tile


def footprint_boxes(rows: np.ndarray, quad: np.ndarray, separable: np.ndarray,
                    th: int, tw: int, shift=(0.0, 0.0)) -> np.ndarray:
    """S1's footprints (csrc/sample_tiles.cu quad_box) in numpy, the same
    float32 operations: per pair, the pixels [x0, x1) x [y0, y1) of its
    th x tw tile that S1 samples it at, at `shift`; outside them the twin
    adds an exact zero.  rows: (P, >= 12) float32 pair rows (params first);
    quad, separable: (P,) bool, the pair's group kind is P_TEXTURE, its
    group separable.  Returns (P, 4) int64 x0, x1, y0, y1, clipped to the
    tile (x1 <= x0 or y1 <= y0: empty).  Pattern fills, and quads whose
    inverse is not finite, that are degenerate or sheared past MAX_SPAN's
    reach, take the whole tile."""
    f = np.float32
    p = np.asarray(rows, np.float32)
    n = len(p)
    box = np.tile(np.array([0, tw, 0, th], np.int64), (n, 1))
    if not n:
        return box
    gx, gy = p[:, 0] + f(shift[0]), p[:, 1] + f(shift[1])
    exx, exy, eyx, eyy = p[:, 4], p[:, 5], p[:, 6], p[:, 7]
    with np.errstate(all="ignore"):
        det = exx * eyy - exy * eyx
        i00, i01, i10, i11 = eyy / det, -eyx / det, -exy / det, exx / det
        d = [i.astype(np.float64) for i in (i00, i01, i10, i11)]
        wa = np.fmax(np.sqrt(d[0] * d[0] + d[1] * d[1]).astype(np.float32), f(1e-9))
        wb = np.fmax(np.sqrt(d[2] * d[2] + d[3] * d[3]).astype(np.float32), f(1e-9))
        qx, qy = p[:, 2] - gx, p[:, 3] - gy
        a0, a1 = f(-0.5) * wa, f(1) + f(0.5) * wa
        b0, b1 = f(-0.5) * wb, f(1) + f(0.5) * wb
        sep = np.asarray(separable, bool)
        xlo = np.where(sep, np.fmin(a0 / i00, a1 / i00),
                       np.fmin(a0 * exx, a1 * exx) + np.fmin(b0 * eyx, b1 * eyx))
        xhi = np.where(sep, np.fmax(a0 / i00, a1 / i00),
                       np.fmax(a0 * exx, a1 * exx) + np.fmax(b0 * eyx, b1 * eyx))
        ylo = np.where(sep, np.fmin(b0 / i11, b1 / i11),
                       np.fmin(a0 * exy, a1 * exy) + np.fmin(b0 * eyy, b1 * eyy))
        yhi = np.where(sep, np.fmax(b0 / i11, b1 / i11),
                       np.fmax(a0 * exy, a1 * exy) + np.fmax(b0 * eyy, b1 * eyy))
        ea, eb = np.abs(exx) + np.abs(exy), np.abs(eyx) + np.abs(eyy)
        shear = np.fmax(wa * ea, wb * eb)
        span = (shear * (ea + eb + f(4) * shear) + np.abs(qx) + np.abs(qy)
                + np.abs(gx) + np.abs(gy))
        x0, x1 = np.ceil(qx + xlo - f(1.5)), np.floor(qx + xhi + f(0.5)) + f(1)
        y0, y1 = np.ceil(qy + ylo - f(1.5)), np.floor(qy + yhi + f(0.5)) + f(1)
        finite = (np.isfinite(i00) & np.isfinite(i01) & np.isfinite(i10)
                  & np.isfinite(i11))
        ok = (np.asarray(quad, bool) & finite & (span <= f(MAX_SPAN))
              & (x0 <= x1) & (y0 <= y1))
    box[ok, 0] = np.fmax(x0[ok], 0)
    box[ok, 1] = np.fmin(x1[ok], tw)
    box[ok, 2] = np.fmax(y0[ok], 0)
    box[ok, 3] = np.fmin(y1[ok], th)
    return box


@dataclass
class TileIndex:
    """The host half of S1's tile-major walk over a sampling plan's
    (entry, quad) rows, every group's rows concatenated in group order."""

    table: np.ndarray       # (G, 6) int32: h, w, C, flags, kind, separable
    offsets: np.ndarray     # (NCT+1,) int32
    clip: np.ndarray        # (NCT+1,) int32
    order: np.ndarray       # (NCT+1,) int32: tiles by falling pair count, stable
    pairs: np.ndarray       # (P, 2) int32: (row, group), pad rows left out
    n_rotated: int = 0      # pairs in non-separable groups (the exact gather)
    footprint_px: int = 0   # (pair, pixel) slots inside the footprints at no shift
    pattern_tiles: int = 0  # colour tiles holding a pattern fill's pair


def build_tile_index(sp: SamplingPlan, shapes, tile) -> TileIndex:
    """The pairs of each colour tile in the order the twin's index_add_
    adds them on the CPU: by tile, then by row (groups in order, rows in
    order within a group); pad rows (ct == NCT) are left out.  shapes: per
    group its texture's (h, w, C).  tile: the (th, tw) the tiles are
    sampled at; footprint_px counts the (pair, pixel) slots S1 samples
    there at no shift (footprint_boxes); pattern_tiles the colour tiles
    that hold a pattern fill's (P_IMAGE) pair."""
    nct = sp.num_tiles
    ct = np.concatenate([g.ct for g in sp.groups] + [np.zeros(0, np.int32)]).astype(np.int64)
    grp = np.repeat(np.arange(len(sp.groups), dtype=np.int32),
                    [len(g.ct) for g in sp.groups])
    rows = np.nonzero(ct < nct)[0]
    rows = rows[np.argsort(ct[rows], kind="stable")]
    offsets = np.zeros(nct + 1, np.int32)
    np.cumsum(np.bincount(ct[rows], minlength=nct), out=offsets[1:])
    clip = np.zeros(nct + 1, np.int32)
    if sp.tex_tile_mask is not None:
        clip[:nct] = sp.tex_tile_mask
    table = np.array([(h, w, c, g.flags, g.kind, int(g.separable))
                      for g, (h, w, c) in zip(sp.groups, shapes)], np.int32)
    rotated = np.array([not g.separable for g in sp.groups] + [False], bool)
    footprint = pattern = 0
    if len(rows):
        params = np.concatenate([g.params for g in sp.groups])[rows]
        quad = np.array([g.kind == P_TEXTURE for g in sp.groups])[grp[rows]]
        box = footprint_boxes(params, quad, ~rotated[grp[rows]], *tile)
        footprint = int((np.clip(box[:, 1] - box[:, 0], 0, None)
                         * np.clip(box[:, 3] - box[:, 2], 0, None)).sum())
        pattern = len(np.unique(ct[rows][~quad]))
    order = np.argsort(-np.diff(offsets, append=offsets[-1]), kind="stable")
    return TileIndex(table.reshape(-1, 6), offsets, clip, order.astype(np.int32),
                     np.stack([rows.astype(np.int32), grp[rows]], axis=1),
                     int(rotated[grp[rows]].sum()), footprint, pattern)


@dataclass
class DeviceGroups:
    """A sampling plan's groups on a device, from one host-to-device copy:
    S1's int32 words (`words`, at the word offsets `at`) and, as views of
    the same memory, the twin's per-group (params (K, 12), colour (K, 4),
    ct (K,) int64) triples."""

    words: torch.Tensor
    at: dict                # "table", "rows", "offsets", "clip", "order", "pairs" -> word offset
    n_pairs: int
    arrs: tuple
    texs: tuple             # per group its f32 texture (h, w, C)
    meta: tuple             # per group (kind, separable, flags)
    num_tiles: int
    tile: tuple                # (th, tw) the tiles are sampled at
    n_rotated_pairs: int = 0   # TileIndex.n_rotated
    footprint_px: int = 0      # TileIndex.footprint_px
    pattern_tiles: int = 0     # TileIndex.pattern_tiles

    @property
    def clipmask(self) -> torch.Tensor:
        """(NCT+1,) bool of the tiles that saturate: the twin's clipmask."""
        a = self.at["clip"]
        return self.words[a : a + self.num_tiles + 1].bool()


def upload_groups(sp: SamplingPlan, texs, device, tile) -> DeviceGroups:
    """The plan's groups, their tile index and their textures' table on
    `device` from ONE host-to-device copy (the rows travel as float32 bits).
    texs: per group its f32 texture on `device` (h, w, C in [0, 1]; C=1 for
    A8), whose data pointer the table holds.  tile: as build_tile_index's."""
    texs = tuple(texs)
    idx = build_tile_index(sp, [tuple(t.shape) for t in texs], tile)
    ptrs = np.array([t.data_ptr() for t in texs], np.uint64).view(np.int32)
    table = np.concatenate([ptrs.reshape(-1, 2), idx.table], axis=1)
    rows = np.concatenate([np.zeros((0, ROW_WORDS), np.float32)] + [
        np.concatenate([g.params, g.color, g.ct[:, None].astype(np.float32)], axis=1)
        for g in sp.groups]).astype(np.float32)
    parts = [table, rows.view(np.int32), idx.offsets, idx.clip, idx.order, idx.pairs]
    at, n = {}, 0
    for name, part in zip(("table", "rows", "offsets", "clip", "order", "pairs"), parts):
        at[name] = n
        n += part.size
    words = torch.as_tensor(np.concatenate([x.reshape(-1) for x in parts])).to(device)
    flat = words[at["rows"] : at["offsets"]].view(torch.float32).view(-1, ROW_WORDS)
    arrs, k0 = [], 0
    for g in sp.groups:
        blk = flat[k0 : k0 + len(g.ct)]
        arrs.append((blk[:, 0:12], blk[:, 12:16], blk[:, 16].long()))
        k0 += len(g.ct)
    return DeviceGroups(words, at, len(idx.pairs), tuple(arrs), texs,
                        tuple((g.kind, g.separable, g.flags) for g in sp.groups),
                        sp.num_tiles, (int(tile[0]), int(tile[1])), idx.n_rotated,
                        idx.footprint_px, idx.pattern_tiles)


def sample_groups(arrs, texs, clipmask, *, meta, th: int, tw: int,
                  num_tiles: int, shift=(0.0, 0.0)) -> torch.Tensor:
    """The body of vgtpu's _sample_jit on tensors: every group's tiles ->
    (NCT, TH, TW, 4) premultiplied colour tiles on the groups' device.

    arrs: per group (params (K, 12), color (K, 4), ct (K,)); texs: per group
    its f32 texture (h, w, C in [0, 1]; C=1 for A8); clipmask: (NCT+1,)
    bool of the tiles that saturate (textured quads), or None; meta: per
    group (kind, separable, flags).  shift (sx, sy): float32 amounts added
    to every tile origin (params columns 0 and 1), the retained pan's
    residual — the same sums as vgtpu's params + shift12, whose other ten
    entries are zero.  Tiles of duplicate ct ids (text quads sharing a
    tile) sum through index_add_, which is atomic on CUDA."""
    dev = texs[0].device if texs else torch.device("cpu")
    tiles = torch.zeros((num_tiles + 1, th, tw, 4), dtype=torch.float32, device=dev)
    ixc = torch.arange(tw, dtype=torch.float32, device=dev) + 0.5
    iyc = torch.arange(th, dtype=torch.float32, device=dev) + 0.5
    sx, sy = shift

    for (kind, separable, flags), (p, col, ct), tex in zip(meta, arrs, texs):
        ih, iw = tex.shape[0], tex.shape[1]
        a8 = tex.shape[-1] == 1
        ox, oy = p[:, 0:1], p[:, 1:2]
        if sx or sy:
            ox, oy = ox + sx, oy + sy

        if kind == P_TEXTURE:
            p0x, p0y = p[:, 2:3], p[:, 3:4]
            exx, exy, eyx, eyy = p[:, 4], p[:, 5], p[:, 6], p[:, 7]
            u0, v0, u1, v1 = p[:, 8:9], p[:, 9:10], p[:, 10:11], p[:, 11:12]
            det = exx * eyy - exy * eyx
            i00 = (eyy / det)[:, None]
            i01 = (-eyx / det)[:, None]
            i10 = (-exy / det)[:, None]
            i11 = (exx / det)[:, None]
            wa = torch.clamp_min(torch.hypot(i00, i01), 1e-9)
            wb = torch.clamp_min(torch.hypot(i10, i11), 1e-9)
            if separable:
                rx = ox + ixc[None, :] - p0x                 # (K, TW)
                ry = oy + iyc[None, :] - p0y                 # (K, TH)
                a = i00 * rx                                 # i01 == 0
                b = i11 * ry                                 # i10 == 0
                cov_a = torch.clamp((0.5 - torch.abs(a - 0.5)) / wa + 0.5, 0.0, 1.0)
                cov_b = torch.clamp((0.5 - torch.abs(b - 0.5)) / wb + 0.5, 0.0, 1.0)
                tu = fma(torch.clamp(a, 0, 1), u1 - u0, u0) * iw
                tv = fma(torch.clamp(b, 0, 1), v1 - v0, v0) * ih
                s = _sample_separable(tex, tu, tv, flags)
                qcov = cov_b[:, :, None] * cov_a[:, None, :]
            else:
                rx = ox[..., None] + ixc[None, None, :] - p0x[..., None]   # (K,1,TW)
                ry = oy[..., None] + iyc[None, :, None] - p0y[..., None]   # (K,TH,1)
                a = i00[..., None] * rx + i01[..., None] * ry              # (K,TH,TW)
                b = i10[..., None] * rx + i11[..., None] * ry
                cov_a = torch.clamp((0.5 - torch.abs(a - 0.5)) / wa[..., None] + 0.5, 0.0, 1.0)
                cov_b = torch.clamp((0.5 - torch.abs(b - 0.5)) / wb[..., None] + 0.5, 0.0, 1.0)
                tu = fma(torch.clamp(a, 0, 1), (u1 - u0)[..., None], u0[..., None]) * iw
                tv = fma(torch.clamp(b, 0, 1), (v1 - v0)[..., None], v0[..., None]) * ih
                s = _sample_gather(tex, tu, tv, flags)
                qcov = cov_a * cov_b
            if a8:
                alpha = s[..., 0]
                rgb = col[:, None, None, 0:3].expand(*alpha.shape, 3)
                av = alpha * col[:, None, None, 3]
            else:
                rgba = s * col[:, None, None, :]
                rgb = rgba[..., 0:3]
                av = rgba[..., 3]
            aq = av * qcov
            contrib = torch.cat([rgb * aq[..., None], aq[..., None]], dim=-1)
            tiles.index_add_(0, ct, contrib)
        else:  # P_IMAGE pattern fill
            m0, m1, m2 = p[:, 2], p[:, 3], p[:, 4]
            m3, m4, m5 = p[:, 5], p[:, 6], p[:, 7]
            if separable:
                tu = fma(m0[:, None], ox + ixc[None, :], m4[:, None]) * iw  # (K,TW)
                tv = fma(m3[:, None], oy + iyc[None, :], m5[:, None]) * ih  # (K,TH)
                s = _sample_separable(tex, tu, tv, flags)
            else:
                pxc = ox[..., None] + ixc[None, None, :]
                pyc = oy[..., None] + iyc[None, :, None]
                tu = (fma(m0[:, None, None], pxc, m2[:, None, None] * pyc)
                      + m4[:, None, None]) * iw
                tv = (fma(m1[:, None, None], pxc, m3[:, None, None] * pyc)
                      + m5[:, None, None]) * ih
                k = tu.shape[0]
                s = _sample_gather(tex, tu.expand(k, th, tw), tv.expand(k, th, tw), flags)
            if a8:
                s = torch.cat([torch.ones((*s.shape[:-1], 3), dtype=torch.float32,
                                          device=dev), s], dim=-1)
            rgba = s * col[:, None, None, :]
            tiles[ct] = torch.cat([rgba[..., 0:3] * rgba[..., 3:4], rgba[..., 3:4]], dim=-1)

    # textured-quad tiles saturate like the host sampler (sum then clip)
    if clipmask is not None:
        cm = clipmask[:, None, None, None]
        tiles = torch.where(cm, torch.clamp(tiles, 0.0, 1.0), tiles)
    return tiles[:num_tiles]


def sample_tiles_flat(g: DeviceGroups, *, shift=(0.0, 0.0), plain: bool = False,
                      profiler=None) -> torch.Tensor:
    """Every group's colour tiles in K2's layout, (NCT+1, 4*th*tw) at the
    groups' tile size g.tile = (th, tw), channel-major plus the zeros row,
    on the groups' device: one S1 launch
    for CUDA groups (counted as sample_kernel_launches on `profiler`), else,
    and with plain=True on any device, the twin sample_groups and
    flat_color_tiles.  Either route adds the (entry, quad) pairs of the
    non-separable groups it samples, the (pair, pixel) slots inside S1's
    footprints at no shift and the colour tiles of pattern fills it writes,
    all counted on the host when the tile index was built, to `profiler`'s
    sample_rotated_pairs, sample_footprint_px and sample_pattern_tiles.
    shift: as sample_groups'."""
    if profiler is not None:
        profiler.count("sample_rotated_pairs", g.n_rotated_pairs)
        profiler.count("sample_footprint_px", g.footprint_px)
        profiler.count("sample_pattern_tiles", g.pattern_tiles)
    if g.words.is_cuda and not plain:
        from vgtpu_torch.ops.sampling_cuda import sample_tiles_cuda

        out = sample_tiles_cuda(g, shift)
        if profiler is not None:
            profiler.count("sample_kernel_launches", 1)
        return out
    th, tw = g.tile
    return flat_color_tiles(sample_groups(
        g.arrs, g.texs, g.clipmask, meta=g.meta, th=th, tw=tw,
        num_tiles=g.num_tiles, shift=shift))


def sample_color_tiles_device(sp: SamplingPlan, textures: dict,
                              tile_h: int, tile_w: int,
                              profiler=None) -> torch.Tensor | None:
    """Run all sample groups on the textures' device -> (NCT, TH, TW, 4)
    premultiplied color tiles.  `textures` maps image id -> f32 tensor (h,
    w, C in [0,1]; C=1 for A8).  The result is color_tiles_view's view of
    sample_tiles_flat's tiles in K2's layout (S1's on CUDA), which
    flat_color_tiles gives back without a copy."""
    if sp.num_tiles == 0:
        return None
    texs = tuple(textures[g.image_id] for g in sp.groups)
    return color_tiles_view(sample_tiles_flat(
        upload_groups(sp, texs, texs[0].device, (tile_h, tile_w)),
        profiler=profiler), tile_h, tile_w)
