"""Kernel S1's host half and its design, on the CPU.

S1 (csrc/sample_tiles.cu) runs only on a CUDA card.  What surrounds it is
held here: the tile-major index the host builds (ops/sampling_device.
build_tile_index: pairs by tile in index_add_'s order, pad rows left out,
the group table), the one-copy upload both routes read (upload_groups), the
routing (sample_tiles_flat: CPU groups and plain=True take the twin and
count no S1 launch), and the design's claim that a per-pixel two-tap lookup
computes what the twin's dense hat-weight contraction computes.  two_tap_flat
below is that lookup written in torch, pixel by pixel as S1 walks a tile;
the card tests (test_torch_sampling_cuda.py) hold S1 itself to the twin.
"""

from __future__ import annotations

import itertools
import os
import re

import numpy as np
import pytest
import torch

from vgtpu_torch.core import ImageFlags
from vgtpu_torch.ops.coverage import fma
from vgtpu_torch.ops.sampling_device import (
    GROUP_WORDS,
    MAX_SPAN,
    ROW_WORDS,
    SampleGroup,
    SamplingPlan,
    build_tile_index,
    footprint_boxes,
    sample_groups,
    sample_tiles_flat,
    upload_groups,
)
from vgtpu_torch.raster.binning import P_IMAGE, P_TEXTURE
from vgtpu_torch.ops.composite import flat_color_tiles
from vgtpu_torch.utils.profiler import FrameProfiler

TH, TW = 8, 128
# the dense twin against the two-tap lookup on the CPU: the same weights,
# summed in another order (the twin's matrix products): a few float32 ulps
TWO_TAP_BOUND = 2e-6

# ---------------------------------------------------------------------------
# the design, written in torch: S1's walk over a tile, pixel by pixel
# ---------------------------------------------------------------------------


def _taps(t, size: int, clamp: bool, nearest: bool):
    """csrc/sample_tiles.cu axis_taps over a vector of texel coordinates."""
    x = t - 0.5
    fs = float(size)
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    if nearest:
        xr = torch.round(x)
        if clamp:
            xr = torch.clamp(xr, 0.0, fs - 1.0)
        i0 = torch.remainder(xr.long(), size)
        return i0, i0, one, zero
    if clamp:
        xc = torch.clamp(x, 0.0, fs - 1.0)
        i0 = torch.floor(xc).long()
        i1 = torch.clamp_max(i0 + 1, size - 1)
        w0 = torch.clamp_min(1.0 - torch.abs(xc - i0.float()), 0.0)
        w1 = torch.clamp_min(1.0 - torch.abs(xc - i1.float()), 0.0)
        return i0, i1, w0, torch.where(i1 == i0, zero, w1)
    x0 = torch.floor(x).long()
    i0, i1 = torch.remainder(x0, size), torch.remainder(x0 + 1, size)

    def hat(i):
        d = torch.remainder(x - i.float(), fs)
        return torch.clamp_min(1.0 - d, 0.0) + torch.clamp_min(1.0 - (fs - d), 0.0)

    return i0, i1, hat(i0), torch.where(i1 == i0, zero, hat(i1))


def _separable(tex, tu, tv, flags: int):
    nearest = (not (flags & ImageFlags.Filter_LinearUV)) and bool(
        flags & ImageFlags.Filter_NearestUV)
    y0, y1, wy0, wy1 = _taps(tv, tex.shape[0], bool(flags & ImageFlags.Clamp_V), nearest)
    x0, x1, wx0, wx1 = _taps(tu, tex.shape[1], bool(flags & ImageFlags.Clamp_U), nearest)
    wy0, wy1, wx0, wx1 = (w[:, None] for w in (wy0, wy1, wx0, wx1))
    t0 = fma(wy1, tex[y1, x0], wy0 * tex[y0, x0])
    t1 = fma(wy1, tex[y1, x1], wy0 * tex[y0, x1])
    return fma(wx1, t1, wx0 * t0)


def _gather(tex, u, v, flags: int):
    """The twin's _sample_gather, which S1 repeats for rotated groups."""
    from vgtpu_torch.ops.sampling_device import _sample_gather

    return _sample_gather(tex, u, v, flags)


def _pair_rgba(grp, p, ox, oy, tex):
    """csrc/sample_tiles.cu pair_rgba: (npx, 4) premultiplied RGBA."""
    flags, kind, sep = int(grp[5]), int(grp[6]), bool(grp[7])
    ih, iw, c = tex.shape
    col = p[12:16]
    sample = _separable if sep else _gather
    if kind == P_TEXTURE:
        exx, exy, eyx, eyy = p[4], p[5], p[6], p[7]
        det = exx * eyy - exy * eyx
        i00, i01, i10, i11 = eyy / det, -eyx / det, -exy / det, exx / det
        wa = torch.clamp_min(torch.sqrt(i00.double() ** 2 + i01.double() ** 2).float(), 1e-9)
        wb = torch.clamp_min(torch.sqrt(i10.double() ** 2 + i11.double() ** 2).float(), 1e-9)
        rx, ry = ox - p[2], oy - p[3]
        a = i00 * rx if sep else i00 * rx + i01 * ry
        b = i11 * ry if sep else i10 * rx + i11 * ry
        cov_a = torch.clamp((0.5 - torch.abs(a - 0.5)) / wa + 0.5, 0.0, 1.0)
        cov_b = torch.clamp((0.5 - torch.abs(b - 0.5)) / wb + 0.5, 0.0, 1.0)
        tu = fma(torch.clamp(a, 0, 1), p[10] - p[8], p[8]) * iw
        tv = fma(torch.clamp(b, 0, 1), p[11] - p[9], p[9]) * ih
        s = sample(tex, tu, tv, flags)
        qcov = cov_b * cov_a
        if c == 1:
            aq = s[:, 0] * col[3] * qcov
            rgb = col[None, 0:3] * aq[:, None]
        else:
            aq = s[:, 3] * col[3] * qcov
            rgb = s[:, 0:3] * col[None, 0:3] * aq[:, None]
        # S1 skips the lookup where qcov is 0 and adds zeros
        return torch.where((qcov == 0)[:, None], 0.0, torch.cat([rgb, aq[:, None]], dim=1))
    m0, m1, m2, m3, m4, m5 = p[2:8]
    if sep:
        s = sample(tex, fma(m0, ox, m4) * iw, fma(m3, oy, m5) * ih, flags)
    else:
        s = sample(tex, (fma(m0, ox, m2 * oy) + m4) * iw,
                   (fma(m1, ox, m3 * oy) + m5) * ih, flags)
    if c == 1:
        s = torch.cat([torch.ones((s.shape[0], 3)), s], dim=1)
    alpha = s[:, 3] * col[3]
    return torch.cat([s[:, 0:3] * col[None, 0:3] * alpha[:, None], alpha[:, None]], dim=1)


def pair_footprints(g, th: int, tw: int, shift=(0.0, 0.0)) -> np.ndarray:
    """footprint_boxes over the uploaded pairs, in pair order: (P, 4)."""
    w, at = g.words, g.at
    table = w[: at["rows"]].view(-1, GROUP_WORDS).numpy()
    rows = w[at["rows"] : at["offsets"]].view(torch.float32).view(-1, ROW_WORDS).numpy()
    pairs = w[at["pairs"] : at["pairs"] + 2 * g.n_pairs].view(-1, 2).numpy()
    grp = table[pairs[:, 1]]
    return footprint_boxes(rows[pairs[:, 0]], grp[:, 6] == P_TEXTURE, grp[:, 7] != 0,
                           th, tw, shift)


def two_tap_flat(g, th: int, tw: int, shift=(0.0, 0.0), cull: bool = False) -> torch.Tensor:
    """S1's output computed as S1 computes it, from the uploaded words alone
    (the table, the rows, the tile offsets, the clip flags, the pairs; the
    tile order only orders S1's blocks):
    (NCT+1, 4*th*tw) channel-major, the last row zeros.  cull: each pixel
    takes only the pairs whose footprint (footprint_boxes) holds it, as S1
    does; without, every pair of its tile."""
    w, at, nct = g.words, g.at, g.num_tiles
    table = w[: at["rows"]].view(-1, GROUP_WORDS)
    rows = w[at["rows"] : at["offsets"]].view(torch.float32).view(-1, ROW_WORDS)
    offsets = w[at["offsets"] : at["offsets"] + nct + 1].tolist()
    clip = w[at["clip"] : at["clip"] + nct + 1].tolist()
    pairs = w[at["pairs"] : at["pairs"] + 2 * g.n_pairs].view(-1, 2).tolist()
    boxes = pair_footprints(g, th, tw, shift).tolist()
    sx, sy = (torch.tensor(v, dtype=torch.float32) for v in shift)
    c = torch.arange(tw).repeat(th)
    r = torch.arange(th).repeat_interleave(tw)
    cx, cy = c.float() + 0.5, r.float() + 0.5
    out = torch.zeros((nct + 1, 4, th * tw), dtype=torch.float32)
    for t in range(nct):
        acc = torch.zeros((th * tw, 4), dtype=torch.float32)
        for i in range(offsets[t], offsets[t + 1]):
            row, grp = pairs[i]
            p = rows[row]
            v = _pair_rgba(table[grp], p, (p[0] + sx) + cx, (p[1] + sy) + cy, g.texs[grp])
            x0, x1, y0, y1 = boxes[i] if cull else (0, tw, 0, th)
            inside = ((c >= x0) & (c < x1) & (r >= y0) & (r < y1))[:, None]
            v = acc + v if int(table[grp, 6]) == P_TEXTURE else v
            acc = torch.where(inside, v, acc)
        if clip[t]:
            acc = torch.clamp(acc, 0.0, 1.0)
        out[t] = acc.T
    return out.reshape(nct + 1, -1)


def twin_flat(g, th: int, tw: int, shift=(0.0, 0.0)) -> torch.Tensor:
    return flat_color_tiles(sample_groups(g.arrs, g.texs, g.clipmask, meta=g.meta,
                                          th=th, tw=tw, num_tiles=g.num_tiles,
                                          shift=shift))


# ---------------------------------------------------------------------------
# synthetic sampling plans
# ---------------------------------------------------------------------------


def _group(kind, sep, flags, ct, params, color, image_id=0):
    ct = np.asarray(ct, np.int32)
    return SampleGroup(image_id, flags, kind, sep, ct,
                       np.asarray(params, np.float32).reshape(len(ct), 12),
                       np.asarray(color, np.float32).reshape(len(ct), 4))


def _plan(groups, nct, tex_mask):
    sp = SamplingPlan(groups=list(groups), num_tiles=nct)
    sp.tex_tile_mask = np.asarray(tex_mask, bool)
    return sp


def _quad_params(rng, ox, oy, sep, reach):
    """A textured quad that reaches past its tile, uv beyond [0, 1] so
    repeat wraps at negative and at-size texel coordinates."""
    exx, eyy = rng.uniform(20, 90), rng.uniform(4, 12)
    exy, eyx = (0.0, 0.0) if sep else (rng.uniform(-15, 15), rng.uniform(-3, 3))
    p0x = ox + rng.uniform(-20, reach)
    p0y = oy + rng.uniform(-4, 6)
    u0, v0 = rng.uniform(-0.6, 0.3), rng.uniform(-0.6, 0.3)
    u1, v1 = u0 + rng.uniform(0.5, 1.6), v0 + rng.uniform(0.5, 1.6)
    return [ox, oy, p0x, p0y, exx, exy, eyx, eyy, u0, v0, u1, v1]


def _pattern_params(rng, ox, oy, sep):
    """An affine pattern over a tile whose texel coordinates run from below
    0 to past the texture's size."""
    m0, m3 = rng.uniform(-0.02, 0.03), rng.uniform(-0.05, 0.09)
    m1, m2 = (0.0, 0.0) if sep else (rng.uniform(-0.03, 0.03), rng.uniform(-0.04, 0.04))
    return [ox, oy, m0, m1, m2, m3, rng.uniform(-1.5, 0.5), rng.uniform(-1.5, 0.5),
            0, 0, 0, 0]


FLAG_SETS = [f | c for f, c in itertools.product(
    (ImageFlags.Filter_Bilinear, ImageFlags.Filter_Nearest, 0),
    (0, ImageFlags.Clamp_U, ImageFlags.Clamp_V, ImageFlags.Clamp_UV))]


def random_plan(seed: int, kind: int, sep: bool, flags: int, channels: int,
                texture=(13, 7)):
    """Pairs over 6 tiles (tile 4 left empty, tile 0 shared by both
    groups' quads) and pad rows, in two groups of one form, with textures."""
    rng = np.random.default_rng(seed)
    iw, ih = texture
    texs = tuple(torch.as_tensor(rng.uniform(0, 1, (ih, iw, channels)), dtype=torch.float32)
                 for _ in range(2))
    nct = 6
    origins = [(float(rng.integers(-3, 40)) * 128 + rng.uniform(-0.4, 0.4),
                float(rng.integers(-3, 40)) * 8) for _ in range(nct)]
    groups = []
    for gi in range(2):
        if kind == P_TEXTURE:
            cts = [0, 1, 1, 0, 3, 1, 5] if gi == 0 else [2, 0, 0, 3]
        else:   # a pattern tile holds one entry
            cts = [0, 1, 5] if gi == 0 else [2, 3]
        params = [(_quad_params(rng, *origins[t], sep, 130) if kind == P_TEXTURE
                   else _pattern_params(rng, *origins[t], sep)) for t in cts]
        colors = rng.uniform(0.2, 1.0, (len(cts), 4))
        pad = 8 - len(cts)
        filler = params[0][:2] + ([0, 0, 1, 0, 0, 1, 0, 0, 0, 0] if kind == P_TEXTURE
                                  else [1, 0, 0, 1, 0, 0, 0, 0, 0, 0])
        groups.append(_group(kind, sep, flags, cts + [nct] * pad, params + [filler] * pad,
                             np.concatenate([colors, np.zeros((pad, 4))]), image_id=gi))
    mask = [kind == P_TEXTURE] * nct
    return _plan(groups, nct, mask), texs


# ---------------------------------------------------------------------------
# the index
# ---------------------------------------------------------------------------


def _index_plan():
    nct = 5
    g0 = _group(P_TEXTURE, True, ImageFlags.Filter_Bilinear, [3, 0, 3, 5, 1, 0, 5, 5],
                np.zeros((8, 12)), np.zeros((8, 4)))
    g1 = _group(P_TEXTURE, False, ImageFlags.Filter_Nearest | ImageFlags.Clamp_UV,
                [0, 3, 5, 5, 5, 5, 5, 5], np.zeros((8, 12)), np.zeros((8, 4)), image_id=7)
    g2 = _group(P_IMAGE, False, ImageFlags.Clamp_U, [4, 5, 5, 5, 5, 5, 5, 5],
                np.zeros((8, 12)), np.zeros((8, 4)), image_id=2)
    return _plan([g0, g1, g2], nct, [True, True, False, True, False])


def test_tile_index_orders_pairs_by_tile_then_row():
    """Pairs by tile; inside a tile, group 0's rows in row order, then
    group 1's: the order index_add_ adds them in on the CPU."""
    sp = _index_plan()
    idx = build_tile_index(sp, [(8, 9, 1), (4, 4, 4), (16, 2, 4)], (TH, TW))
    # rows: g0 0-7, g1 8-15, g2 16-23
    by_tile = {t: idx.pairs[idx.offsets[t] : idx.offsets[t + 1]].tolist()
               for t in range(sp.num_tiles)}
    assert by_tile == {0: [[1, 0], [5, 0], [8, 1]], 1: [[4, 0]], 2: [],
                       3: [[0, 0], [2, 0], [9, 1]], 4: [[16, 2]]}
    assert idx.offsets.tolist() == [0, 3, 4, 4, 7, 8]
    assert idx.offsets.dtype == np.int32 and idx.pairs.dtype == np.int32
    # S1's block order: by falling pair count, ties (and the zeros row) in order
    assert idx.order.tolist() == [0, 3, 1, 4, 2, 5] and idx.order.dtype == np.int32


def test_tile_index_leaves_pad_rows_out():
    sp = _index_plan()
    idx = build_tile_index(sp, [(8, 9, 1), (4, 4, 4), (16, 2, 4)], (TH, TW))
    ct = np.concatenate([g.ct for g in sp.groups])
    assert len(idx.pairs) == int((ct < sp.num_tiles).sum()) == 8
    assert (ct[idx.pairs[:, 0]] < sp.num_tiles).all()
    assert idx.offsets[-1] == len(idx.pairs)


def test_tile_index_two_groups_share_a_tile():
    sp = _index_plan()
    idx = build_tile_index(sp, [(8, 9, 1), (4, 4, 4), (16, 2, 4)], (TH, TW))
    for t in (0, 3):
        grp = idx.pairs[idx.offsets[t] : idx.offsets[t + 1], 1]
        assert sorted(set(grp.tolist())) == [0, 1]
        assert (np.diff(grp) >= 0).all()


def test_tile_index_empty_tiles_and_clip_flags():
    """Tile 2 has no pair (its rows were all pads): an empty range, so S1
    writes zeros there.  The clip flags are the textured-quad tiles, and 0
    on the zeros row."""
    sp = _index_plan()
    idx = build_tile_index(sp, [(8, 9, 1), (4, 4, 4), (16, 2, 4)], (TH, TW))
    assert idx.offsets[2] == idx.offsets[3]
    assert idx.clip.tolist() == [1, 1, 0, 1, 0, 0]
    empty = _plan([_group(P_TEXTURE, True, 0, [3] * 8, np.zeros((8, 12)),
                          np.zeros((8, 4)))], 3, [True] * 3)
    ie = build_tile_index(empty, [(2, 2, 1)], (TH, TW))
    assert ie.offsets.tolist() == [0, 0, 0, 0] and ie.pairs.shape == (0, 2)


def test_upload_of_tiles_without_pairs():
    """Textured tiles whose quads all miss them: no group at all.  The
    upload still lays out the offsets and clip flags, and the twin's
    tiles are zeros (S1 walks the same empty ranges)."""
    sp = _plan([], 3, [True] * 3)
    g = upload_groups(sp, (), torch.device("cpu"), (TH, TW))
    assert g.at["rows"] == 0 and g.n_pairs == 0
    assert g.words[g.at["offsets"] : g.at["clip"]].tolist() == [0, 0, 0, 0]
    for flat in (twin_flat(g, TH, TW), two_tap_flat(g, TH, TW)):
        assert flat.shape == (4, 4 * TH * TW) and not flat.any()


def test_tile_index_group_table():
    sp = _index_plan()
    idx = build_tile_index(sp, [(8, 9, 1), (4, 4, 4), (16, 2, 4)], (TH, TW))
    assert idx.table.tolist() == [
        [8, 9, 1, ImageFlags.Filter_Bilinear, P_TEXTURE, 1],
        [4, 4, 4, ImageFlags.Filter_Nearest | ImageFlags.Clamp_UV, P_TEXTURE, 0],
        [16, 2, 4, ImageFlags.Clamp_U, P_IMAGE, 0]]


def test_upload_is_one_copy_laid_out_for_s1_and_the_twin():
    """One int32 tensor: the table (texture pointers, then h, w, C, flags,
    kind, separable), the rows as float32 bits (the twin's triples are views
    of them), the offsets, the clip flags, the tile order and the pairs."""
    sp = _index_plan()
    texs = (torch.zeros(8, 9, 1), torch.zeros(4, 4, 4), torch.zeros(16, 2, 4))
    g = upload_groups(sp, texs, torch.device("cpu"), (TH, TW))
    w, at = g.words, g.at
    assert w.dtype == torch.int32 and w.dim() == 1
    table = w[: at["rows"]].view(-1, GROUP_WORDS)
    ptrs = table[:, 0:2].contiguous().view(torch.int64).view(-1).tolist()
    assert ptrs == [t.data_ptr() for t in texs]
    idx = build_tile_index(sp, [tuple(t.shape) for t in texs], (TH, TW))
    assert table[:, 2:].tolist() == idx.table.tolist()
    assert w[at["offsets"] : at["clip"]].tolist() == idx.offsets.tolist()
    assert w[at["clip"] : at["order"]].tolist() == idx.clip.tolist()
    assert w[at["order"] : at["pairs"]].tolist() == idx.order.tolist()
    assert w[at["pairs"] :].view(-1, 2).tolist() == idx.pairs.tolist()
    for (p, col, ct), sg in zip(g.arrs, sp.groups):
        assert np.array_equal(p.numpy(), sg.params)
        assert np.array_equal(col.numpy(), sg.color)
        assert ct.dtype == torch.int64 and ct.tolist() == sg.ct.tolist()
        assert p.untyped_storage().data_ptr() == w.untyped_storage().data_ptr()
    assert g.clipmask.tolist() == [True, True, False, True, False, False]
    assert g.meta == tuple((sg.kind, sg.separable, sg.flags) for sg in sp.groups)


def test_s1_constants_match_the_python_values():
    """csrc/sample_tiles.cu names ImageFlags' bits, P_TEXTURE and the word
    counts as constants of its own."""
    src = open(os.path.join(os.path.dirname(__file__), "..", "vgtpu_torch", "csrc",
                            "sample_tiles.cu")).read()

    def const(name):
        m = re.search(rf"constexpr int {name} = ([^;]+);", src)
        return eval(m.group(1))    # "1 << 10" or a plain int

    assert const("kNearestUV") == ImageFlags.Filter_NearestUV
    assert const("kLinearUV") == ImageFlags.Filter_LinearUV
    assert const("kClampU") == ImageFlags.Clamp_U
    assert const("kClampV") == ImageFlags.Clamp_V
    assert const("kTextureQuad") == P_TEXTURE
    assert const("kRowWords") == ROW_WORDS and const("kGroupWords") == GROUP_WORDS
    span = re.search(r"constexpr float kMaxSpan = ([0-9.e+]+)f;", src)
    assert float(span.group(1)) == MAX_SPAN


# ---------------------------------------------------------------------------
# the design: two taps per axis compute the dense twin's function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", FLAG_SETS)
@pytest.mark.parametrize("kind, sep", [(P_TEXTURE, True), (P_TEXTURE, False),
                                       (P_IMAGE, True), (P_IMAGE, False)])
@pytest.mark.parametrize("channels", [1, 4])
def test_two_tap_equals_the_dense_twin(flags, kind, sep, channels):
    seed = hash((flags, kind, sep, channels)) % 2**31
    sp, texs = random_plan(seed, kind, sep, flags, channels)
    g = upload_groups(sp, texs, torch.device("cpu"), (TH, TW))
    for shift in ((0.0, 0.0), (7.37, 0.5), (127.9, 3.0)):
        want = twin_flat(g, TH, TW, shift)
        got = two_tap_flat(g, TH, TW, shift)
        assert got.shape == want.shape == (sp.num_tiles + 1, 4 * TH * TW)
        assert float((got - want).abs().max()) <= TWO_TAP_BOUND, shift
        assert not got[-1].any()
        assert not got[4].any()           # tile 4 has no pair


@pytest.mark.parametrize("flags", [ImageFlags.Filter_Bilinear,
                                   ImageFlags.Filter_Bilinear | ImageFlags.Clamp_UV])
@pytest.mark.parametrize("kind", [P_TEXTURE, P_IMAGE])
def test_two_tap_equals_the_dense_twin_on_an_atlas_sized_texture(flags, kind):
    """512x512, the glyph atlas's size: a repeat tap left of its texel
    coordinate wraps through remainder(x - i, 512), which rounds to the
    ulp at 512 (3e-5); the two taps take the twin's formula, not 1 - fx,
    and so its rounding (1 - fx reads up to 1.3e-4 off here)."""
    sp, texs = random_plan(7, kind, True, flags, 1, texture=(512, 512))
    g = upload_groups(sp, texs, torch.device("cpu"), (TH, TW))
    for shift in ((0.0, 0.0), (7.37, 0.5)):
        err = float((two_tap_flat(g, TH, TW, shift) - twin_flat(g, TH, TW, shift)).abs().max())
        assert err <= TWO_TAP_BOUND, shift


@pytest.mark.parametrize("flags", [ImageFlags.Filter_Nearest,
                                   ImageFlags.Filter_Nearest | ImageFlags.Clamp_UV])
def test_two_tap_nearest_ties_round_half_to_even(flags):
    """Texel coordinates on exact .5 ties (x = tu - 0.5 = k + 0.5 on every
    odd column): both pick texel round-half-even(x), not x rounded up."""
    iw = 8
    tex = torch.arange(iw, dtype=torch.float32).repeat(4, 1)[..., None] / iw
    # tu = (m0 * (0.5 + c + 0.5) + 0) * iw = (c + 1) / 2
    params = [0.5, 0.0, 1.0 / 16, 0, 0, 0.25, 0, 0, 0, 0, 0, 0]
    sp = _plan([_group(P_IMAGE, True, flags, [0] + [1] * 7,
                       [params] + [[0.0] * 12] * 7, [[1, 1, 1, 1]] + [[0] * 4] * 7)],
               1, [False])
    g = upload_groups(sp, (tex,), torch.device("cpu"), (TH, TW))
    got = two_tap_flat(g, TH, TW)
    want = twin_flat(g, TH, TW)
    assert float((got - want).abs().max()) <= TWO_TAP_BOUND
    alpha = got[0].view(4, TH, TW)[3, 0]
    x = (torch.arange(TW, dtype=torch.float32) + 1) / 2 - 0.5
    texel = torch.round(x)                 # half to even
    if flags & ImageFlags.Clamp_U:
        texel = texel.clamp(0, iw - 1)
    else:
        texel = torch.remainder(texel, iw)
    assert torch.equal(alpha, texel / iw)
    assert (x[1::2] == torch.floor(x[1::2]) + 0.5).all()


def test_two_tap_one_texel_wide_textures():
    """A texture one texel wide (repeat: both taps are the same texel,
    counted once) and one texel high."""
    rng = np.random.default_rng(5)
    for shape in ((1, 9), (9, 1), (1, 1)):
        tex = torch.as_tensor(rng.uniform(0, 1, shape + (4,)), dtype=torch.float32)
        for flags in FLAG_SETS:
            params = _pattern_params(rng, 40.0, 8.0, True)
            sp = _plan([_group(P_IMAGE, True, flags, [0] + [1] * 7,
                               [params] + [[0.0] * 12] * 7, [[0.5, 1, 1, 1]] + [[0] * 4] * 7)],
                       1, [False])
            g = upload_groups(sp, (tex,), torch.device("cpu"), (TH, TW))
            err = float((two_tap_flat(g, TH, TW) - twin_flat(g, TH, TW)).abs().max())
            assert err <= TWO_TAP_BOUND, (shape, flags)


def test_two_tap_mixed_groups_share_tiles():
    """A separable A8 group and a rotated RGBA group summing into shared
    tiles, beside a pattern group, in one upload."""
    a, ta = random_plan(11, P_TEXTURE, True, ImageFlags.Filter_Bilinear, 1)
    b, tb = random_plan(12, P_TEXTURE, False, ImageFlags.Clamp_UV, 4)
    c, tc = random_plan(13, P_IMAGE, False, ImageFlags.Filter_Nearest, 4)
    shift_ct = 6
    groups = a.groups + b.groups + [
        _group(g.kind, g.separable, g.flags, np.where(g.ct < 6, g.ct + shift_ct, 12),
               g.params, g.color, g.image_id) for g in c.groups]
    for g in groups[:4]:
        g.ct = np.where(g.ct < 6, g.ct, 12).astype(np.int32)
    sp = _plan(groups, 12, [True] * 6 + [False] * 6)
    g = upload_groups(sp, ta + tb + tc, torch.device("cpu"), (TH, TW))
    got, want = two_tap_flat(g, TH, TW, (3.25, 1.0)), twin_flat(g, TH, TW, (3.25, 1.0))
    assert float((got - want).abs().max()) <= TWO_TAP_BOUND
    assert float(got[:6].max()) <= 1.0   # textured-quad tiles clamped


# ---------------------------------------------------------------------------
# the footprints: a pixel skips the pairs whose coverage is zero there
# ---------------------------------------------------------------------------

# x residuals near 0 and a fraction, a half sub-row (ss = 2), whole rows
CULL_SHIFTS = ((0.0, 0.0), (7.37, 0.0), (0.0, 0.5), (127.9, 3.0))
TILE_ORIGINS = ((256.3, 64.0), (-128.0, 8.0), (1408.7, 200.0))


def _quads_plan(quads, sep):
    """One group of bilinear, repeating A8 quads (ex, ey, p0 relative to the
    tile origin) over the TILE_ORIGINS tiles, each quad in every tile."""
    rng = np.random.default_rng(0)
    tex = torch.as_tensor(rng.uniform(0.2, 1, (9, 11, 1)), dtype=torch.float32)
    cts, params = [], []
    for t, (ox, oy) in enumerate(TILE_ORIGINS):
        for (exx, exy), (eyx, eyy), (px, py) in quads:
            cts.append(t)
            params.append([ox, oy, ox + px, oy + py, exx, exy, eyx, eyy,
                           -0.2, 0.1, 1.3, 0.9])
    n = len(cts)
    kp = max(8, n)
    filler = [0, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0]
    colors = np.concatenate([rng.uniform(0.3, 1.0, (n, 4)), np.zeros((kp - n, 4))])
    g = _group(P_TEXTURE, sep, ImageFlags.Filter_Bilinear, cts + [3] * (kp - n),
               params + [filler] * (kp - n), colors)
    return _plan([g], 3, [True] * 3), (tex,)


# (ex, ey, p0 relative to the tile origin) of quads no random plan makes
ADVERSARIAL = {
    # moderately sheared (box from the band's corners) and nearly flat
    # (sheared past MAX_SPAN's reach: the whole tile)
    "sheared": (False, [((12.0, 1.0), (10.0, 2.0), (30.0, 1.0)),
                        ((60.0, 0.5), (59.9, 0.51), (20.0, 3.0))]),
    # a fraction of a pixel: wa and wb from ~3 to 1e4, the band ~1 px
    "sub_pixel": (False, [((0.3, 0.0), (0.0, 0.4), (17.2, 3.6)),
                          ((0.2, 0.1), (-0.1, 0.3), (64.5, 4.0)),
                          ((1e-3, 0.0), (0.0, 1e-4), (90.0, 2.5))]),
    "sub_pixel_separable": (True, [((0.3, 0.0), (0.0, 0.4), (17.2, 3.6)),
                                   ((1e-3, 0.0), (0.0, 1e-4), (90.0, 2.5))]),
    # wa and wb at their 1e-9 clamp: a quad of 1e10 px, one edge in the tile
    "wa_clamped": (True, [((3e10, 0.0), (0.0, 2e10), (50.0, -1e9))]),
    "wa_clamped_rotated": (False, [((3e10, 1.0), (0.0, 2e10), (50.0, 3.0))]),
    # det exactly 0 (parallel edges, a zero edge): a non-finite inverse
    "degenerate_det": (False, [((10.0, 5.0), (20.0, 10.0), (30.0, 2.0)),
                               ((12.0, 0.0), (0.0, 0.0), (40.0, 2.0))]),
    # quads across each edge of the tile and past its corners
    "tile_edge": (False, [((9.0, 1.0), (-1.0, 8.0), (-5.0, -4.0)),
                          ((9.0, -1.0), (1.0, 9.0), (124.0, 5.0)),
                          ((7.0, 0.0), (0.0, 9.0), (60.0, 7.6))]),
    "tile_edge_separable": (True, [((9.0, 0.0), (0.0, 8.0), (-5.0, -4.0)),
                                   ((9.0, 0.0), (0.0, 9.0), (124.0, 5.0)),
                                   ((7.0, 0.0), (0.0, 9.0), (60.0, -8.4))]),
}

CULL_CASES = ([("random", flags, sep) for flags in FLAG_SETS for sep in (True, False)]
              + [(name, None, None) for name in ADVERSARIAL])


@pytest.mark.parametrize("case, flags, sep", CULL_CASES)
def test_footprint_culling_changes_no_bit(case, flags, sep):
    """S1 samples a pair only at the pixels of its footprint: outside it
    the pair's coverage is exactly 0, so the culled walk equals the full
    walk bit for bit, on random_plan's quads (every flag set, separable and
    rotated, reaching into the pan's margin) and on quads built to break
    the footprint: sheared, sub-pixel, wa at its clamp, a degenerate det
    (the whole tile), across the tile's edges; at the pan's residuals."""
    if case == "random":
        # A8 and RGBA on alternate flag sets, the glyph atlas's 512x512 on
        # every third case, a seed of each case's own
        i = 2 * FLAG_SETS.index(flags) + int(sep)
        sp, texs = random_plan(1000 + i, P_TEXTURE, sep, flags, (1, 4)[(i // 2) % 2],
                               texture=(512, 512) if i % 3 == 0 else (13, 7))
    else:
        sep, quads = ADVERSARIAL[case]
        sp, texs = _quads_plan(quads, sep)
    g = upload_groups(sp, texs, torch.device("cpu"), (TH, TW))
    whole = np.array([0, TW, 0, TH])
    ink = False
    for shift in CULL_SHIFTS:
        full = two_tap_flat(g, TH, TW, shift)
        culled = two_tap_flat(g, TH, TW, shift, cull=True)
        # bit for bit: the degenerate quads' NaNs (torch.clamp keeps them) too
        assert torch.equal(culled.view(torch.int32), full.view(torch.int32)), shift
        ink = ink or bool(full[:-1].nan_to_num().any())
        boxes = pair_footprints(g, TH, TW, shift)
        area = (np.clip(boxes[:, 1] - boxes[:, 0], 0, None)
                * np.clip(boxes[:, 3] - boxes[:, 2], 0, None))
        if case in ("degenerate_det", "wa_clamped", "wa_clamped_rotated"):
            assert (boxes == whole).all(), boxes
        elif case == "sheared":
            assert (boxes[1::2] == whole).all() and (area[0::2] < TH * TW).all()
        else:
            assert (area < TH * TW).any(), boxes
    assert ink or case == "degenerate_det"     # NaN there, on either walk


def test_footprints_bound_the_sub_pixel_quads():
    """A quad of a fraction of a pixel reaches the pixels within 1 px of its
    band (its own extent grown by half a pixel): at most 4 x 4 of them."""
    sep, quads = ADVERSARIAL["sub_pixel"]
    sp, texs = _quads_plan(quads, sep)
    boxes = pair_footprints(upload_groups(sp, texs, torch.device("cpu"), (TH, TW)), TH, TW)
    assert ((boxes[:, 1] - boxes[:, 0] <= 4) & (boxes[:, 3] - boxes[:, 2] <= 4)).all()
    assert ((boxes[:, 1] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 2])).all()


@pytest.mark.parametrize("kind", [P_TEXTURE, P_IMAGE])
def test_tile_index_counts_the_footprint_slots(kind):
    """build_tile_index's footprint_px is the (pair, pixel) slots inside the
    footprints at no shift: below every pair's whole tile for quads, all of
    it for pattern fills.  sample_tiles_flat adds it to sample_footprint_px
    per resample."""
    sp, texs = random_plan(9, kind, kind == P_TEXTURE, ImageFlags.Filter_Bilinear, 1)
    g = upload_groups(sp, texs, torch.device("cpu"), (TH, TW))
    boxes = pair_footprints(g, TH, TW)
    area = int((np.clip(boxes[:, 1] - boxes[:, 0], 0, None)
                * np.clip(boxes[:, 3] - boxes[:, 2], 0, None)).sum())
    assert g.footprint_px == area
    if kind == P_TEXTURE:
        assert 0 < area < g.n_pairs * TH * TW
    else:
        assert area == g.n_pairs * TH * TW
    prof = FrameProfiler()
    for shift in ((0.0, 0.0), (7.37, 1.0)):
        sample_tiles_flat(g, shift=shift, profiler=prof)
    assert prof.counters["sample_footprint_px"] == 2 * area


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plain", [False, True])
def test_cpu_groups_take_the_twin_and_count_no_launch(plain):
    sp, texs = random_plan(3, P_TEXTURE, True, ImageFlags.Filter_Bilinear, 1)
    g = upload_groups(sp, texs, torch.device("cpu"), (TH, TW))
    prof = FrameProfiler()
    got = sample_tiles_flat(g, shift=(7.37, 1.0), plain=plain, profiler=prof)
    assert torch.equal(got, twin_flat(g, TH, TW, (7.37, 1.0)))
    assert prof.counters.get("sample_kernel_launches", 0) == 0


def test_s1_wrapper_refuses_cpu_groups():
    from vgtpu_torch.ops.sampling_cuda import S1, sample_tiles_cuda

    sp, texs = random_plan(4, P_IMAGE, True, 0, 4)
    g = upload_groups(sp, texs, torch.device("cpu"), (TH, TW))
    with pytest.raises(ValueError, match="not a CUDA device"):
        sample_tiles_cuda(g)
    assert S1.launches == 0 and S1._lib is None


def test_pan_and_frame_paths_count_no_launch_on_the_cpu():
    """A textured retained scene and a textured frame on the CPU: the pan's
    resample and the frame's sampler take the twin; sample_kernel_launches
    stays 0 while ct_memo_hits still counts."""
    import vgtpu_torch as vg
    from vgtpu_torch.raster.retained import RetainedScene
    from vgtpu_torch.scenes.small import draw_pattern_panels, make_pattern_images

    ctx = vg.createContext(vg.ContextConfig(frame_memo=False), device="cpu")
    images = make_pattern_images(ctx)
    for _ in range(2):
        vg.begin(ctx, 0, 512, 256, 1.0)
        draw_pattern_panels(ctx, images, x0=10.0, y0=10.0)
        vg.end(ctx)
    scene = RetainedScene.bake(ctx, 640, 384)
    scene.render(3.5, 2)
    scene.render(9.25, 1, use_pallas=False)
    c = ctx.profiler.counters
    assert scene.samp_meta is not None
    assert c.get("ct_memo_hits", 0) == 1
    assert c.get("sample_kernel_launches", 0) == 0
