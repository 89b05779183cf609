"""The port's TrueType reader (vgtpu_torch/fonts/sfnt.py) against fontTools,
as vgtpu reads the same font through vgtpu/fonts/truetype.Font: over every
glyph of the DejaVu Sans the port ships, the pen events, flattened
coordinates, contours, advances, the chosen cmap and the kern pairs are
equal; the demo UI's glyphs rasterize to the same bitmaps; the demo UI's
text records with fontTools and matplotlib blocked; and the glyph atlas of
the 1080p demo-UI frame hashes to the constant chip_smoke.py checks on the
card."""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("fontTools")
from fontTools.pens.recordingPen import RecordingPen  # noqa: E402

import chip_smoke  # noqa: E402
from tests.fontdata import FONT_PATH  # noqa: E402
from vgtpu.fonts.truetype import Font as FontJ  # noqa: E402
from vgtpu_torch.fonts import UI_FONT  # noqa: E402
from vgtpu_torch.fonts import sfnt as F  # noqa: E402
from vgtpu_torch.fonts.sfnt import decode_cmap  # noqa: E402
from vgtpu_torch.fonts.truetype import Font as FontT  # noqa: E402

DATA = UI_FONT.read_bytes()
REPO = Path(__file__).resolve().parents[1]
N_PARTS = 4          # the glyph range split into parts, one case each


@pytest.fixture(scope="module")
def fonts():
    return FontJ("j", DATA), FontT("t", DATA)


def _part(fj, k):
    order = fj.ttf.getGlyphOrder()
    step = -(-len(order) // N_PARTS)
    return list(enumerate(order))[k * step:(k + 1) * step]


def test_packaged_font_facts(fonts):
    """The packaged file is DejaVu Sans as matplotlib ships it: long loca,
    2,048 units per em, 6,241 glyphs (2,599 composite; 5 whose lsb is not
    their xMin), the (3, 10) format-12 cmap chosen."""
    fj, ft = fonts
    sf = ft.sfnt
    assert (sf.num_glyphs, sf.units_per_em, sf.index_to_loc_format) == (6241, 2048, 1)
    assert len(fj.ttf.getGlyphOrder()) == sf.num_glyphs
    glyphs = [sf.glyph(g) for g in range(sf.num_glyphs)]
    assert sum(g.n_contours < 0 for g in glyphs) == 2599
    # lsb != xMin: 3 composites (their addComponent events take no shift)
    # and 2 simple glyphs the top-level lsb - xMin shift moves
    off = [g.n_contours > 0 for i, g in enumerate(glyphs)
           if g.bounds is not None and sf.lsbs[i] != g.bounds[0]]
    assert (len(off), sum(off)) == (5, 2)
    assert sorted(sf.cmap_subtables()) == [(0, 3), (0, 10), (1, 0), (3, 1), (3, 10)]
    assert sf.cmap_subtables()[(3, 10)][0] == 12
    assert (ft.ascent_u, ft.descent_u, ft.line_gap_u) == (
        fj.ascent_u, fj.descent_u, fj.line_gap_u)
    assert ft.units_per_em == fj.units_per_em
    assert (UI_FONT.parent / "LICENSE_DEJAVU").read_bytes().startswith(
        b"Fonts are (c) Bitstream")


def test_packaged_font_is_matplotlibs():
    if FONT_PATH is None:
        pytest.skip("no matplotlib DejaVuSans.ttf to compare with")
    assert hashlib.sha256(DATA).hexdigest() == hashlib.sha256(
        FONT_PATH.read_bytes()).hexdigest()


@pytest.mark.parametrize("part", range(N_PARTS))
def test_draw_events_equal_recording_pen(fonts, part):
    """Event for event what RecordingPen records from the glyph set's draw:
    the top-level lsb - xMin shift, rotated contours, all-off-curve
    contours, closePath, composites as addComponent (names -> ids)."""
    fj, ft = fonts
    gs = fj.ttf.getGlyphSet()
    gid = fj.ttf.getReverseGlyphMap()
    for g, name in _part(fj, part):
        pen = RecordingPen()
        gs[name].draw(pen)
        want = [(op, (gid[a[0]], a[1]) if op == "addComponent" else a)
                for op, a in pen.value]
        assert ft.sfnt.draw(g) == want, name


@pytest.mark.parametrize("part", range(N_PARTS))
def test_coordinates_equal_get_coordinates(fonts, part):
    """Composites flattened as fontTools' Glyph.getCoordinates does:
    points, contour ends and on-curve flags."""
    fj, ft = fonts
    glyf = fj.ttf["glyf"]
    for g, name in _part(fj, part):
        c, ends, flags = glyf[name].getCoordinates(glyf)
        pts, e, on = ft.sfnt.coordinates(g)
        np.testing.assert_array_equal(pts, np.array(list(c), np.float64).reshape(-1, 2),
                                      err_msg=name)
        assert e == list(ends), name
        assert on.tolist() == [bool(f & 1) for f in flags], name


@pytest.mark.parametrize("part", range(N_PARTS))
def test_contours_bit_identical(fonts, part):
    """outline_contours at two pixel scales (the demo UI's 16 px and a
    64 px one), bit for bit, for every glyph."""
    fj, ft = fonts
    for g, name in _part(fj, part):
        for size in (16.0, 64.0):
            a = fj.outline_contours(name, fj.pixel_scale(size))
            b = ft.outline_contours(g, ft.pixel_scale(size))
            assert len(a) == len(b), name
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.shape == y.shape, name
                assert x.tobytes() == y.tobytes(), name


def test_advances(fonts):
    fj, ft = fonts
    for g, name in enumerate(fj.ttf.getGlyphOrder()):
        assert ft.advance_u(g) == fj.advance_u(name), name
        assert ft.sfnt.lsbs[g] == fj.ttf["hmtx"][name][1], name


def test_cmap(fonts):
    """The chosen subtable maps every codepoint fontTools' getBestCmap maps,
    to the same glyph; the format-4 subtables decode as fontTools's."""
    fj, ft = fonts
    gid = fj.ttf.getReverseGlyphMap()
    assert ft.cmap == {cp: gid[n] for cp, n in fj.cmap.items()}
    assert all(ft.glyph_id(cp) == gid[n] for cp, n in fj.cmap.items())
    subs = ft.sfnt.cmap_subtables()
    for key in ((3, 1), (0, 3)):
        fmt, raw = subs[key]
        assert fmt == 4
        want = {cp: gid[n] for cp, n in fj.ttf["cmap"].getcmap(*key).cmap.items()}
        assert decode_cmap(fmt, raw) == want
    with pytest.raises(ValueError, match="format 6"):
        decode_cmap(*subs[(1, 0)])


def test_kern_pairs(fonts):
    fj, ft = fonts
    gid = fj.ttf.getReverseGlyphMap()
    (sub,) = fj.ttf["kern"].kernTables
    want = {(gid[a], gid[b]): v for (a, b), v in sub.kernTable.items()}
    assert len(want) == 2727
    assert ft.sfnt.kern_pairs() == want
    for (a, b), v in list(want.items())[::97]:
        names = fj.ttf.getGlyphOrder()
        assert ft.kern_u(a, b) == fj.kern_u(names[a], names[b]) == float(v)


# the demo UI's strings and sizes (scenes/demo_ui.py) at dpr 1 and 0.5
UI_TEXT = ("Widgets & Layout", "Login", "Delete", "Cancel", "Apply",
           "The quick brown fox jumps over the lazy dog while the renderer "
           "wraps, kerns and caches every glyph.")
UI_SIZES = (16.0, 15.0, 13.0, 8.0, 7.5, 6.5)


def test_demo_ui_glyphs_rasterize_alike(fonts):
    fj, ft = fonts
    for ch in sorted(set("".join(UI_TEXT))):
        name, g = fj.glyph_name(ord(ch)), ft.glyph_id(ord(ch))
        assert ft.gid_of(g) == fj.gid_of(name)
        for size in UI_SIZES:
            a, b = fj.rasterize(name, size, pad=1), ft.rasterize(g, size, pad=1)
            assert a[1:] == b[1:], (ch, size)
            assert (a[0] is None) == (b[0] is None), (ch, size)
            if a[0] is not None:
                assert a[0].dtype == b[0].dtype and a[0].tobytes() == b[0].tobytes()


def test_notdef_fallback_is_glyph_0(fonts):
    """A codepoint the font does not map falls back to U+FFFD's glyph, and
    without one to .notdef, glyph 0: the glyph ids vgtpu's names key on."""
    from vgtpu.fonts.system import FontSystem as FontSystemJ
    from vgtpu_torch.fonts.system import FontSystem as FontSystemT

    fsj, fst = FontSystemJ(), FontSystemT()
    for fs in (fsj, fst):
        fs.add_font("a", DATA)
        fs.add_font("b", DATA)
    fsj.fonts[1].cmap = {}
    fst.fonts[1].cmap = {}
    fst.fonts[1].sfnt.cmap = fst.fonts[1].cmap
    for fi, cp in ((0, 0x10FFFD), (0, ord("A")), (1, ord("A")), (1, 0x10FFFD)):
        _i, fj, gj = fsj._lookup_glyph(fi, cp)
        _i, ft, gt = fst._lookup_glyph(fi, cp)
        assert ft.gid_of(gt) == fj.gid_of(gj), (fi, cp)
    assert fst._lookup_glyph(1, ord("A"))[2] == 0


def _atlas_sha256(bitmap) -> str:
    return hashlib.sha256(np.ascontiguousarray(bitmap).tobytes()).hexdigest()


def test_atlas_pin_is_vgtpus():
    """The constant chip_smoke.py [12] holds the card's atlas to is the
    atlas vgtpu bakes (through fontTools) for the 1080p demo-UI frame."""
    import vgtpu as vgj
    from vgtpu.scenes import demo_ui

    ctx = vgj.createContext()
    vgj.begin(ctx, 0, 1920, 1080, 1.0)
    demo_ui.draw_benchmark_frame(ctx, 0.0)
    atlas = ctx.font_system.atlas
    assert len(atlas.glyphs) > 0
    assert _atlas_sha256(atlas.bitmap) == chip_smoke.ATLAS_SHA256


BLOCKED = """
import sys

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("fontTools", "matplotlib", "jax", "vgtpu"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, _Blocked())
import hashlib, json
import numpy as np
import vgtpu_torch as vg
from vgtpu_torch.fonts.fontstash import ATLAS_IMAGE_ID
from vgtpu_torch.scenes import demo_ui

ctx = vg.createContext(device="cpu")
vg.begin(ctx, 0, 1920, 1080, 1.0)
demo_ui.draw_benchmark_frame(ctx, 0.0)
ctx._finalize_ops()
atlas = ctx.font_system.atlas
print(json.dumps({
    "glyphs": len(atlas.glyphs),
    "sha256": hashlib.sha256(np.ascontiguousarray(atlas.bitmap).tobytes()).hexdigest(),
    "text_ops": sum(1 for op in ctx.ops if op.image_id == ATLAS_IMAGE_ID),
    "leaked": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("fontTools", "matplotlib", "jax", "vgtpu")),
}))
"""


def test_demo_ui_text_records_without_font_libraries():
    out = subprocess.run([sys.executable, "-c", BLOCKED], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["leaked"] == []
    assert rec["glyphs"] > 0 and rec["text_ops"] > 0
    assert rec["sha256"] == chip_smoke.ATLAS_SHA256


def _component(flags, gid, args, fmt, extra=b""):
    import struct

    return struct.pack(">HH", flags, gid) + struct.pack(fmt, *args) + extra


# composite glyphs built from every component form: (flags, args, arg
# format, transform bytes) per component; DejaVu's own composites use only
# the offset form (UNSCALED_COMPONENT_OFFSET, word or byte args)
COMPOSITES = {
    "words_round_more": [
        (F.ARG_1_AND_2_ARE_WORDS | F.ARGS_ARE_XY_VALUES | F.ROUND_XY_TO_GRID, (-300, 1200), ">hh", b""),
        (F.ARGS_ARE_XY_VALUES, (-7, 12), ">bb", b""),
    ],
    "scale": [(F.ARGS_ARE_XY_VALUES | F.WE_HAVE_A_SCALE, (10, -20), ">bb",
               (0x2000).to_bytes(2, "big"))],
    "xy_scale_apple": [(F.ARG_1_AND_2_ARE_WORDS | F.ARGS_ARE_XY_VALUES
                        | F.WE_HAVE_AN_X_AND_Y_SCALE | F.SCALED_COMPONENT_OFFSET,
                        (100, 50), ">hh", bytes.fromhex("6000c000"))],
    "two_by_two_ms": [(F.ARG_1_AND_2_ARE_WORDS | F.ARGS_ARE_XY_VALUES
                       | F.WE_HAVE_A_TWO_BY_TWO | F.UNSCALED_COMPONENT_OFFSET,
                       (33, -44), ">hh", bytes.fromhex("3000 1000 f000 4000"))],
    "two_by_two_default": [(F.ARGS_ARE_XY_VALUES | F.WE_HAVE_A_TWO_BY_TWO, (3, 4), ">bb",
                            bytes.fromhex("2d41 2d41 d2bf 2d41"))],
    "instructions_metrics": [(F.ARGS_ARE_XY_VALUES | F.WE_HAVE_INSTRUCTIONS
                              | F.USE_MY_METRICS | F.NON_OVERLAPPING
                              | F.OVERLAP_COMPOUND, (0, 0), ">bb", b"")],
    "point_matched": [
        (F.ARGS_ARE_XY_VALUES, (0, 0), ">bb", b""),
        (F.WE_HAVE_A_SCALE, (2, 1), ">BB", (0x3000).to_bytes(2, "big")),
    ],
    "point_matched_words": [
        (F.ARGS_ARE_XY_VALUES, (5, 5), ">bb", b""),
        (F.ARG_1_AND_2_ARE_WORDS, (0, 3), ">HH", b""),
    ],
}


@pytest.mark.parametrize("case", sorted(COMPOSITES))
def test_composite_component_forms(case):
    """Each component form parsed from bytes and flattened as fontTools
    does, and drawn as its addComponent events (a point-matched component
    has no addComponent offset: both readers raise)."""
    import struct

    from fontTools.ttLib import TTFont
    from fontTools.ttLib.tables._g_l_y_f import Glyph as GlyphJ

    from vgtpu_torch.fonts.sfnt import Glyph, SfntFont

    tt = TTFont(__import__("io").BytesIO(DATA), lazy=True)
    glyf = tt["glyf"]
    order = tt.getGlyphOrder()
    sf = SfntFont(DATA)
    gids = [sf.cmap[ord("A")], sf.cmap[ord("o")]]     # simple glyphs
    comps = COMPOSITES[case]
    data = struct.pack(">hhhhh", -1, 0, 0, 0, 0)
    for k, (flags, args, fmt, extra) in enumerate(comps):
        more = F.MORE_COMPONENTS if k < len(comps) - 1 else 0
        data += _component(flags | more, gids[k], args, fmt, extra)
    if any(c[0] & F.WE_HAVE_INSTRUCTIONS for c in comps):
        data += struct.pack(">h", 3) + b"\xb0\x01\x2f"
    target = sf.num_glyphs - 1
    glyf[order[target]] = GlyphJ(data)
    g = Glyph(n_contours=-1, bounds=(0, 0, 0, 0))
    SfntFont._parse_composite(g, data)
    sf._glyphs[target] = g

    c, ends, fl = glyf[order[target]].getCoordinates(glyf)
    pts, e, on = sf.coordinates(target)
    np.testing.assert_array_equal(pts, np.array(list(c), np.float64).reshape(-1, 2))
    assert e == list(ends) and on.tolist() == [bool(f & 1) for f in fl]
    assert len(pts) > 0
    rev = tt.getReverseGlyphMap()
    if case.startswith("point_matched"):
        with pytest.raises(AttributeError):
            tt.getGlyphSet()[order[target]].draw(RecordingPen())
        with pytest.raises(ValueError, match="point-matched"):
            sf.draw(target)
    else:
        pen = RecordingPen()
        tt.getGlyphSet()[order[target]].draw(pen)
        assert sf.draw(target) == [(op, (rev[a[0]], a[1])) for op, a in pen.value]


def test_unhandled_forms_raise():
    """A reserved component flag, cubic glyf points and a cmap format the
    reader lacks raise instead of guessing."""
    import struct

    from vgtpu_torch.fonts.sfnt import Glyph, SfntFont

    bad = struct.pack(">hhhhh", -1, 0, 0, 0, 0) + _component(
        0x8000 | F.ARGS_ARE_XY_VALUES, 1, (0, 0), ">bb")
    with pytest.raises(ValueError, match="reserved"):
        SfntFont._parse_composite(Glyph(n_contours=-1), bad)
    both = struct.pack(">hhhhh", -1, 0, 0, 0, 0) + _component(
        F.ARGS_ARE_XY_VALUES | F.SCALED_COMPONENT_OFFSET | F.UNSCALED_COMPONENT_OFFSET,
        1, (0, 0), ">bb")
    with pytest.raises(ValueError, match="both"):
        SfntFont._parse_composite(Glyph(n_contours=-1), both)
    # one contour of three points, the second flagged cubic (bit 7)
    cubic = (struct.pack(">hhhhh", 1, 0, 0, 10, 10) + struct.pack(">Hh", 2, 0)
             + bytes([0x37, 0xB6, 0x37]) + bytes([5, 5, 5]) + bytes([5, 5, 5]))
    with pytest.raises(ValueError, match="cubic"):
        SfntFont._parse_simple(Glyph(n_contours=1), cubic)
    with pytest.raises(ValueError, match="format 13"):
        decode_cmap(13, b"")


def test_collection_reads_its_first_font():
    """A TrueType collection (ttcf) reads its first font, as vgtpu's
    TTFont(fontNumber=0) does: the packaged font wrapped in a one-font
    collection reads as the font itself."""
    import struct

    from vgtpu_torch.fonts.sfnt import SfntFont

    n = struct.unpack_from(">H", DATA, 4)[0]
    font = bytearray(DATA)
    for i in range(n):                       # table offsets are file offsets
        at = 12 + 16 * i + 8
        struct.pack_into(">I", font, at, struct.unpack_from(">I", font, at)[0] + 16)
    ttc = b"ttcf" + struct.pack(">HHII", 1, 0, 1, 16) + bytes(font)
    a, b = SfntFont(DATA), SfntFont(ttc)
    assert b.cmap == a.cmap and b.kern_pairs() == a.kern_pairs()
    assert all(b.draw(g) == a.draw(g) for g in range(0, a.num_glyphs, 13))
    with pytest.raises(ValueError, match="not a TrueType"):
        SfntFont(b"OTTO" + DATA[4:])


def _kern_subtable_pairs(pairs):
    import struct

    return struct.pack(">HHHH", len(pairs), 0, 0, 0) + b"".join(
        struct.pack(">HHh", a, b, v) for a, b, v in pairs)


@pytest.mark.parametrize("form", ["apple", "ms_three_subtables"])
def test_kern_table_headers(fonts, form):
    """Apple's version-1 header and several MS subtables (a format the
    reader skips between two format-0 ones, the later pair winning) read as
    fontTools reads them."""
    import struct

    from fontTools.ttLib.tables._k_e_r_n import table__k_e_r_n

    from vgtpu_torch.fonts.sfnt import SfntFont

    fj, _ft = fonts
    first = [(36, 37, -50), (37, 36, 20), (40, 41, 7)]
    second = [(37, 36, -5), (50, 51, 12)]
    if form == "apple":
        body = _kern_subtable_pairs(first)
        kern = struct.pack(">LL", 0x00010000, 1) + struct.pack(
            ">LBBH", 8 + len(body), 0, 0, 0) + body
    else:
        a, b = _kern_subtable_pairs(first), _kern_subtable_pairs(second)
        other = b"\x00" * 10
        kern = (struct.pack(">HH", 0, 3)
                + struct.pack(">HHBB", 0, 6 + len(a), 0, 1) + a
                + struct.pack(">HHBB", 0, 6 + len(other), 3, 1) + other
                + struct.pack(">HHBB", 0, 6 + len(b), 0, 1) + b)
    sf = SfntFont(DATA + kern)
    sf.tables["kern"] = (len(DATA), len(kern))
    t = table__k_e_r_n()
    t.decompile(kern, fj.ttf)
    gid = fj.ttf.getReverseGlyphMap()
    want = {}
    for sub in t.kernTables:
        if sub.format == 0:
            want.update({(gid[x], gid[y]): v for (x, y), v in sub.kernTable.items()})
    assert sf.kern_pairs() == want
    assert want[(37, 36)] == (20 if form == "apple" else -5)
