# Frozen copy of vgtpu_torch/fonts/sfnt.py for the benchmark's plain reference: the
# port's host semantics as of the benchmark's first version, importing
# nothing of the program, so a later change to the port cannot move the
# yardstick.
"""A TrueType (sfnt) reader over a font's bytes: struct and numpy, no font
library.

It reads what the text engine needs (the role stb_truetype's parser plays
in the reference, SURVEY.md §2 #9): the table directory, `head`, `hhea`,
`maxp`, `hmtx`, `loca`, `glyf` (simple and composite glyphs), the best
Unicode `cmap` subtable and format-0 `kern` pairs.  Glyphs are keyed by
glyph id.

Its outlines are the pen events fontTools' `RecordingPen` records from
`TTFont.getGlyphSet()[name].draw` (fontTools 4.x, `_g_l_y_f.Glyph.draw`):
the top-level `lsb - xMin` shift, contours rotated to end on an on-curve
point, an all-off-curve contour as one `qCurveTo` ending in None, a
`closePath` after every contour, and a composite glyph as its
`addComponent` events (keyed by the component's glyph id).  What it does
not handle (cubic `glyf` points, reserved component flags, cmap formats
other than 4 and 12) raises ValueError instead of guessing.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# simple-glyph point flags (OpenType glyf spec)
ON_CURVE = 0x01
X_SHORT = 0x02
Y_SHORT = 0x04
REPEAT = 0x08
X_SAME = 0x10          # X_SHORT: positive; else: x repeats (delta 0)
Y_SAME = 0x20
CUBIC = 0x80           # fontTools' cubic-glyf extension: not TrueType

# composite-glyph component flags
ARG_1_AND_2_ARE_WORDS = 0x0001
ARGS_ARE_XY_VALUES = 0x0002
ROUND_XY_TO_GRID = 0x0004      # a hinting hint: outlines ignore it
WE_HAVE_A_SCALE = 0x0008
NON_OVERLAPPING = 0x0010
MORE_COMPONENTS = 0x0020
WE_HAVE_AN_X_AND_Y_SCALE = 0x0040
WE_HAVE_A_TWO_BY_TWO = 0x0080
WE_HAVE_INSTRUCTIONS = 0x0100
USE_MY_METRICS = 0x0200
OVERLAP_COMPOUND = 0x0400
SCALED_COMPONENT_OFFSET = 0x0800     # Apple: move, then transform
UNSCALED_COMPONENT_OFFSET = 0x1000   # MS (and the default): transform, then move
_KNOWN_COMPONENT_FLAGS = 0x1FFF

# the Unicode cmap subtables in order of preference (HarfBuzz's, which
# fontTools' getBestCmap follows)
CMAP_PREFERENCES = ((3, 10), (0, 6), (0, 4), (3, 1), (0, 3), (0, 2), (0, 1), (0, 0))

_MAX_COMPONENT_DEPTH = 64


@dataclass
class Component:
    gid: int
    flags: int
    dx: int = 0                 # ARGS_ARE_XY_VALUES
    dy: int = 0
    points: tuple | None = None  # (parent point, component point) otherwise
    transform: tuple | None = None  # ((xx, xy), (yx, yy)), 2.14 fixed as float


@dataclass
class Glyph:
    n_contours: int = 0
    bounds: tuple | None = None        # (xMin, yMin, xMax, yMax); None if empty
    coords: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.int64))
    on_curve: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    end_pts: list = field(default_factory=list)
    components: list = field(default_factory=list)


def _f2dot14(v: int) -> float:
    return v / (1 << 14)


def _transform(p: np.ndarray, t: tuple) -> np.ndarray:
    """Row vectors times the 2x2 matrix t, rounded as fontTools'
    GlyphCoordinates.transform (two products, one sum; no FMA)."""
    x, y = p[:, 0], p[:, 1]
    return np.stack([x * t[0][0] + y * t[1][0], x * t[0][1] + y * t[1][1]], axis=1)


class SfntFont:
    """The tables of one TrueType font, parsed from its bytes."""

    def __init__(self, data: bytes) -> None:
        self.data = data = bytes(data)
        base = 0
        if data[:4] == b"ttcf":
            # a collection: its first font, as vgtpu's TTFont(fontNumber=0)
            base = struct.unpack_from(">I", data, 12)[0]
        version = data[base:base + 4]
        if version not in (b"\x00\x01\x00\x00", b"true"):
            raise ValueError(f"not a TrueType outline font (sfnt version {version!r})")
        n_tables = struct.unpack_from(">H", data, base + 4)[0]
        self.tables: dict[str, tuple[int, int]] = {}
        for i in range(n_tables):
            tag, _cs, off, length = struct.unpack_from(">4sIII", data, base + 12 + 16 * i)
            self.tables[tag.decode("latin-1")] = (off, length)

        head = self.table("head")
        self.units_per_em = struct.unpack_from(">H", head, 18)[0]
        self.index_to_loc_format = struct.unpack_from(">h", head, 50)[0]
        hhea = self.table("hhea")
        self.ascent, self.descent, self.line_gap = struct.unpack_from(">hhh", hhea, 4)
        n_hmetrics = struct.unpack_from(">H", hhea, 34)[0]
        self.num_glyphs = struct.unpack_from(">H", self.table("maxp"), 4)[0]

        # hmtx: (advance, lsb) pairs, then lsbs that reuse the last advance
        n_hmetrics = min(n_hmetrics, self.num_glyphs)
        hmtx = self.table("hmtx")
        n_lsb = self.num_glyphs - n_hmetrics
        if len(hmtx) < 4 * n_hmetrics + 2 * n_lsb:
            raise ValueError("hmtx is shorter than its hhea/maxp counts")
        pairs = np.frombuffer(hmtx, ">u2", 2 * n_hmetrics).reshape(-1, 2)
        self.advances = np.empty(self.num_glyphs, np.int64)
        self.lsbs = np.empty(self.num_glyphs, np.int64)
        self.advances[:n_hmetrics] = pairs[:, 0]
        self.advances[n_hmetrics:] = pairs[-1, 0] if n_hmetrics else 0
        self.lsbs[:n_hmetrics] = pairs[:, 1].astype(np.int16)
        self.lsbs[n_hmetrics:] = np.frombuffer(hmtx, ">i2", n_lsb, 4 * n_hmetrics)

        loca = self.table("loca")
        if self.index_to_loc_format:
            self.loca = np.frombuffer(loca, ">u4", len(loca) // 4).astype(np.int64)
        else:
            self.loca = 2 * np.frombuffer(loca, ">u2", len(loca) // 2).astype(np.int64)
        self.glyf_offset = self.tables["glyf"][0]
        self._glyphs: dict[int, Glyph] = {}
        self.cmap = self._best_cmap()
        self._kern: dict | None = None

    def table(self, tag: str) -> bytes:
        off, length = self.tables[tag]
        return self.data[off:off + length]

    # -- glyf ---------------------------------------------------------------
    def glyph(self, gid: int) -> Glyph:
        g = self._glyphs.get(gid)
        if g is None:
            g = self._glyphs[gid] = self._parse_glyph(gid)
        return g

    def _parse_glyph(self, gid: int) -> Glyph:
        if not 0 <= gid < self.num_glyphs or gid + 1 >= len(self.loca):
            raise ValueError(f"glyph {gid} is not in the font ({self.num_glyphs} glyphs)")
        start, end = int(self.loca[gid]), int(self.loca[gid + 1])
        if end <= start:
            return Glyph()
        d = self.data[self.glyf_offset + start:self.glyf_offset + end]
        n, x0, y0, x1, y1 = struct.unpack_from(">hhhhh", d, 0)
        g = Glyph(n_contours=n, bounds=(x0, y0, x1, y1))
        if n > 0:
            self._parse_simple(g, d)
        elif n < 0:
            self._parse_composite(g, d)
        return g

    @staticmethod
    def _parse_simple(g: Glyph, d: bytes) -> None:
        n = g.n_contours
        g.end_pts = list(struct.unpack_from(f">{n}H", d, 10))
        pos = 10 + 2 * n
        n_instr = struct.unpack_from(">h", d, pos)[0]
        pos += 2 + n_instr
        npts = g.end_pts[-1] + 1
        flags = bytearray()
        while len(flags) < npts:
            f = d[pos]
            pos += 1
            rep = 1
            if f & REPEAT:
                rep += d[pos]
                pos += 1
            flags.extend(bytes((f,)) * rep)
        if len(flags) != npts:
            raise ValueError("glyf flag repeats run past the glyph's points")
        fl = np.frombuffer(bytes(flags), np.uint8).astype(np.int64)
        if (fl & CUBIC).any():
            raise ValueError("cubic glyf points are not TrueType outlines")
        raw = np.frombuffer(d, np.uint8).astype(np.int64)
        coords = np.empty((npts, 2), np.int64)
        for axis, short, same in ((0, X_SHORT, X_SAME), (1, Y_SHORT, Y_SAME)):
            size = np.where(fl & short, 1, np.where(fl & same, 0, 2))
            at = pos + np.cumsum(size) - size
            pos += int(size.sum())
            if pos > len(raw):
                raise ValueError("glyf coordinates run past the glyph's data")
            b0 = raw[np.minimum(at, len(raw) - 1)]
            b1 = raw[np.minimum(at + 1, len(raw) - 1)]
            word = (b0 << 8) | b1
            word = np.where(word >= 0x8000, word - 0x10000, word)
            delta = np.where(size == 1, np.where(fl & same, b0, -b0),
                             np.where(size == 2, word, 0))
            coords[:, axis] = np.cumsum(delta)
        g.coords = coords
        g.on_curve = (fl & ON_CURVE).astype(bool)

    @staticmethod
    def _parse_composite(g: Glyph, d: bytes) -> None:
        pos = 10
        more = True
        while more:
            flags, gid = struct.unpack_from(">HH", d, pos)
            pos += 4
            if flags & ~_KNOWN_COMPONENT_FLAGS:
                raise ValueError(f"reserved composite flag bits {flags:#06x}")
            if (flags & SCALED_COMPONENT_OFFSET) and (flags & UNSCALED_COMPONENT_OFFSET):
                raise ValueError("a component with both SCALED_ and UNSCALED_COMPONENT_OFFSET")
            c = Component(gid=gid, flags=flags)
            fmt = (">hh" if flags & ARGS_ARE_XY_VALUES else ">HH") \
                if flags & ARG_1_AND_2_ARE_WORDS else \
                (">bb" if flags & ARGS_ARE_XY_VALUES else ">BB")
            a1, a2 = struct.unpack_from(fmt, d, pos)
            pos += struct.calcsize(fmt)
            if flags & ARGS_ARE_XY_VALUES:
                c.dx, c.dy = a1, a2
            else:
                c.points = (a1, a2)
            if flags & WE_HAVE_A_SCALE:
                s = _f2dot14(struct.unpack_from(">h", d, pos)[0])
                c.transform = ((s, 0), (0, s))
                pos += 2
            elif flags & WE_HAVE_AN_X_AND_Y_SCALE:
                sx, sy = struct.unpack_from(">hh", d, pos)
                c.transform = ((_f2dot14(sx), 0), (0, _f2dot14(sy)))
                pos += 4
            elif flags & WE_HAVE_A_TWO_BY_TWO:
                xx, xy, yx, yy = struct.unpack_from(">hhhh", d, pos)
                c.transform = ((_f2dot14(xx), _f2dot14(xy)), (_f2dot14(yx), _f2dot14(yy)))
                pos += 8
            g.components.append(c)
            more = bool(flags & MORE_COMPONENTS)

    def coordinates(self, gid: int, _depth: int = 0):
        """(points (N, 2) float64, contour end indices, on-curve (N,) bool)
        in font units, composites flattened (fontTools'
        `Glyph.getCoordinates`)."""
        g = self.glyph(gid)
        if g.n_contours >= 0:
            return g.coords.astype(np.float64), list(g.end_pts), g.on_curve.copy()
        if _depth >= _MAX_COMPONENT_DEPTH:
            raise ValueError(f"glyph {gid}: components nested deeper than "
                             f"{_MAX_COMPONENT_DEPTH} (a cycle?)")
        pts, ends, on = np.zeros((0, 2)), [], np.zeros(0, bool)
        for c in g.components:
            p, e, o = self.coordinates(c.gid, _depth + 1)
            t = c.transform
            if c.points is not None:
                if t is not None:
                    p = _transform(p, t)
                p = p + (pts[c.points[0]] - p[c.points[1]])
            elif t is None:
                p = p + (c.dx, c.dy)
            elif c.flags & SCALED_COMPONENT_OFFSET:
                p = _transform(p + (c.dx, c.dy), t)
            else:
                p = _transform(p, t) + (c.dx, c.dy)
            ends.extend(x + len(pts) for x in e)
            pts = np.concatenate([pts, p])
            on = np.concatenate([on, o])
        return pts, ends, on

    def draw(self, gid: int) -> list:
        """The glyph's pen events, as fontTools' RecordingPen records them
        from the glyph set's `draw`: [(op, args), ...]."""
        g = self.glyph(gid)
        if g.n_contours < 0:
            events = []
            for c in g.components:
                if c.points is not None:
                    # fontTools' getComponentInfo has no offset to give here
                    raise ValueError(f"glyph {gid}: a point-matched component has "
                                     "no addComponent offset")
                (xx, xy), (yx, yy) = c.transform or ((1, 0), (0, 1))
                events.append(("addComponent", (c.gid, (xx, xy, yx, yy, c.dx, c.dy))))
            return events
        pts, ends, on = self.coordinates(gid)
        if g.bounds is not None:
            # the glyph set's top-level shift: hmtx lsb over the glyf xMin
            pts[:, 0] += int(self.lsbs[gid]) - g.bounds[0]
        pts = [tuple(p) for p in pts.tolist()]
        on = on.tolist()
        events = []
        start = 0
        for end in ends:
            end += 1
            contour, c_on = pts[start:end], on[start:end]
            start = end
            if True not in c_on:
                events.append(("qCurveTo", (*contour, None)))
            else:
                # rotate so the contour ends on an on-curve point: the moveTo
                k = c_on.index(True) + 1
                contour, c_on = contour[k:] + contour[:k], c_on[k:] + c_on[:k]
                events.append(("moveTo", (contour[-1],)))
                while contour:
                    k = c_on.index(True) + 1
                    if k > 1:
                        events.append(("qCurveTo", tuple(contour[:k])))
                    elif len(contour) > 1:       # the last lineTo is closePath's
                        events.append(("lineTo", (contour[0],)))
                    contour, c_on = contour[k:], c_on[k:]
            events.append(("closePath", ()))
        return events

    # -- cmap ---------------------------------------------------------------
    def cmap_subtables(self) -> dict:
        """(platform, encoding) -> (format, subtable bytes), the first
        subtable of each pair in table order."""
        if "cmap" not in self.tables:
            return {}
        cm = self.table("cmap")
        subs = {}
        for i in range(struct.unpack_from(">H", cm, 2)[0]):
            pid, eid, off = struct.unpack_from(">HHl", cm, 4 + 8 * i)
            fmt = struct.unpack_from(">H", cm, off)[0]
            if fmt in (8, 10, 12, 13):
                length = struct.unpack_from(">L", cm, off + 4)[0]
            elif fmt == 14:
                length = struct.unpack_from(">L", cm, off + 2)[0]
            else:
                length = struct.unpack_from(">H", cm, off + 2)[0]
            if length:
                subs.setdefault((pid, eid), (fmt, cm[off:off + length]))
        return subs

    def _best_cmap(self) -> dict:
        """codepoint -> glyph id of the preferred Unicode subtable; {}
        without one."""
        subs = self.cmap_subtables()
        for key in CMAP_PREFERENCES:
            if key in subs:
                return decode_cmap(*subs[key])
        return {}

    # -- kern ---------------------------------------------------------------
    def kern_pairs(self) -> dict:
        """(left gid, right gid) -> adjustment in font units, from every
        format-0 `kern` subtable in order (later pairs win)."""
        if self._kern is not None:
            return self._kern
        self._kern = out = {}
        if "kern" not in self.tables:
            return out
        k = self.table("kern")
        version, n = struct.unpack_from(">HH", k, 0)
        apple = len(k) >= 8 and version == 1
        pos = 4
        if apple:
            n = struct.unpack_from(">L", k, 4)[0]
            pos = 8
        for _ in range(n):
            if apple:
                length, _cov, fmt, _tuple = struct.unpack_from(">LBBH", k, pos)
                head = 8
            else:
                sub_version, length, fmt, _cov = struct.unpack_from(">HHBB", k, pos)
                head = 6
                if n == 1 and fmt == 0:
                    # one subtable: its 16-bit length may have wrapped
                    length = 6 * struct.unpack_from(">H", k, pos + 6)[0] + 14
                if fmt == 0 and sub_version != 0:
                    raise ValueError(f"kern subtable version {sub_version}")
            if fmt == 0:
                n_pairs = struct.unpack_from(">H", k, pos + head)[0]
                pairs = np.frombuffer(k, ">u2", 3 * n_pairs, pos + head + 8).reshape(-1, 3)
                for left, right, value in pairs.tolist():
                    out[(left, right)] = value - 0x10000 if value >= 0x8000 else value
            pos += length
        return out


def decode_cmap(fmt: int, sub: bytes) -> dict:
    """codepoint -> glyph id of one cmap subtable, glyph 0 left out (as
    fontTools' cmap dictionaries)."""
    if fmt == 4:
        return _cmap_format_4(sub)
    if fmt == 12:
        return _cmap_format_12(sub)
    raise ValueError(f"cmap format {fmt}: the reader has formats 4 and 12")


def _cmap_format_4(sub: bytes) -> dict:
    seg2 = struct.unpack_from(">H", sub, 6)[0]
    seg = seg2 // 2
    words = np.frombuffer(sub, ">u2", (len(sub) - 14) // 2, 14).astype(np.int64)
    end_code = words[:seg]
    start_code = words[seg + 1:2 * seg + 1]
    id_delta = words[2 * seg + 1:3 * seg + 1]
    range_off = words[3 * seg + 1:4 * seg + 1]
    gia = words[4 * seg + 1:]
    cps, gids = [], []
    for i in range(seg - 1):        # the last segment (0xFFFF) maps nothing
        codes = np.arange(start_code[i], end_code[i] + 1)
        if range_off[i] == 0:
            g = (codes + id_delta[i]) & 0xFFFF
        else:
            idx = codes + (range_off[i] // 2 - start_code[i] + i - seg)
            if len(idx) and idx.max() >= len(gia):
                raise ValueError("cmap format 4: glyph index past the array")
            raw = gia[idx]
            g = np.where(raw != 0, (raw + id_delta[i]) & 0xFFFF, 0)
        cps.append(codes)
        gids.append(g)
    return _make_map(cps, gids)


def _cmap_format_12(sub: bytes) -> dict:
    n_groups = struct.unpack_from(">L", sub, 12)[0]
    groups = np.frombuffer(sub, ">u4", 3 * n_groups, 16).astype(np.int64).reshape(-1, 3)
    cps = [np.arange(s, e + 1) for s, e, _g in groups]
    gids = [np.arange(g, g + e - s + 1) for s, e, g in groups]
    return _make_map(cps, gids)


def _make_map(cps: list, gids: list) -> dict:
    out = {}
    if cps:
        for cp, g in zip(np.concatenate(cps).tolist(), np.concatenate(gids).tolist()):
            if g:
                out[cp] = g
    return out
