# Copied from vgtpu/fonts/fontstash.py: the jax-free host half of the PyTorch port.
"""Glyph atlas + caches — the FontStash equivalent (SURVEY.md §2 #8,
src/libs/fontstash.h).

Reimplements the reference's observable machinery:
  - skyline bottom-left rect packer (fons__atlasAddRect, fontstash.h:989);
  - glyph cache keyed by a packed code {glyph, quantized size} — the
    reference packs {codepoint,size,blur} into a u64 with a BKDR-hashed LUT
    (fontstash.h:658-674); a python dict with the same packed key gives the
    same hit behavior;
  - atlas generation counter ('atlasID', fontstash.h:768): growing keeps
    content, resetting bumps the generation and invalidates baked strings;
  - baked-string cache (FONSstring, fontstash.h:162-174 / fonsBakeString
    :2365-2483): quads per (font,size,string) are cached and reused while the
    atlas generation matches.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ATLAS_IMAGE_ID = 1 << 20   # image-id namespace for the font atlas
ATLAS_INITIAL = 512
ATLAS_MAX = 4096
GLYPH_PAD = 1


class SkylineAtlas:
    """Skyline bottom-left packer, semantics of fons__atlasAddRect."""

    def __init__(self, w: int, h: int) -> None:
        self.width = w
        self.height = h
        self.nodes: list[list[int]] = [[0, 0, w]]  # x, y, width

    def _rect_fits(self, i: int, w: int, h: int) -> int | None:
        x = self.nodes[i][0]
        if x + w > self.width:
            return None
        y = 0
        remaining = w
        while remaining > 0:
            if i >= len(self.nodes):
                return None
            y = max(y, self.nodes[i][1])
            if y + h > self.height:
                return None
            remaining -= self.nodes[i][2]
            i += 1
        return y

    def add_rect(self, w: int, h: int) -> tuple[int, int] | None:
        best_h = self.height
        best_w = self.width
        best_i = -1
        best_x = best_y = 0
        for i in range(len(self.nodes)):
            y = self._rect_fits(i, w, h)
            if y is None:
                continue
            node = self.nodes[i]
            if y + h < best_h or (y + h == best_h and node[2] < best_w):
                best_i = i
                best_w = node[2]
                best_h = y + h
                best_x = node[0]
                best_y = y
        if best_i == -1:
            return None
        # insert new skyline node, shrink/remove covered ones, merge equals
        self.nodes.insert(best_i, [best_x, best_y + h, w])
        i = best_i + 1
        while i < len(self.nodes):
            node = self.nodes[i]
            prev = self.nodes[i - 1]
            if node[0] < prev[0] + prev[2]:
                shrink = prev[0] + prev[2] - node[0]
                node[0] += shrink
                node[2] -= shrink
                if node[2] <= 0:
                    self.nodes.pop(i)
                    continue
                break
            break
        i = 1
        while i < len(self.nodes):
            if self.nodes[i][1] == self.nodes[i - 1][1]:
                self.nodes[i - 1][2] += self.nodes[i][2]
                self.nodes.pop(i)
            else:
                i += 1
        return best_x, best_y


@dataclass
class GlyphInfo:
    atlas_x: int
    atlas_y: int
    w: int
    h: int
    xoff: int
    yoff: int
    advance: float
    last_used: int = 0   # frame counter stamp (atlas GC)


def glyph_code(glyph_id: int, size10: int, blur: int = 0) -> int:
    """Packed glyph code, layout of MAKE_GLYPH_CODE (fontstash.h:248)."""
    return (glyph_id & 0xFFFFFFFF) | ((size10 & 0xFFFFF) << 32) | ((blur & 0xFFF) << 52)


class GlyphAtlas:
    """A8 atlas texture + glyph cache with generation tracking."""

    def __init__(self) -> None:
        self.revision = 0    # bumped on ANY pixel change (device-upload key)
        self.frame = 0       # app-frame counter (Context.frame -> end_frame)
        self.reset(ATLAS_INITIAL)
        self.generation = 0

    def end_frame(self) -> None:
        """Per-app-frame housekeeping hook (vg::frame semantics)."""
        self.frame += 1

    def reset(self, size: int) -> None:
        self.size = size
        self.bitmap = np.zeros((size, size), np.uint8)
        self.packer = SkylineAtlas(size, size)
        self.glyphs: dict[tuple[int, int], GlyphInfo] = {}  # (font_idx, code)
        self.dirty = None  # (x0,y0,x1,y1)
        self.revision += 1

    def _mark_dirty(self, x, y, w, h):
        self.revision += 1
        if self.dirty is None:
            self.dirty = [x, y, x + w, y + h]
        else:
            d = self.dirty
            d[0] = min(d[0], x)
            d[1] = min(d[1], y)
            d[2] = max(d[2], x + w)
            d[3] = max(d[3], y + h)

    def get_or_bake(self, font_idx: int, font, glyph_name: str, glyph_id: int,
                    size_px: float) -> GlyphInfo | None:
        size10 = int(size_px * 10.0 + 0.5)
        code = glyph_code(glyph_id, size10)
        key = (font_idx, code)
        gi = self.glyphs.get(key)
        if gi is not None:
            gi.last_used = self.frame
            return gi

        bitmap, x0, y0, w, h, adv = font.rasterize(glyph_name, size_px, pad=GLYPH_PAD)
        if bitmap is None:
            gi = GlyphInfo(0, 0, 0, 0, 0, 0, adv, last_used=self.frame)
            self.glyphs[key] = gi
            return gi

        spot = self.packer.add_rect(w + 1, h + 1)
        compacted = False
        while spot is None:
            if self.size * 2 <= ATLAS_MAX:
                self._grow()
            elif not compacted:
                # full at max size: compact — keep recently-used glyph pixels,
                # evict the stale ones (the reference's frame() keeps the
                # biggest atlas and drops the rest, vg.cpp:1290-1328; keeping
                # the hot set avoids a re-rasterization spike)
                self._compact()
                compacted = True
            else:
                # hot set alone fills the atlas: full reset (fonsResetAtlas)
                self.generation += 1
                self.reset(self.size)
            spot = self.packer.add_rect(w + 1, h + 1)
            if spot is None and w + 1 > self.size:
                return None
        ax, ay = spot
        self.bitmap[ay : ay + h, ax : ax + w] = bitmap
        self._mark_dirty(ax, ay, w, h)
        gi = GlyphInfo(ax, ay, w, h, x0, y0, adv, last_used=self.frame)
        self.glyphs[key] = gi
        return gi

    def _compact(self) -> None:
        """Repack only glyphs used this frame or the last into a fresh
        skyline (tallest-first), copying their pixels — stale glyphs are
        evicted.  Bumps the generation (baked strings rebake: their UVs
        moved), like the reference's atlas reallocation."""
        self.generation += 1
        keep = {k: gi for k, gi in self.glyphs.items()
                if gi.last_used >= self.frame - 1}
        old_bitmap = self.bitmap
        self.reset(self.size)
        for k, gi in sorted(keep.items(),
                            key=lambda kv: -kv[1].h):
            if gi.w == 0:
                self.glyphs[k] = gi     # metrics-only glyph: no rect
                continue
            spot = self.packer.add_rect(gi.w + 1, gi.h + 1)
            if spot is None:
                continue                # hot set overflow: drop (rebakes)
            ax, ay = spot
            self.bitmap[ay : ay + gi.h, ax : ax + gi.w] = old_bitmap[
                gi.atlas_y : gi.atlas_y + gi.h, gi.atlas_x : gi.atlas_x + gi.w]
            gi.atlas_x, gi.atlas_y = ax, ay
            self.glyphs[k] = gi

    def _grow(self) -> None:
        """Double the atlas, keeping content (allocTextAtlas grows the same
        way, vg.cpp:5500-5539).  Bumps the generation: BakedString quads store
        UVs normalized by the atlas size at bake time, so every string baked
        against the smaller atlas must rebake (the reference invalidates via a
        new atlasID on reallocation, fontstash.h:768)."""
        self.generation += 1
        old = self.bitmap
        old_nodes = self.packer.nodes
        new_size = self.size * 2
        self.bitmap = np.zeros((new_size, new_size), np.uint8)
        self.bitmap[: self.size, : self.size] = old
        packer = SkylineAtlas(new_size, new_size)
        # keep the old skyline across the left half, flat zero on the right
        packer.nodes = [list(n) for n in old_nodes] + [[self.size, 0, new_size - self.size]]
        self.packer = packer
        self.size = new_size
        self.revision += 1
