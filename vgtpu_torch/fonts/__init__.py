"""Text: the TrueType reader (sfnt), glyph rasterization (truetype), the
glyph atlas (fontstash) and string layout (system).  `UI_FONT` is the font
the port ships: DejaVu Sans (Bitstream Vera licence, data/LICENSE_DEJAVU)."""

from pathlib import Path

UI_FONT = Path(__file__).parent / "data" / "DejaVuSans.ttf"
