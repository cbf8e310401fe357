"""Text rendering for voxel text blocks and the VUI.

Port of `aic_tpu/text`. No module here imports an imaging library:
`font.py` composes PIL's default font glyph by glyph from a vendored
glyph table (`assets/pil_glyphs.json`: each Latin-1 glyph's grey
coverage, offset and advance, taken from Pillow by
`tools/pil_glyph_table.py`), and `sysfont.py` decodes the vendored
system-16 atlas with zlib.

Two layers, mirroring the reference's `block/text.rs` + `text/{font,
layout,positioning}.rs`:

- `layout.py` — the full-fidelity surface: `Text` values with builtin
  fonts (the reference's own glyph atlases via sysfont loaders),
  `Positioning` (x / line_y / z), voxel-scale layout bounds, outlines,
  and multiblock output. Conformance-tested pixel-for-pixel against the
  reference's text test planes (tests/test_text_layout.py).
- `font.py` — the legacy PIL-font path (font="pil" on TextPrimitive),
  kept as a documented deviation for earlier content; equal to
  `aic_tpu`'s PIL drawing bit for bit.
"""

from .font import measure_text, rasterize_text, text_tile
from .layout import (
    FONT_BODY_TEXT,
    FONT_SYSTEM_16,
    FontDef,
    Positioning,
    Text,
    compute_layout,
)

__all__ = [
    "measure_text",
    "rasterize_text",
    "text_tile",
    "Text",
    "Positioning",
    "FontDef",
    "FONT_SYSTEM_16",
    "FONT_BODY_TEXT",
    "compute_layout",
]
