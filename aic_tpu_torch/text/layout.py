"""Text layout and positioning (reference: all-is-cubes/src/text/
layout.rs:100 compute_layout, positioning.rs, block/text.rs:43 Text).

Port of `aic_tpu/text/layout.py`, copied but for where the glyphs come
from. `aic_tpu` reads both atlases from a reference checkout and, where
that is absent, draws PIL's default font into an atlas of the same
shape. The port reads the system-16 atlas from its vendored copy
(`sysfont.ATLAS_PATH`, the same file); the body-text atlas is not
vendored, so its glyphs are `aic_tpu`'s PIL fall-back, drawn where PIL
can be imported (`pil_atlas_masks`) and an error naming the font where
it cannot.

This is the full-fidelity text surface: monospaced fonts loaded from the
reference's own glyph atlases (text/sysfont.py loaders), a `Positioning`
triple controlling alignment within voxel-scale `layout_bounds`, glyph
layout with line breaks, and a `Text` value that produces one Block or a
multiblock group. The earlier PIL path (font="pil" on TextPrimitive)
remains as a documented deviation for legacy content; everything new
goes through this module.

Coordinate conventions match the reference: glyph pixel space has +x
right / +y DOWN with origin at the cell's top-left (font.rs InGlyph);
layout/voxel space has +y UP, so glyph rows are drawn at -py
(text.rs:410 `vec3(position_in_glyph.x, -position_in_glyph.y, 0)`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..math.grid import GridAab
from .sysfont import ATLAS_PATH, GLYPHS_PER_ROW, atlas_masks, char_to_glyph_index


@functools.lru_cache(maxsize=4)
def pil_atlas_masks(char_w: int, char_h: int) -> np.ndarray:
    """bool[224, char_h, char_w]: PIL's default font drawn glyph by glyph
    (`aic_tpu/text/sysfont.py:72-80`, its fall-back for an absent atlas)."""
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError as e:
        raise RuntimeError(
            f"a {char_w}x{char_h} font has no vendored atlas and PIL cannot be imported"
        ) from e
    font = ImageFont.load_default()
    masks = np.zeros((224, char_h, char_w), bool)
    for gi in range(224):
        o = gi + 0x20 if gi < 0x60 else gi + 0x40
        im = Image.new("L", (char_w, char_h), 0)
        ImageDraw.Draw(im).text((0, 2), chr(o), fill=255, font=font)
        masks[gi] = np.asarray(im) > 0
    return masks


@dataclass(frozen=True)
class FontDef:
    """font.rs:137 FontDef: metrics + glyph atlas."""

    name: str  # builtin handle suffix, e.g. "system-16"
    char_w: int
    char_h: int
    baseline: int  # y of the baseline within the glyph (between pixels)
    atlas_path: Optional[str]  # None: no vendored atlas (PIL's glyphs)

    def masks(self) -> np.ndarray:
        if self.atlas_path is None:
            return pil_atlas_masks(self.char_w, self.char_h)
        return atlas_masks(self.atlas_path, self.char_w, self.char_h)

    def glyph_bbox(self, glyph_index: int, outline: bool):
        """((x0,y0),(x1,y1)) of set pixels, expanded by outline, or None
        (font.rs rendering_bounding_box)."""
        masks = self.masks()
        if glyph_index >= len(masks):
            glyph_index = 0x1F
        m = masks[glyph_index]
        ys, xs = np.nonzero(m)
        if len(ys) == 0:
            return None
        e = 1 if outline else 0
        return (
            (int(xs.min()) - e, int(ys.min()) - e),
            (int(xs.max()) + 1 + e, int(ys.max()) + 1 + e),
        )


#: universe/builtin.rs:202 "all-is-cubes/font/system-16"
#: (font.rs FONT_SYSTEM_16: 7x16, baseline 13).
FONT_SYSTEM_16 = FontDef("system-16", 7, 16, 13, ATLAS_PATH)
#: universe/builtin.rs:209 "all-is-cubes/font/body-text"
#: (font.rs FONT_BODY_TEXT: 6x14, baseline 11).
FONT_BODY_TEXT = FontDef("body-text", 6, 14, 11, None)

FONTS = {"system16": FONT_SYSTEM_16, "body-text": FONT_BODY_TEXT}

# Positioning variants (positioning.rs).
X_LEFT, X_CENTER, X_RIGHT = "left", "center", "right"
Y_BODY_TOP, Y_BODY_MIDDLE, Y_BASELINE, Y_BODY_BOTTOM = (
    "body-top",
    "body-middle",
    "baseline",
    "body-bottom",
)
Z_BACK, Z_FRONT = "back", "front"


@dataclass(frozen=True)
class Positioning:
    """positioning.rs Positioning — where text sits in layout_bounds.
    Default matches TextBuilder::default (text.rs:707-711)."""

    x: str = X_CENTER
    line_y: str = Y_BODY_MIDDLE
    z: str = Z_BACK

    #: positioning.rs Positioning::LOW.
    @staticmethod
    def low() -> "Positioning":
        return Positioning(x=X_LEFT, line_y=Y_BODY_BOTTOM, z=Z_BACK)


@dataclass(frozen=True)
class Layout:
    """layout.rs:26 Layout: positioned glyphs + header."""

    glyphs: tuple  # ((glyph_index, (x, y)), ...) — y is the glyph TOP row
    logical_bounding_box: Optional[GridAab]
    rendering_bounding_box: Optional[GridAab]
    z: int


def compute_layout(
    string: str,
    font: FontDef,
    outline: bool,
    layout_bounds: GridAab,
    positioning: Positioning,
) -> Layout:
    """layout.rs:100 compute_layout, i32 semantics in plain ints.

    Glyph positions identify the glyph-cell origin pixel; the reference's
    off-by-one conventions ("coordinates identify pixels") are preserved
    so multiblock splits land identically.
    """
    lb = layout_bounds
    cw, ch = font.char_w, font.char_h
    outline_expansion = 1 if outline else 0
    thickness = 1 + outline_expansion

    if positioning.line_y == Y_BODY_TOP:
        off_y = lb.upper[1] - 1
    elif positioning.line_y == Y_BODY_MIDDLE:
        # layout.rs:129 0.75 rounding fudge, verbatim.
        center_y = (lb.lower[1] + lb.upper[1]) / 2.0
        off_y = int(np.round(center_y - 0.75)) + (ch - 1) // 2
    elif positioning.line_y == Y_BASELINE:
        off_y = lb.lower[1] + font.baseline - 1
    else:  # Y_BODY_BOTTOM
        off_y = lb.lower[1] + ch - 1

    off_z = lb.lower[2] if positioning.z == Z_BACK else lb.upper[2] - thickness

    glyphs: list[tuple[int, tuple[int, int]]] = []
    logical: Optional[GridAab] = None
    rendering: Optional[GridAab] = None
    cursor_y = 0

    def union(a: Optional[GridAab], b: GridAab) -> GridAab:
        if a is None:
            return b
        lo = tuple(min(x, y) for x, y in zip(a.lower, b.lower))
        hi = tuple(max(x, y) for x, y in zip(a.upper, b.upper))
        return GridAab.from_lower_upper(lo, hi)

    for line in string.split("\n"):
        first_of_line = len(glyphs)
        cursor_x = 0
        for c in line:
            gi = char_to_glyph_index(c)
            pos = (cursor_x, cursor_y + off_y)
            cursor_x += cw
            if font.glyph_bbox(gi, outline) is None:
                continue  # empty glyph draws nothing (layout.rs:191)
            glyphs.append((gi, pos))
        line_width = cursor_x
        if positioning.x == X_LEFT:
            line_start_x = lb.lower[0] + outline_expansion
        elif positioning.x == X_CENTER:
            # layout.rs:212: sum before halving for parity-exact
            # centering; i32 division truncates toward zero (NOT
            # Python's floor — they differ for negative widths).
            line_start_x = int((lb.lower[0] + lb.upper[0] - line_width) / 2)
        else:  # X_RIGHT
            line_start_x = lb.upper[0] - line_width - outline_expansion
        for i in range(first_of_line, len(glyphs)):
            gi, (gx, gy) = glyphs[i]
            gx += line_start_x
            glyphs[i] = (gi, (gx, gy))
            e = outline_expansion
            # Logical box: the whole character cell (y-flipped to voxel
            # space: cell top row gy maps to voxel rows (gy-ch, gy]).
            logical = union(
                logical,
                GridAab.from_lower_upper(
                    (gx - e, gy - ch + 1 - e, off_z),
                    (gx + cw + e, gy + 1 + e, off_z + thickness),
                ),
            )
            bbox = font.glyph_bbox(gi, outline)
            (x0, y0), (x1, y1) = bbox
            rendering = union(
                rendering,
                GridAab.from_lower_upper(
                    (gx + x0, gy - (y1 - 1), off_z),
                    (gx + x1, gy - y0 + 1, off_z + thickness),
                ),
            )
        cursor_y -= ch
    return Layout(
        glyphs=tuple(glyphs),
        logical_bounding_box=logical,
        rendering_bounding_box=rendering,
        z=off_z,
    )


VALUE_OUTLINE, VALUE_FOREGROUND = 1, 2


@functools.lru_cache(maxsize=512)
def _glyph_values(font: FontDef, glyph_index: int) -> Optional[tuple]:
    """(values u8[h, w], (dx, dy)) in glyph pixel space with an
    8-neighborhood outline ring (font.rs:434 brush); None when empty."""
    masks = font.masks()
    if glyph_index >= len(masks):
        glyph_index = 0x1F
    fg = masks[glyph_index]
    if not fg.any():
        return None
    pad = np.zeros((font.char_h + 2, font.char_w + 2), bool)
    pad[1:-1, 1:-1] = fg
    ring = np.zeros_like(pad)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ring |= np.roll(np.roll(pad, dy, 0), dx, 1)
    values = np.where(pad, VALUE_FOREGROUND, np.where(ring, VALUE_OUTLINE, 0))
    return values.astype(np.uint8), (-1, -1)


def draw_layout_voxels(layout: Layout, font: FontDef, outline: bool):
    """Yield (cube (x,y,z), value) for every voxel the laid-out text
    draws (text.rs:381 draw_voxels_to_transaction + Brush semantics):
    plain text puts FOREGROUND at z; outlined text puts OUTLINE at z
    under everything and FOREGROUND at z+1 (text.rs:819-838 P0/P1)."""
    z = layout.z
    for gi, (gx, gy) in layout.glyphs:
        gv = _glyph_values(font, gi)
        if gv is None:
            continue
        values, (dx0, dy0) = gv
        for py, px in np.argwhere(values):
            v = values[py, px]
            x = gx + int(px) + dx0
            y = gy - (int(py) + dy0)  # y-flip (text.rs:410)
            if not outline:
                if v == VALUE_FOREGROUND:
                    yield (x, y, z), VALUE_FOREGROUND
            else:
                yield (x, y, z), VALUE_OUTLINE
                if v == VALUE_FOREGROUND:
                    yield (x, y, z + 1), VALUE_FOREGROUND


@dataclass(frozen=True)
class Text:
    """block/text.rs:43 Text: a string + font + styling + positioning.

    `foreground`/`outline` are colors here rather than whole Blocks (our
    voxel payload is color+emission rows, so a color captures the
    reference's from_color-based usage; block-valued brushes are a
    documented deviation)."""

    string: str
    font: str = "system16"
    foreground: tuple = (0.05, 0.05, 0.05, 1.0)  # palette::ALMOST_BLACK
    outline: Optional[tuple] = None
    resolution: int = 16
    layout_bounds: Optional[tuple] = None  # ((lower), (size)); default block
    positioning: Positioning = field(default_factory=Positioning)
    debug: bool = False

    def font_def(self) -> FontDef:
        return FONTS[self.font]

    def bounds(self) -> GridAab:
        if self.layout_bounds is None:
            return GridAab.from_lower_size((0, 0, 0), (self.resolution,) * 3)
        lo, size = self.layout_bounds
        return GridAab.from_lower_size(lo, size)

    def layout(self) -> Layout:
        return compute_layout(
            self.string,
            self.font_def(),
            self.outline is not None,
            self.bounds(),
            self.positioning,
        )

    def bounding_blocks(self) -> GridAab:
        """text.rs:441 bounding_blocks: the Primitive::Text offsets that
        fit the rendered text, in whole blocks."""
        bb = self.layout().rendering_bounding_box
        r = self.resolution
        if bb is None:
            return GridAab.from_lower_size((0, 0, 0), (1, 1, 1))
        lo = tuple(int(np.floor(c / r)) for c in bb.lower)
        hi = tuple(int(np.ceil(c / r)) for c in bb.upper)
        return GridAab.from_lower_upper(lo, hi)

    def single_block(self) -> "object":
        """text.rs:228 single_block: the block at multiblock offset 0."""
        return self.block_at((0, 0, 0))

    def block_at(self, offset: tuple) -> "object":
        """The Primitive::Text block showing the resolution³ window at
        `offset` (in blocks) of the laid-out text."""
        from ..block.model import Block, TextPrimitive

        return Block(
            TextPrimitive(
                text=self.string,
                resolution=self.resolution,
                color=tuple(self.foreground),
                tile=(int(offset[0]), int(offset[1])),
                font=self.font,
                positioning=(
                    self.positioning.x,
                    self.positioning.line_y,
                    self.positioning.z,
                ),
                layout_lower=tuple(self.bounds().lower),
                layout_size=tuple(self.bounds().size),
                outline_color=(
                    None if self.outline is None else tuple(self.outline)
                ),
                tile_z=int(offset[2]),
            )
        )

    def blocks(self) -> dict:
        """offset -> Block for every block in bounding_blocks() (the
        text.rs installation() role, minus the universe transaction)."""
        out = {}
        for cube in self.bounding_blocks().interior_iter():
            out[tuple(int(c) for c in cube)] = self.block_at(cube)
        return out
