"""Host-side text rasterization (reference: block/text.rs, text/font.rs).

Port of `aic_tpu/text/font.py`, with no imaging library. `aic_tpu` draws
every string with `PIL.ImageFont.load_default()`; the port composes the
same mask from a vendored glyph table, `assets/pil_glyphs.json`, written
by `aic_tpu_torch/tools/pil_glyph_table.py` on a machine with PIL. The
table records the font (Aileron Regular at size 10), the Pillow, FreeType
and raqm versions it was taken from, and for every character of its
repertoire (printable Latin-1 and every character the port's content and
UI draw) PIL's grey coverage bitmap (`font.getmask2(c, "L")`), its offset
from the pen and its advance in 1/64 px. Every advance is a whole pixel.

The composition rule, which the tool checks against PIL on every ordered
pair of the repertoire and on the content's strings before it writes:

- a line's glyphs are blended in order over a u8 canvas the size of the
  line's box, each at its integer pen position plus its offset, by PIL's
  integer "over" with white ink, a ← s + round(a·(255 − s)/255)
  (`over`);
- a line's box spans x from min(0, the leftmost ink) to max(the advance,
  the rightmost ink), and y over the ink, or is the empty box at the
  ascent where the line has no ink;
- lines (split at "\\n") start `line_spacing` px apart, and each line's
  canvas is blended onto the image by the same rule;
- the image is thresholded at 127 and cropped to its ink exactly as
  `aic_tpu/text/font.py:21-37` crops it (a mask with no ink keeps the
  box's size).

A character outside the repertoire raises `TextNotInTable` naming it; no
other glyph stands in for it.

`rasterize_text` returns a boolean pixel mask of the string; block
evaluation (eval.py `_evaluate_text`) slices per-block tiles out of it to
produce voxels. Cached — text rendering is content-time work.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os

import numpy as np

TABLE_PATH = os.path.join(os.path.dirname(__file__), "assets", "pil_glyphs.json")

#: Coverage above this is ink (`aic_tpu/text/font.py:31`).
THRESHOLD = 127


class TextNotInTable(KeyError):
    """A character outside the vendored glyph table's repertoire."""


@dataclasses.dataclass(frozen=True)
class Glyph:
    coverage: np.ndarray  # u8[h, w], PIL's grey coverage
    offset: tuple[int, int]  # (x, y) of the bitmap from the pen, y down from the line's top
    advance: int  # in 1/64 px


@dataclasses.dataclass(frozen=True)
class GlyphTable:
    glyphs: dict  # character → Glyph
    kerning: dict  # two characters → adjustment of the second's pen, 1/64 px
    ascent: int  # y of the box of a line with no ink
    line_spacing: int  # px from one line's top to the next's

    @classmethod
    def from_json(cls, table: dict) -> "GlyphTable":
        glyphs = {}
        for c, (advance, ox, oy, h, w, bits) in table["glyphs"].items():
            cov = np.frombuffer(bytes.fromhex(bits), np.uint8).reshape(h, w)
            glyphs[c] = Glyph(cov, (ox, oy), advance)
        return cls(glyphs, dict(table["kerning"]), table["ascent"], table["line_spacing"])


def encode_glyph(coverage: np.ndarray, offset, advance: int) -> list:
    """[advance, x, y, h, w, hex of the row-major coverage]: a table entry."""
    h, w = coverage.shape
    return [int(advance), int(offset[0]), int(offset[1]), int(h), int(w),
            np.ascontiguousarray(coverage, np.uint8).tobytes().hex()]


@functools.lru_cache(maxsize=1)
def glyph_table() -> GlyphTable:
    with open(TABLE_PATH) as f:
        return GlyphTable.from_json(json.load(f))


def over(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """White ink of coverage `src` over `dst` (u8 arrays), as PIL blends
    it (Paste.c `BLEND`, `DIV255` rounding exactly)."""
    d = dst.astype(np.int32)
    s = src.astype(np.int32)
    t = d * (255 - s) + 128
    return (s + (((t >> 8) + t) >> 8)).astype(np.uint8)


def _line(line: str, table: GlyphTable):
    """The line's box (x0, y0, x1, y1) and its coverage u8[y1-y0, x1-x0]."""
    placed = []
    pen = 0
    prev = None
    for c in line:
        g = table.glyphs.get(c)
        if g is None:
            raise TextNotInTable(f"{c!r} (U+{ord(c):04X}) of {line!r} is not in the vendored glyph table "
                                 f"({TABLE_PATH})")
        if prev is not None:
            pen += table.kerning.get(prev + c, 0)
        placed.append((g, pen // 64 + g.offset[0], g.offset[1]))
        pen += g.advance
        prev = c
    inked = [(g, x, y) for g, x, y in placed if g.coverage.shape[0]]
    x0 = min([0] + [x for _g, x, _y in placed])
    x1 = max([pen // 64] + [x + g.coverage.shape[1] for g, x, _y in placed])
    if inked:
        y0 = min(y for _g, _x, y in inked)
        y1 = max(y + g.coverage.shape[0] for g, _x, y in inked)
    else:
        y0 = y1 = table.ascent
    canvas = np.zeros((y1 - y0, x1 - x0), np.uint8)
    for g, x, y in inked:
        h, w = g.coverage.shape
        win = (slice(y - y0, y - y0 + h), slice(x - x0, x - x0 + w))
        canvas[win] = over(canvas[win], g.coverage)
    return (x0, y0, x1, y1), canvas


def compose(text: str, table: GlyphTable) -> np.ndarray:
    """bool[h, w] mask of `text` by the module's composition rule."""
    lines = [_line(ln, table) for ln in text.split("\n")]
    boxes = [(x0, y0 + k * table.line_spacing, x1, y1 + k * table.line_spacing)
             for k, ((x0, y0, x1, y1), _c) in enumerate(lines)]
    left, top = min(b[0] for b in boxes), min(b[1] for b in boxes)
    w = max(max(b[2] for b in boxes) - left, 1)
    h = max(max(b[3] for b in boxes) - top, 1)
    img = np.zeros((h, w), np.uint8)
    for (x0, y0, _x1, _y1), (_box, canvas) in zip(boxes, lines):
        ch, cw = canvas.shape
        win = (slice(y0 - top, y0 - top + ch), slice(x0 - left, x0 - left + cw))
        img[win] = over(img[win], canvas)
    mask = img > THRESHOLD
    # Crop exact content box (keeps layout deterministic).
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return np.zeros((h, w), bool)
    return mask[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]


@functools.lru_cache(maxsize=256)
def rasterize_text(text: str) -> np.ndarray:
    """bool[h, w] mask of `text` (row 0 = top) in PIL's default font, as
    `aic_tpu` draws it. Empty text yields a 1×1 empty mask."""
    if not text:
        return np.zeros((1, 1), bool)
    return compose(text, glyph_table())


def measure_text(text: str) -> tuple[int, int]:
    """(height, width) of the rasterized string in pixels."""
    m = rasterize_text(text)
    return m.shape[0], m.shape[1]


def text_tile(text: str, resolution: int, tile: tuple[int, int]) -> np.ndarray:
    """The (tx, ty) resolution² window of the laid-out string, scaled so
    the text height fills ~60% of a block. Returns bool[resolution,
    resolution] in voxel orientation (index [x, y]: +x right, +y up)."""
    mask = rasterize_text(text)
    h, w = mask.shape
    scale = max(int(resolution * 0.6) // max(h, 1), 1)
    scaled = np.repeat(np.repeat(mask, scale, 0), scale, 1)
    sh, sw = scaled.shape
    tx, ty = tile
    # Vertically centered within the tile row.
    y0 = ty * resolution - (resolution - sh) // 2
    x0 = tx * resolution
    out = np.zeros((resolution, resolution), bool)
    for y in range(resolution):
        for x in range(resolution):
            sy = y0 + y
            sx = x0 + x
            if 0 <= sy < sh and 0 <= sx < sw:
                out[y, x] = scaled[sy, sx]
    # Pixel rows count downward; voxel +y is up. Also transpose to [x, y].
    return out[::-1].T


def text_tile_count(text: str, resolution: int) -> int:
    """Number of block tiles the string occupies horizontally."""
    h, w = measure_text(text)
    scale = max(int(resolution * 0.6) // max(h, 1), 1)
    return max((w * scale + resolution - 1) // resolution, 1)
