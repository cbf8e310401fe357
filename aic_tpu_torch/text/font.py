"""Host-side text rasterization (reference: block/text.rs, text/font.rs).

Port of `aic_tpu/text/font.py`. `aic_tpu` draws every string with
`PIL.ImageFont.load_default()`, which with FreeType is a vector font
thresholded at 127: no glyph table reproduces it outside PIL. The port
reads the masks of the strings its content draws from a vendored table
(`assets/pil_text_masks.json`, written by
`aic_tpu_torch/tools/pil_text_table.py` with a copy of `aic_tpu`'s
drawing code). A string that is not in the table is drawn with PIL where
PIL can be imported; where it cannot, `rasterize_text` raises
`TextNotInTable` naming the string. It never substitutes another font.

`rasterize_text` returns a boolean pixel mask of the string; block
evaluation (eval.py `_evaluate_text`) slices per-block tiles out of it to
produce voxels. Cached — text rendering is content-time work.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np

TABLE_PATH = os.path.join(os.path.dirname(__file__), "assets", "pil_text_masks.json")


class TextNotInTable(KeyError):
    """A string outside the vendored mask table, with no PIL to draw it."""


def encode_mask(mask: np.ndarray) -> list:
    """[h, w, hex of the row-major packed bits]: a table entry."""
    h, w = mask.shape
    return [int(h), int(w), np.packbits(mask.ravel()).tobytes().hex()]


def decode_mask(entry) -> np.ndarray:
    h, w, bits = entry
    flat = np.unpackbits(np.frombuffer(bytes.fromhex(bits), np.uint8), count=h * w)
    return flat.reshape(h, w).astype(bool)


@functools.lru_cache(maxsize=1)
def _table() -> dict:
    if not os.path.exists(TABLE_PATH):
        return {}
    with open(TABLE_PATH) as f:
        return json.load(f)["masks"]


def rasterize_pil(text: str) -> np.ndarray:
    """`aic_tpu/text/font.py:15-38` verbatim: `text` drawn with PIL's
    default font, thresholded at 127 and cropped to its content."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.load_default()
    # Measure, then draw with a margin and crop to content.
    probe = Image.new("L", (1, 1))
    bbox = ImageDraw.Draw(probe).textbbox((0, 0), text, font=font)
    w = max(bbox[2] - bbox[0], 1)
    h = max(bbox[3] - bbox[1], 1)
    img = Image.new("L", (w + 2, h + 2), 0)
    ImageDraw.Draw(img).text((1 - bbox[0], 1 - bbox[1]), text, fill=255, font=font)
    mask = np.asarray(img) > 127
    # Crop exact content box (keeps layout deterministic).
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return np.zeros((h, w), bool)
    return mask[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]


@functools.lru_cache(maxsize=256)
def rasterize_text(text: str) -> np.ndarray:
    """bool[h, w] mask of `text` (row 0 = top) in PIL's default font.
    Empty text yields a 1×1 empty mask."""
    if not text:
        return np.zeros((1, 1), bool)
    entry = _table().get(text)
    if entry is not None:
        return decode_mask(entry)
    try:
        import PIL  # noqa: F401
    except ImportError:
        raise TextNotInTable(
            f"{text!r} is not in the vendored text table ({TABLE_PATH}) and PIL "
            "cannot be imported to draw it; add it with aic_tpu_torch/tools/pil_text_table.py"
        ) from None
    return rasterize_pil(text)


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
