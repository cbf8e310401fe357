"""System font glyphs for info-text overlays and Text blocks.

Port of `aic_tpu/text/sysfont.py`, copied but for how the atlas is read:
the vendored PNG is decoded with `zlib` and `struct` (`read_png`), so no
imaging library is needed, and neither `aic_tpu`'s reference-checkout
path nor its PIL fall-back is kept.

The reference renders info text with its embedded 7×16 monospaced bitmap
font (all-is-cubes/src/text/font.rs FONT_SYSTEM_16, atlas
font-system-7x16.png, 16 glyphs/row, repertoire ISO-8859-1), drawing each
glyph as Foreground pixels plus an 8-neighborhood Outline
(font.rs:434-443 "brush"). Glyphs are drawn in layout order and a later
glyph's outline may overwrite an earlier glyph's foreground
(font.rs:156-165 caution) — draw_info_text assigns paint directly
(render/src/raytracer/renderer.rs:659-683).

The atlas ships vendored with this package (text/assets/, MIT,
attribution in assets/README.md).
"""

from __future__ import annotations

import functools
import os
import struct
import zlib

import numpy as np

ATLAS_PATH = os.path.join(os.path.dirname(__file__), "assets", "font-system-7x16.png")
GLYPHS_PER_ROW = 16
CHAR_W, CHAR_H = 7, 16
BASELINE = 13

VALUE_NONE = 0
VALUE_OUTLINE = 1
VALUE_FOREGROUND = 2


def char_to_glyph_index(c: str) -> int:
    """font.rs:213 char_to_glyph_index: ISO-8859-1 + quote lookalikes."""
    if c in "‘’":
        c = "'"
    elif c in "“”":
        c = '"'
    o = ord(c)
    if 0x20 <= o <= 0x7F:
        return o - 0x20
    if 0x80 <= o <= 0xFF:
        return o - 0x40
    return 0x1F  # '?'


def read_png(path: str) -> np.ndarray:
    """u8[h, w, 4] RGBA of an 8-bit, non-interlaced palette PNG with a
    tRNS chunk (the atlas's format), decoded with zlib."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos, idat, plte, trns = 8, [], None, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if (depth, ctype, interlace) != (8, 3, 0) or plte is None:
        raise ValueError(f"{path}: not an 8-bit palette PNG (depth {depth}, type {ctype}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w + 1)
    idx = np.zeros((h, w), np.uint8)
    prev = np.zeros(w, np.int32)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        cur = np.zeros(w, np.int32)
        for i in range(w):  # the filters of PNG 9.2, one byte a pixel
            a = cur[i - 1] if i else 0
            b = prev[i]
            c = prev[i - 1] if i else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (line[i] + pred) & 0xFF
        idx[y] = cur
        prev = cur
    alpha = np.full(len(plte), 255, np.uint8)
    alpha[: len(trns)] = np.frombuffer(trns, np.uint8)
    return np.concatenate([plte[idx], alpha[idx][..., None]], axis=-1)


@functools.lru_cache(maxsize=4)
def atlas_masks(path: str, char_w: int, char_h: int) -> np.ndarray:
    """bool[n_glyphs, char_h, char_w] foreground masks from a font
    atlas PNG (16 glyphs/row, rgba_to_bit per font.rs:556: r>0 & a>0)."""
    img = read_png(path)
    fg = (img[..., 0] > 0) & (img[..., 3] > 0)
    rows = img.shape[0] // char_h
    return (
        fg.reshape(rows, char_h, GLYPHS_PER_ROW, char_w)
        .transpose(0, 2, 1, 3)
        .reshape(rows * GLYPHS_PER_ROW, char_h, char_w)
    )


def _glyph_masks() -> np.ndarray:
    """bool[n_glyphs, CHAR_H, CHAR_W] system-16 foreground masks."""
    return atlas_masks(ATLAS_PATH, CHAR_W, CHAR_H)


@functools.lru_cache(maxsize=256)
def _glyph_value_map(glyph_index: int):
    """Per-glyph value map with its outline: (values u8[h, w], origin
    (dy, dx)) — origin is the offset of the map's top-left relative to
    the glyph cell's top-left (outline spills 1px beyond set pixels).
    Returns None for empty glyphs."""
    masks = _glyph_masks()
    if glyph_index >= len(masks):
        glyph_index = 0x1F
    fg = masks[glyph_index]
    if not fg.any():
        return None
    pad = np.zeros((CHAR_H + 2, CHAR_W + 2), bool)
    pad[1:-1, 1:-1] = fg
    outline = np.zeros_like(pad)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            outline |= np.roll(np.roll(pad, dy, 0), dx, 1)
    values = np.where(pad, VALUE_FOREGROUND, np.where(outline, VALUE_OUTLINE, 0))
    ys, xs = np.nonzero(values)
    y0, y1 = ys.min(), ys.max() + 1
    x0, x1 = xs.min(), xs.max() + 1
    return values[y0:y1, x0:x1].astype(np.uint8), (int(y0) - 1, int(x0) - 1)


def draw_text_values(canvas: np.ndarray, text: str, origin=(5, 5)) -> None:
    """Paint glyph values (1=outline, 2=foreground) into `canvas`
    (u8[H, W]) at pixel `origin`, monospaced, lines top-down — the
    layout of FontDef::draw_str_monospaced (Left / BodyTop) as used by
    draw_info_text (renderer.rs:659: origin (5,5)).

    Glyphs are painted in order with direct assignment, replicating the
    reference's overlap semantics exactly.
    """
    h, w = canvas.shape[:2]
    oy, ox = origin
    for line_no, line in enumerate(text.split("\n")):
        for col, c in enumerate(line):
            gm = _glyph_value_map(char_to_glyph_index(c))
            if gm is None:
                continue
            values, (dy, dx) = gm
            gy = oy + line_no * CHAR_H + dy
            gx = ox + col * CHAR_W + dx
            for yy in range(values.shape[0]):
                py = gy + yy
                if not (0 <= py < h):
                    continue
                for xx in range(values.shape[1]):
                    px = gx + xx
                    v = values[yy, xx]
                    if v and 0 <= px < w:
                        canvas[py, px] = v


def draw_info_text(image: np.ndarray, text: str, scale: int = 1) -> None:
    """Draw info text into an sRGB RGBA image in place: outline black,
    foreground white (renderer.rs:208-216 paint array).

    `scale` is unused by the reference (draw_info_text has a TODO about
    scaling); kept for API completeness."""
    values = np.zeros(image.shape[:2], np.uint8)
    draw_text_values(values, text)
    image[values == VALUE_OUTLINE] = (0, 0, 0, 255)
    image[values == VALUE_FOREGROUND] = (255, 255, 255, 255)
