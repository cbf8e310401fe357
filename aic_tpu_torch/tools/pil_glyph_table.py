#!/usr/bin/env python3
"""Write the port's glyph tables of PIL's default font (`text/assets/pil_glyphs.json`, `pil_body_text.json`).

    python3 aic_tpu_torch/tools/pil_glyph_table.py [--check]

`aic_tpu` rasterizes a `TextPrimitive`'s string with
`PIL.ImageFont.load_default()`, thresholded at 127 (`aic_tpu/text/
font.py:15`). The port composes the same masks glyph by glyph from this
table (`text/font.py` states the rule), with no PIL. This is the only
file of the port that imports PIL; run it on a machine that has it.

The repertoire is printable Latin-1 (U+0020-007E, U+00A0-00FF) and every
character of the strings the port's content and UI draw, found by running
their builders with `text.font.rasterize_text` wrapped:

- every template of `content.TEMPLATE_NAMES` at its default size but
  `fail` (which raises) and `plaza640` (the atrium's blocks, no text);
- every exhibit's standalone space, and the name sign of every exhibit
  (`Smallest` too, which demo-city leaves out);
- a `Tooltip` showing each tool class of `universe/cursor.py`;
- the voxel UI's fixed strings (`ui_strings`): the HUD, every page
  (paused, about, progress and message with nothing to show, settings
  with each setting at each of its values), the menu.

For each character it stores PIL's grey coverage (`font.getmask2(c,
"L")`), its offset and its advance in 1/64 px (`font.getlength`), and for
the font its ascent and line spacing (`ImageDraw.textbbox`'s rule for
multi-line text), with the font's name and the Pillow, FreeType and raqm
versions. Before it writes anything it checks, and fails on any
mismatch:

- every advance is a whole pixel;
- every ordered pair of the repertoire: its advance is the sum of the
  two (a pair whose advance differs is recorded as kerning), and its
  composed mask equals PIL's drawing of it (`rasterize_pil`, a copy of
  `aic_tpu`'s code) bit for bit;
- every recorded string, and seeded random strings of the repertoire and
  line breaks, the same way.

It also writes the body-text font's atlas (`text/layout.py
BODY_ATLAS_PATH`): each of its 224 glyphs drawn by PIL into a 6x14 cell
at (0, 2), any coverage set, as `aic_tpu/text/sysfont.py:72-80` draws
its fall-back atlas; `text/layout.py` reads it with no PIL.

`--check` writes nothing and fails if a table differs from what it
would write.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

#: Printable Latin-1.
LATIN1 = [chr(c) for c in list(range(0x20, 0x7F)) + list(range(0xA0, 0x100))]
#: Seeded random strings checked besides the pairs, and their longest.
RANDOM_STRINGS = 2000
RANDOM_MAX_LEN = 40


class _Recording:
    """Within the block, every string `text.font.rasterize_text` is asked
    for is added to `seen` and drawn by PIL (`rasterize_pil`), so that
    recording needs no glyph table."""

    def __init__(self, seen: set):
        self.seen = seen

    def __enter__(self):
        from aic_tpu_torch.text import font

        self.inner = font.rasterize_text

        def record(text):
            self.seen.add(text)
            return rasterize_pil(text)

        font.rasterize_text = record

    def __exit__(self, *exc):
        from aic_tpu_torch.text import font

        font.rasterize_text = self.inner
        return False


def setting_values(name: str) -> list:
    """Every value the settings page can show for a setting: its cycle,
    the default, and every value of an enumerated option."""
    import dataclasses

    from aic_tpu_torch.raytrace import options
    from aic_tpu_torch.vui.page import SETTING_CYCLES

    values = list(SETTING_CYCLES[name]) + [getattr(options.GraphicsOptions().repair(), name)]
    prefix = {"lighting_display": "LIGHT_", "fog": "FOG_", "transparency": "TRANSPARENCY_"}.get(name)
    if prefix:
        values += [v for k, v in vars(options).items() if k.startswith(prefix)]
    out = []
    for v in values:
        shown = getattr(dataclasses.replace(options.GraphicsOptions(), **{name: v}).repair(), name)
        if shown not in out:
            out.append(shown)
    return out


def ui_strings() -> set:
    """Every fixed string the voxel UI draws: the HUD, each page, the
    settings page at every value of each setting, and the menu. Free-form
    strings (a message page's lines, a notification's title) are not
    fixed and not recorded."""
    import dataclasses

    from aic_tpu_torch.apps.settings import Settings
    from aic_tpu_torch.content import TemplateParameters, build_template_space
    from aic_tpu_torch.raytrace.options import GraphicsOptions
    from aic_tpu_torch.universe.cursor import free_editing_inventory
    from aic_tpu_torch.vui import hud, page

    seen = set()
    with _Recording(seen):
        hud.build_hud(free_editing_inventory())
        hud.pause_page()
        build_template_space("menu", TemplateParameters())
        page.build_paused_page()
        page.build_about_page()
        page.build_progress_page(None)
        page.build_message_page("")
        values = {name: setting_values(name) for name in page.SETTING_CYCLES}
        for k in range(max(map(len, values.values()))):
            # The k-th value of every setting at once, the first where a
            # setting has fewer.
            shown = {name: vs[k] if k < len(vs) else vs[0] for name, vs in values.items()}
            page.build_settings_page(Settings(options=dataclasses.replace(GraphicsOptions(), **shown)))
    seen.discard("")
    return seen


def recorded_strings() -> set:
    from aic_tpu_torch.content import TEMPLATE_NAMES, TemplateParameters, build_template_space
    from aic_tpu_torch.content.exhibits import EXHIBITS
    from aic_tpu_torch.math.grid import GridAab
    from aic_tpu_torch.space import Space
    from aic_tpu_torch.text import font
    from aic_tpu_torch.universe import cursor
    from aic_tpu_torch.vui import Tooltip

    seen = set()
    with _Recording(seen):
        for name in TEMPLATE_NAMES:
            if name not in ("fail", "plaza640"):
                build_template_space(name, TemplateParameters())
        for ex in EXHIBITS:
            ex.factory()
            font.text_tile_count(ex.name, 16)
        tools = [
            c for c in vars(cursor).values()
            if isinstance(c, type) and issubclass(c, cursor.Tool) and c is not cursor.Tool
        ]
        for tool in tools:
            inv = cursor.Inventory(slots=[tool.__new__(tool)])
            Tooltip(inv).draw(Space(GridAab.from_lower_size((0, 0, 0), (10, 1, 1))), (0, 0, 0))
    seen.discard("")
    return seen | ui_strings()


def rasterize_pil(text: str) -> np.ndarray:
    """`aic_tpu/text/font.py:15-38` verbatim: `text` drawn with PIL's
    default font, thresholded at 127 and cropped to its content."""
    from PIL import Image, ImageDraw, ImageFont

    if not text:
        return np.zeros((1, 1), bool)
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


def build_table(repertoire: list) -> dict:
    """The table of PIL's default font over `repertoire`, as JSON."""
    import PIL
    from PIL import ImageFont, features

    from aic_tpu_torch.text import font as tfont

    f = ImageFont.load_default()
    if not isinstance(f, ImageFont.FreeTypeFont):
        sys.exit(f"ImageFont.load_default() is {type(f).__name__}, not the FreeType font aic_tpu draws with")
    glyphs = {}
    for c in repertoire:
        im, offset = f.getmask2(c, "L")
        w, h = im.size
        cov = np.array(im, np.uint8).reshape(h, w) if w * h else np.zeros((h, w), np.uint8)
        advance = f.getlength(c) * 64
        if advance != int(advance) or int(advance) % 64:
            sys.exit(f"{c!r}: advance {advance / 64} px is not a whole pixel")
        glyphs[c] = tfont.encode_glyph(cov, offset, int(advance))
    kerning = {}
    for a in repertoire:
        for b in repertoire:
            adj = f.getlength(a + b) * 64 - glyphs[a][0] - glyphs[b][0]
            if adj:
                kerning[a + b] = int(adj)
    spacing = f.getbbox("A")[3] + 4  # ImageText._split: the "A" box's bottom + spacing 4
    ascent = f.getmetrics()[0]
    if spacing != int(spacing):
        sys.exit(f"line spacing {spacing} px is not whole")
    family, style = f.font.family, f.font.style
    return {
        "font": f"{family} {style} at size {f.size} (PIL ImageFont.load_default())",
        "pillow": PIL.__version__,
        "freetype": features.version("freetype2"),
        "raqm": features.version("raqm"),
        "rule": "see aic_tpu_torch/text/font.py",
        "ascent": int(ascent),
        "line_spacing": int(spacing),
        "kerning": kerning,
        "glyphs": glyphs,
    }


def draw_atlas_masks(char_w: int, char_h: int) -> np.ndarray:
    """bool[224, char_h, char_w]: `aic_tpu/text/sysfont.py:72-80`'s PIL
    fall-back atlas, glyph by glyph."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.load_default()
    masks = np.zeros((224, char_h, char_w), bool)
    for gi in range(224):
        o = gi + 0x20 if gi < 0x60 else gi + 0x40
        im = Image.new("L", (char_w, char_h), 0)
        ImageDraw.Draw(im).text((0, 2), chr(o), fill=255, font=font)
        masks[gi] = np.asarray(im) > 0
    return masks


def build_body_atlas(char_w: int, char_h: int) -> dict:
    """The body-text atlas as JSON: the masks' bits packed, base64."""
    import PIL

    masks = draw_atlas_masks(char_w, char_h)
    return {
        "font": "PIL ImageFont.load_default(), each glyph drawn at (0, 2) in its cell, any coverage set",
        "pillow": PIL.__version__,
        "char_w": char_w,
        "char_h": char_h,
        "masks": base64.b64encode(np.packbits(masks.reshape(-1)).tobytes()).decode(),
    }


def verify(table: dict, strings: list) -> int:
    """Composes every ordered pair of the table's repertoire and every
    string of `strings` and holds each to PIL's mask; exits on the first
    mismatch. Returns how many strings were checked."""
    from aic_tpu_torch.text import font as tfont

    t = tfont.GlyphTable.from_json(table)
    rep = sorted(t.glyphs)
    cases = [a + b for a in rep for b in rep] + list(strings)
    for s in cases:
        got, want = tfont.compose(s, t), rasterize_pil(s)
        if got.shape != want.shape or (got != want).any():
            sys.exit(f"{s!r}: composed mask {got.shape} differs from PIL's {want.shape}; table not written")
    return len(cases)


def random_strings(repertoire: list, n: int, seed: int = 0) -> list:
    """`n` seeded strings of 1..RANDOM_MAX_LEN characters of the
    repertoire, every fourth with line breaks among them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pool = repertoire + ["\n"] if i % 4 == 3 else repertoire
        out.append("".join(rng.choice(pool, int(rng.integers(1, RANDOM_MAX_LEN + 1)))))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--check", action="store_true", help="compare, write nothing")
    args = ap.parse_args()
    from aic_tpu_torch.text import font as tfont
    from aic_tpu_torch.text import layout as tlayout

    strings = sorted(recorded_strings())
    repertoire = sorted(set(LATIN1) | set("".join(strings)) - {"\n"})
    table = build_table(repertoire)
    n = verify(table, strings + random_strings(repertoire, RANDOM_STRINGS))
    print(f"{len(repertoire)} glyphs, {len(table['kerning'])} kerning pairs; {n} strings composed "
          f"equal to PIL's masks ({table['font']}, Pillow {table['pillow']}, FreeType {table['freetype']})")
    body = tlayout.FONT_BODY_TEXT
    atlas = build_body_atlas(body.char_w, body.char_h)
    outputs = ((tfont.TABLE_PATH, table), (tlayout.BODY_ATLAS_PATH, atlas))
    if args.check:
        same = True
        for path, want in outputs:
            with open(path) as f:
                ok = json.load(f) == want
            print(f"{os.path.basename(path)} {'matches' if ok else 'DIFFERS'}")
            same &= ok
        sys.exit(0 if same else 1)
    for path, want in outputs:
        with open(path, "w") as f:
            f.write(json.dumps(want, indent=1, ensure_ascii=False, sort_keys=True) + "\n")
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
