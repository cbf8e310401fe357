"""The port's text modules (aic_tpu_torch.text) against `aic_tpu.text`.

- `rasterize_text`, `measure_text`, `text_tile_count` and `text_tile`,
  composed from the vendored glyph table with PIL blocked on the port's
  side (`sys.modules["PIL"] = None`), against `aic_tpu`'s PIL drawing of
  the same strings, bit for bit (no tolerance): every string of the
  93-string mask table the port read before the glyph table
  (`MASK_TABLE_STRINGS`), every character of the repertoire, every
  ordered pair of printable ASCII, 2,000 seeded random Latin-1 strings of
  1-40 characters, and multi-line and run-time strings. `text_tile` is
  compared at resolutions 8, 16 and 32, but for the pairs and the random
  strings at 16 alone (the UI's and the exhibits' resolution): their
  tiles at 8 and 32 would add half a minute to the file in the Python
  pixel loop both packages share. Their tile counts are compared at all
  three.
- A character outside the repertoire raises `TextNotInTable`, naming it;
  a fresh interpreter that imports every module of the port and draws
  text never imports PIL.
- The system-16 atlas decoded with zlib (no imaging library) against
  `aic_tpu`'s PIL decode of the same file: equal.
- `compute_layout` and the voxels of `evaluate(Block(TextPrimitive))` for
  the `pil`, `system16` and `body-text` fonts: equal. `aic_tpu` reads its
  system-16 atlas from a reference checkout and, where that is absent,
  draws PIL's default font instead; the port reads its vendored copy of
  that atlas, so `aic_tpu` is given the same file here (its `FONTS` entry
  pointed at `aic_tpu/text/assets/`, as with the checkout present). The
  body-text atlas: `aic_tpu` draws PIL's glyphs, the port reads them from
  its vendored masks (`layout.BODY_ATLAS_PATH`, written by
  `tools/pil_glyph_table.py`); equal glyph for glyph, with PIL hidden.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import aic_tpu.block as jblock
import aic_tpu.text.font as jfont
import aic_tpu.text.layout as jlayout
import aic_tpu.text.sysfont as jsysfont
import aic_tpu_torch.block as tblock
import aic_tpu_torch.text.font as tfont
import aic_tpu_torch.text.layout as tlayout
import aic_tpu_torch.text.sysfont as tsysfont
from aic_tpu.math.grid import GridAab as JGridAab
from aic_tpu_torch.math.grid import GridAab as TGridAab

#: The strings of the whole-string mask table the port read before it
#: composed text from glyphs (`text/assets/pil_text_masks.json`): the
#: port's content and UI strings of that time.
MASK_TABLE_STRINGS = [
    " ", "   L      toggle mouselook", "   P      toggle pause", "  0-9     select toolbar item",
    "  E C     fly up/down", "0", "1", "2", "3", "4", "AIC", "About", "About All is Cubes", "Activate",
    "All is Cubes (TPU edition)", "All is Cubes (TPU)", "Animation", "Arrows    turn", "Back", "Blocks",
    "ChunkChart", "Collision", "Colors", "Composite", "Controls", "CopyFromSpace", "CustomTool",
    "Destruction", "EditBlock", "Elevator", "Escape    back / pause", "Glass", "Images", "Inventory",
    "Jetpack", "Knot", "L-mouse   use first tool", "Misc", "Move", "OK", "Paused", "PlaceBlock",
    "Progress", "PushPull", "Quit", "R-mouse   use selected tool", "RemoveBlock", "Resolutions", "Resume",
    "Rotations", "Settings", "Smallest", "Text", "Transparency", "Trees", "UI Blocks",
    "W A S D   movement", "Zoom", "a voxel world engine re-designed", "antialiasing: False",
    "antialiasing: True", "atrium", "blank", "bloom_intensity: 0.0", "bloom_intensity: 0.125",
    "bloom_intensity: 0.25", "cornell-box", "debug_info_text: False", "debug_info_text: True",
    "demo-city", "dungeon", "fog: abrupt", "fog: compromise", "fog: none", "fog: physical",
    "for TPU hardware: JAX + Pallas.", "github.com/kpreid/all-is-cubes", "is the reference behavior spec.",
    "islands", "lighting-bench", "lighting_display: bounce", "lighting_display: coarse",
    "lighting_display: flat", "lighting_display: linear", "lighting_display: none",
    "lighting_display: smoothstep", "menger-sponge", "random", "show_ui: False", "show_ui: True",
    "transparency: surface", "transparency: threshold", "transparency: volumetric",
]

#: Printable Latin-1, the glyph table's repertoire.
LATIN1 = [chr(c) for c in list(range(0x20, 0x7F)) + list(range(0xA0, 0x100))]
ASCII = [chr(c) for c in range(0x20, 0x7F)]
RANDOM_STRINGS, RANDOM_CHUNK = 2000, 100


def random_latin1(chunk: int) -> list:
    """Strings chunk·RANDOM_CHUNK .. of RANDOM_STRINGS seeded random
    Latin-1 strings of 1-40 characters."""
    rng = np.random.default_rng(2024)
    out = ["".join(rng.choice(LATIN1, int(rng.integers(1, 41)))) for _ in range(RANDOM_STRINGS)]
    return out[chunk * RANDOM_CHUNK : (chunk + 1) * RANDOM_CHUNK]


MULTILINE = [
    "Saved world-0.json",
    "Opened demo-city",
    "Failed to open: [Errno 2] No such file or directory: 'x.json'",
    "Hello\nworld",
    "line one\n\nline three",
    "\n",
    " \n ",
    "jÿ_|\nÅ¶ WAVE fi To\ng",
]


def texts(pkg, strings, resolutions) -> dict:
    """What a package's font module gives for each string: the mask, its
    size, and the tile count and every tile at each resolution."""
    out = {}
    for s in strings:
        tiles = {}
        for res in (8, 16, 32):
            n = pkg.text_tile_count(s, res)
            tiles[res] = (n, [pkg.text_tile(s, res, (tx, 0)) for tx in range(n + 1)] if res in resolutions else [])
        out[s] = (pkg.rasterize_text(s), pkg.measure_text(s), tiles)
    return out


def assert_port_draws_as_aic_tpu(monkeypatch, strings, resolutions=(8, 16, 32)):
    """`aic_tpu`'s results first (PIL draws them), then the port's with
    PIL blocked and its cache cleared: equal, bit for bit."""
    want = texts(jfont, strings, resolutions)
    monkeypatch.setitem(sys.modules, "PIL", None)
    tfont.rasterize_text.cache_clear()
    got = texts(tfont, strings, resolutions)
    for s in strings:
        (gm, gsize, gtiles), (wm, wsize, wtiles) = got[s], want[s]
        assert gm.dtype == wm.dtype == np.bool_
        np.testing.assert_array_equal(gm, wm, err_msg=repr(s))
        assert gsize == wsize, repr(s)
        for res in (8, 16, 32):
            assert gtiles[res][0] == wtiles[res][0], (s, res)
            for tx, (g, w) in enumerate(zip(gtiles[res][1], wtiles[res][1])):
                np.testing.assert_array_equal(g, w, err_msg=f"{s!r} at {res}, tile {tx}")


@pytest.fixture
def aic_system16(monkeypatch):
    """`aic_tpu`'s system-16 font read from its vendored atlas."""
    font = jlayout.FontDef("system-16", 7, 16, 13, jsysfont._VENDORED)
    monkeypatch.setitem(jlayout.FONTS, "system16", font)
    return font


@pytest.fixture
def no_pil(monkeypatch):
    """PIL cannot be imported, as on a machine without it."""
    monkeypatch.setitem(sys.modules, "PIL", None)


def test_table_covers_exhibit_names_and_sign_strings():
    from aic_tpu.content.exhibits import EXHIBITS

    assert len(EXHIBITS) == 22
    names = {e.name for e in EXHIBITS} | {"AIC", "OK"}
    assert names <= set(MASK_TABLE_STRINGS)
    assert set("".join(names)) <= set(tfont.glyph_table().glyphs)
    assert sorted(tfont.glyph_table().glyphs) == sorted(LATIN1)


@pytest.mark.parametrize("text", MASK_TABLE_STRINGS)
def test_rasterize_and_tiles_match_aic_tpu(monkeypatch, text):
    assert_port_draws_as_aic_tpu(monkeypatch, [text])


def test_table_masks_are_read_without_pil(monkeypatch):
    """With PIL hidden, every string of the former mask table composes, to
    the same mask as `aic_tpu`'s (drawn before PIL was hidden)."""
    want = {t: jfont.rasterize_text(t) for t in MASK_TABLE_STRINGS}
    monkeypatch.setitem(sys.modules, "PIL", None)
    tfont.rasterize_text.cache_clear()
    for t in MASK_TABLE_STRINGS:
        np.testing.assert_array_equal(tfont.rasterize_text(t), want[t], err_msg=t)


@pytest.mark.parametrize("row", range(0, len(LATIN1), 16))
def test_every_character_matches_aic_tpu(monkeypatch, row):
    assert_port_draws_as_aic_tpu(monkeypatch, LATIN1[row : row + 16])


@pytest.mark.parametrize("first", ASCII, ids=[f"U+{ord(c):04X}" for c in ASCII])
def test_every_ascii_pair_matches_aic_tpu(monkeypatch, first):
    assert_port_draws_as_aic_tpu(monkeypatch, [first + c for c in ASCII], resolutions=(16,))


@pytest.mark.parametrize("chunk", range(RANDOM_STRINGS // RANDOM_CHUNK))
def test_random_latin1_strings_match_aic_tpu(monkeypatch, chunk):
    assert_port_draws_as_aic_tpu(monkeypatch, random_latin1(chunk), resolutions=(16,))


@pytest.mark.parametrize("text", MULTILINE)
def test_multiline_and_runtime_strings_match_aic_tpu(monkeypatch, text):
    assert_port_draws_as_aic_tpu(monkeypatch, [text])


def test_string_not_in_table_raises_without_pil(no_pil):
    """A character outside the repertoire raises, naming the character;
    no other glyph stands in for it."""
    tfont.rasterize_text.cache_clear()
    for text, bad in (("arrow → right", "→"), ("tab\there", "\t"), ("‘q’", "‘")):
        with pytest.raises(tfont.TextNotInTable, match=f"U\\+{ord(bad):04X}"):
            tfont.rasterize_text(text)


def test_port_never_imports_pil_even_where_it_imports():
    """A fresh interpreter, where PIL can be imported, imports every module
    of the port but its glyph-table tool, draws text made at run time
    (a notification's title, a message's lines, every Latin-1 glyph) and
    builds a text block: PIL is never imported."""
    import importlib.util

    assert importlib.util.find_spec("PIL") is not None
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """
import pkgutil, sys, importlib
import aic_tpu_torch
for m in pkgutil.walk_packages(aic_tpu_torch.__path__, "aic_tpu_torch."):
    if m.name != "aic_tpu_torch.tools.pil_glyph_table":
        importlib.import_module(m.name)
from aic_tpu_torch.text import font
from aic_tpu_torch import block
font.rasterize_text("Saved world-" + str(len(sys.argv)) + ".json")
font.rasterize_text("Hello\\nworld ÿ")
font.rasterize_text("".join(chr(c) for c in range(0x20, 0x7f)) + "".join(chr(c) for c in range(0xa0, 0x100)))
block.evaluate(block.Block(block.TextPrimitive(text="OK 42", resolution=16, color=(1.0, 1.0, 1.0, 1.0))))
from aic_tpu_torch.text import layout
layout.FONT_BODY_TEXT.masks()
assert "PIL" not in sys.modules, sorted(k for k in sys.modules if k.startswith("PIL"))
print("no PIL")
"""
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("no PIL"), out.stderr[-3000:]


def test_atlas_decoded_without_pil_matches_aic_tpu(monkeypatch):
    """The zlib decode, with PIL hidden, against `aic_tpu`'s PIL decode of
    the same vendored PNG: RGBA equal, masks equal."""
    want = jsysfont.atlas_masks(jsysfont._VENDORED, 7, 16)
    from PIL import Image

    want_rgba = np.asarray(Image.open(jsysfont._VENDORED).convert("RGBA"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    tsysfont.atlas_masks.cache_clear()
    np.testing.assert_array_equal(tsysfont.read_png(tsysfont.ATLAS_PATH), want_rgba)
    got = tsysfont.atlas_masks(tsysfont.ATLAS_PATH, 7, 16)
    assert got.shape == want.shape == (192, 16, 7)
    np.testing.assert_array_equal(got, want)


def test_body_text_atlas_read_without_pil_matches_aic_tpu(monkeypatch):
    """The body-text font's vendored atlas, read with PIL hidden, against
    `aic_tpu`'s PIL drawing of it: every one of its 224 glyphs equal."""
    want = jlayout.FONT_BODY_TEXT.masks()
    monkeypatch.setitem(sys.modules, "PIL", None)
    tlayout.pil_atlas_masks.cache_clear()
    got = tlayout.FONT_BODY_TEXT.masks()
    assert got.shape == want.shape == (224, 14, 6)
    np.testing.assert_array_equal(got, want)


LAYOUTS = [
    ("AIC", "center", "body-middle", "back", False, ((0, 0, 0), (16, 16, 16))),
    ("Hello\nworld", "left", "body-top", "front", True, ((0, 0, 0), (48, 32, 4))),
    ("x = 1.5", "right", "baseline", "back", False, ((-8, -4, 0), (40, 20, 2))),
    ("Ünïcode ‘q’", "center", "body-bottom", "front", True, ((0, 0, 0), (96, 16, 3))),
]


@pytest.mark.parametrize("font_name", ["system16", "body-text"])
@pytest.mark.parametrize("case", LAYOUTS, ids=[c[0].split("\n")[0] for c in LAYOUTS])
def test_compute_layout_matches_aic_tpu(aic_system16, font_name, case):
    text, x, y, z, outline, (lo, size) = case
    jl = jlayout.compute_layout(text, jlayout.FONTS[font_name], outline, JGridAab.from_lower_size(lo, size),
                                jlayout.Positioning(x, y, z))
    tl = tlayout.compute_layout(text, tlayout.FONTS[font_name], outline, TGridAab.from_lower_size(lo, size),
                                tlayout.Positioning(x, y, z))
    assert tl.glyphs == jl.glyphs and tl.z == jl.z
    for k in ("logical_bounding_box", "rendering_bounding_box"):
        a, b = getattr(tl, k), getattr(jl, k)
        assert (a is None) == (b is None)
        if a is not None:
            assert (tuple(a.lower), tuple(a.upper)) == (tuple(b.lower), tuple(b.upper)), k


PRIMITIVES = [
    dict(text="AIC", resolution=16, color=(1.0, 1.0, 0.2, 1.0), tile=(0, 0)),
    dict(text="Transparency", resolution=16, color=(1.0, 1.0, 1.0, 1.0), tile=(1, 0)),
    dict(text="Smallest", resolution=8, color=(0.2, 0.4, 1.0, 1.0), tile=(2, 0), depth=3),
    dict(text="Hi", font="system16", resolution=16, color=(0.1, 0.1, 0.1, 1.0)),
    dict(text="Lit\nup", font="system16", resolution=16, color=(0.9, 0.2, 0.2, 1.0),
         positioning=("left", "body-top", "front"), layout_lower=(0, 0, 0), layout_size=(32, 32, 4),
         outline_color=(0.0, 0.0, 0.0, 1.0), tile=(0, 1)),
    dict(text="body", font="body-text", resolution=16, color=(0.2, 0.8, 0.2, 1.0)),
    dict(text="Sign 7", font="body-text", resolution=16, color=(1.0, 1.0, 1.0, 1.0),
         positioning=("right", "baseline", "back"), layout_lower=(-16, 0, 0), layout_size=(48, 16, 2),
         outline_color=(0.1, 0.1, 0.4, 1.0), tile=(-1, 0)),
]


@pytest.mark.parametrize("kw", PRIMITIVES, ids=[f"{p.get('font', 'pil')}-{p['text'][:6]}" for p in PRIMITIVES])
def test_text_primitive_voxels_match_aic_tpu(aic_system16, kw):
    """`evaluate(Block(TextPrimitive(...)))` no longer raises in the port,
    and its voxels equal `aic_tpu`'s."""
    want = jblock.evaluate(jblock.Block(jblock.TextPrimitive(**kw)))
    got = tblock.evaluate(tblock.Block(tblock.TextPrimitive(**kw)))
    assert got.resolution == want.resolution
    np.testing.assert_array_equal(got.voxels.color, want.voxels.color)
    np.testing.assert_array_equal(got.voxels.collision, want.voxels.collision)
    np.testing.assert_array_equal(np.asarray(got.color), np.asarray(want.color))
    assert bool((np.asarray(got.voxels.color)[..., 3] > 0).any())
