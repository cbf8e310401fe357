"""The port's text modules (aic_tpu_torch.text) against `aic_tpu.text`.

- `rasterize_text`, `text_tile` and `text_tile_count` for every string of
  the port's vendored mask table: equal to `aic_tpu`'s, which draws them
  with PIL here.
- The system-16 atlas decoded with zlib (no imaging library) against
  `aic_tpu`'s PIL decode of the same file: equal.
- `compute_layout` and the voxels of `evaluate(Block(TextPrimitive))` for
  the `pil`, `system16` and `body-text` fonts: equal. `aic_tpu` reads its
  system-16 atlas from a reference checkout and, where that is absent,
  draws PIL's default font instead; the port reads its vendored copy of
  that atlas, so `aic_tpu` is given the same file here (its `FONTS` entry
  pointed at `aic_tpu/text/assets/`, as with the checkout present). The
  body-text atlas is vendored by neither: both packages draw PIL's glyphs.
- A string outside the table raises, naming it, when PIL cannot be
  imported.
"""

import json
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

with open(tfont.TABLE_PATH) as f:
    TABLE_STRINGS = sorted(json.load(f)["masks"])


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
    assert {e.name for e in EXHIBITS} | {"AIC", "OK"} <= set(TABLE_STRINGS)


@pytest.mark.parametrize("text", TABLE_STRINGS)
def test_rasterize_and_tiles_match_aic_tpu(text):
    want = jfont.rasterize_text(text)
    got = tfont.rasterize_text(text)
    np.testing.assert_array_equal(got, want)
    for res in (8, 16, 32):
        n = jfont.text_tile_count(text, res)
        assert tfont.text_tile_count(text, res) == n
        assert tfont.measure_text(text) == jfont.measure_text(text)
        for tx in range(n + 1):
            np.testing.assert_array_equal(tfont.text_tile(text, res, (tx, 0)), jfont.text_tile(text, res, (tx, 0)))


def test_table_masks_are_read_without_pil(monkeypatch):
    """With PIL hidden, every table string still rasterizes, to the same
    mask as `aic_tpu`'s (drawn before PIL was hidden)."""
    want = {t: jfont.rasterize_text(t) for t in TABLE_STRINGS}
    monkeypatch.setitem(sys.modules, "PIL", None)
    tfont.rasterize_text.cache_clear()
    for t in TABLE_STRINGS:
        np.testing.assert_array_equal(tfont.rasterize_text(t), want[t], err_msg=t)


def test_string_not_in_table_raises_without_pil(no_pil):
    text = "not in the table æ"
    assert text not in TABLE_STRINGS
    with pytest.raises(tfont.TextNotInTable, match="not in the table"):
        tfont.rasterize_text(text)


def test_string_not_in_table_is_drawn_with_pil_where_it_imports():
    text = "Drawn by PIL 42"
    assert text not in TABLE_STRINGS
    np.testing.assert_array_equal(tfont.rasterize_text(text), jfont.rasterize_text(text))


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
