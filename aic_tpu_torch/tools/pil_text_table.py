#!/usr/bin/env python3
"""Write the port's table of text masks (`text/assets/pil_text_masks.json`).

    python3 aic_tpu_torch/tools/pil_text_table.py [--check]

`aic_tpu` rasterizes a `TextPrimitive`'s string with
`PIL.ImageFont.load_default()`, thresholded at 127 (`aic_tpu/text/
font.py:15`); with FreeType that is a vector font, which no glyph table
reproduces. The port reads the masks from this table instead, so it
needs no PIL where its content is built. This script records every
string the port's own content rasterizes, by running its builders with
`text.font.rasterize_text` wrapped:

- every template of `content.TEMPLATE_NAMES` at its default size but
  `fail` (which raises) and `plaza640` (the atrium's blocks, no text);
- every exhibit's standalone space, and the name sign of every exhibit
  (`Smallest` too, which demo-city leaves out);
- a `Tooltip` showing each tool class of `universe/cursor.py`;
- the voxel UI's fixed strings (`ui_strings`): the HUD, every page
  (paused, about, progress and message with nothing to show, settings
  with each setting at each of its values), the menu.

It then draws each string with PIL (`text.font.rasterize_pil`, a copy of
`aic_tpu`'s code) and writes the table, sorted. `--check` writes nothing
and fails if the table differs from what it would write. Needs PIL, and
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


class _Recording:
    """Within the block, every string `text.font.rasterize_text` is asked
    for is added to `seen`."""

    def __init__(self, seen: set):
        self.seen = seen

    def __enter__(self):
        from aic_tpu_torch.text import font

        self.inner = inner = font.rasterize_text

        def record(text):
            self.seen.add(text)
            return inner(text)

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true", help="compare, write nothing")
    args = ap.parse_args()
    import PIL

    from aic_tpu_torch.text import font

    strings = sorted(recorded_strings())
    table = {
        "font": f"PIL {PIL.__version__} ImageFont.load_default(), thresholded at 127, cropped",
        "masks": {s: font.encode_mask(font.rasterize_pil(s)) for s in strings},
    }
    text = json.dumps(table, indent=1, ensure_ascii=False, sort_keys=True) + "\n"
    if args.check:
        with open(font.TABLE_PATH) as f:
            same = json.load(f)["masks"] == table["masks"]
        print(f"{len(strings)} strings; table {'matches' if same else 'DIFFERS'}")
        sys.exit(0 if same else 1)
    with open(font.TABLE_PATH, "w") as f:
        f.write(text)
    print(f"wrote {len(strings)} strings to {font.TABLE_PATH}")


if __name__ == "__main__":
    main()
