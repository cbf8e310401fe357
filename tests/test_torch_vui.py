"""The port's voxel UI (aic_tpu_torch.vui: layout, HUD, pages, menu,
controllers, notifications) against `aic_tpu`'s, on the CPU.

UI spaces are compared as arrays, without rendering them: bounds,
contents, light and the palette entry by entry, evaluated the same
(tests/test_torch_content.py's `assert_spaces_equal`), and the click
regions with their actions equal. The port composes its text from the
vendored glyph table (`table_only`), free-form notification titles
included. Layout trees are seeded with
numpy. Nothing here has a tolerance: everything compared is exact.
"""

import dataclasses

import numpy as np
import pytest

import aic_tpu.content as jc
import aic_tpu.vui as jvui
import aic_tpu_torch.content as tc
import aic_tpu_torch.vui as tvui
from aic_tpu.apps.settings import Settings as JSettings
from aic_tpu.text import font as jfont
from aic_tpu.universe import cursor as jcursor
from aic_tpu.vui import controller as jcontroller
from aic_tpu.vui import notification as jnote
from aic_tpu.vui import page as jpage
from aic_tpu_torch.apps.settings import Settings as TSettings
from aic_tpu_torch.text import font as tfont
from aic_tpu_torch.tools.pil_glyph_table import setting_values, ui_strings
from aic_tpu_torch.universe import cursor as tcursor
from aic_tpu_torch.vui import controller as tcontroller
from aic_tpu_torch.vui import notification as tnote
from aic_tpu_torch.vui import page as tpage
from test_torch_content import assert_spaces_equal, table_only  # noqa: F401 (fixture)
from test_torch_state import PKGS

PK = {"jax": (PKGS["jax"], jvui, jpage, jcursor, JSettings), "torch": (PKGS["torch"], tvui, tpage, tcursor, TSettings)}


def assert_ui_equal(js, ts):
    assert_spaces_equal(js, ts, snapshot=False)
    want = [(tuple(r.lower), tuple(r.upper), a) for r, a in getattr(js, "ui_actions", [])]
    got = [(tuple(r.lower), tuple(r.upper), a) for r, a in getattr(ts, "ui_actions", [])]
    assert got == want


# -- layout ------------------------------------------------------------------

#: Label strings of the UI pages.
WORDS = ["Resume", "About", "Settings", "Quit", "Back", "Paused", "Controls"]


def random_tree(pkg, rng, depth=0):
    """A seeded layout tree of Frames, Labels, Rows, Columns and Margins."""
    _p, vui, *_ = PK[pkg]
    kind = rng.integers(0, 5) if depth < 3 else rng.integers(0, 2)
    if kind == 0:
        w, h = (int(v) for v in rng.integers(1, 4, 2))
        color = tuple(float(c) for c in rng.uniform(0, 1, 3)) + (1.0,)
        return vui.Leaf(vui.Frame(w, h, color))
    if kind == 1:
        return vui.Leaf(vui.Label(WORDS[int(rng.integers(0, len(WORDS)))]))
    if kind == 4:
        return vui.Margin(random_tree(pkg, rng, depth + 1), margin=int(rng.integers(0, 3)))
    children = [random_tree(pkg, rng, depth + 1) for _ in range(int(rng.integers(1, 4)))]
    node = vui.Row if kind == 2 else vui.Column
    return node(children, gap=int(rng.integers(0, 3)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_layout_size_and_realize_match_aic_tpu(table_only, seed):
    spaces = {}
    for pkg in ("jax", "torch"):
        p, vui, *_ = PK[pkg]
        tree = random_tree(pkg, np.random.default_rng(seed))
        w, h = vui.layout_size(tree)
        sp = p.Space(p.GridAab.from_lower_size((0, 0, 0), (w + 2, h + 2, 3)))
        vui.realize(tree, sp, (1, 1, 0))
        spaces[pkg] = ((w, h), sp)
    assert spaces["torch"][0] == spaces["jax"][0]
    assert_ui_equal(spaces["jax"][1], spaces["torch"][1])


# -- HUD, pages, menu --------------------------------------------------------


def _pages(pkg):
    p, vui, page, cursor, Settings = PK[pkg]
    out = {
        "hud": vui.build_hud(cursor.free_editing_inventory())[0],
        "pause_page": vui.pause_page(),
        "paused": page.build_paused_page().space,
        "about": page.build_about_page().space,
        "progress": page.build_progress_page(None).space,
        "message": page.build_message_page("").space,
        "settings": page.build_settings_page(Settings()).space,
    }
    s = Settings()
    for name in page.SETTING_CYCLES:
        page.cycle_setting(s, name)
    out["settings, every setting cycled"] = page.build_settings_page(s).space
    return out


def test_hud_and_pages_match_aic_tpu(table_only):
    want, got = _pages("jax"), _pages("torch")
    assert list(got) == list(want)
    for name in want:
        assert_ui_equal(want[name], got[name])


def test_menu_template_matches_aic_tpu(table_only):
    js = jc.build_template_space("menu", jc.TemplateParameters())
    ts = tc.build_template_space("menu", tc.TemplateParameters())
    assert_ui_equal(js, ts)


def test_cycle_setting_matches_aic_tpu():
    """Every setting cycled past its whole cycle: the same options."""
    stores = {pkg: PK[pkg][4]() for pkg in PK}
    for name, cycle in tpage.SETTING_CYCLES.items():
        for _ in range(len(cycle) + 1):
            for pkg, store in stores.items():
                PK[pkg][2].cycle_setting(store, name)
            j, t = stores["jax"].graphics_options(), stores["torch"].graphics_options()
            assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_page_stack_snapshots_once_on_its_device():
    """A page's snapshot is taken once, on the stack's device, and kept
    until the page is invalidated (the K1 tables are cached per
    snapshot)."""
    stack = tpage.PageStack(settings=TSettings(), device="cpu")
    stack.open("paused")
    page = stack.current()
    st = page.snapshot()
    assert st.contents.device.type == "cpu" and page.snapshot() is st
    stack.open("settings")
    stack.invalidate("settings")
    assert stack.back() and stack.current() is page and page.snapshot() is st


# -- the HUD's controllers ------------------------------------------------------


def describe(txn):
    """A transaction as sorted (cube, new block's name and primitive)."""
    if txn is None:
        return None
    return sorted((tuple(int(v) for v in cube), e.new.attributes.display_name, type(e.new.primitive).__name__,
                   tuple(getattr(e.new.primitive, "color", ()))) for cube, e in txn.cubes.items())


def _hud_run(pkg):
    """The same sequence of inventory and notification changes through
    each package's HudController: per step, whether it committed, each
    controller's transaction, and the UI state's contents."""
    p, vui, page, cursor, _ = PK[pkg]
    ctl = jcontroller if pkg == "jax" else tcontroller
    note = jnote if pkg == "jax" else tnote
    inv = cursor.free_editing_inventory()
    hub = note.NotificationHub()
    hud = ctl.HudController(inv, hub) if pkg == "jax" else ctl.HudController(inv, hub, device="cpu")
    txns = []
    for c in hud.controllers:
        def recorded(session, c=c, real=c.step):
            t = real(session)
            txns.append(describe(t))
            return t
        c.step = recorded
    out = []
    held = []

    def step():
        txns.clear()
        committed = hud.step()
        out.append((committed, list(txns), np.asarray(hud.state.contents).copy(), hud.space.palette_len()))

    step()
    inv.selected = 2
    step()
    held.append(hub.show(note.ProgressContent("Loading", 0.25, "spaces")))
    step()
    held[0].set_content(note.ProgressContent("Loading", 0.75, "light"))
    step()
    inv.add(cursor.PlaceBlock(p.block.from_color((0.2, 0.7, 0.3, 1.0), "green")))
    inv.selected = len(inv.slots) - 1
    step()
    held[0].dismiss()
    step()
    step()
    return out, hud


def test_hud_controller_matches_aic_tpu():
    want, jhud = _hud_run("jax")
    got, thud = _hud_run("torch")
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0] and g[1] == w[1], i
        np.testing.assert_array_equal(g[2].astype(np.int32), w[2].astype(np.int32), err_msg=f"step {i}")
        assert g[3] == w[3], i
    assert_spaces_equal(jhud.space, thud.space, snapshot=False)


def test_widget_controller_transactions_match_aic_tpu(table_only):
    """A toolbar controller's transactions after each selection: the
    same cubes, each set to an equal block."""
    txns = {}
    for pkg in ("jax", "torch"):
        p, vui, page, cursor, _ = PK[pkg]
        ctl = jcontroller if pkg == "jax" else tcontroller
        inv = cursor.free_editing_inventory()
        toolbar = vui.Toolbar(inv)
        c = ctl.WidgetController(toolbar, (2, 0, 0), lambda _s, inv=inv: (inv.selected,))
        seq = []
        for sel in (0, 0, 3, 1):
            inv.selected = sel
            seq.append(describe(c.step(None)))
        txns[pkg] = seq
    assert txns["torch"] == txns["jax"]
    assert txns["torch"][1] is None and txns["torch"][0] and txns["torch"][2]


# -- notifications ----------------------------------------------------------------


def test_notification_hub_matches_aic_tpu():
    """Weak handles: the primary is the oldest live one; a dropped or
    dismissed handle leaves; overflow at LIMIT."""
    out = {}
    for name, note in (("jax", jnote), ("torch", tnote)):
        hub = note.NotificationHub()
        a = hub.show(note.ProgressContent("a", 0.1))
        b = hub.show(note.ProgressContent("b", 0.2, "x"))
        seq = [hub.count(), hub.primary()]
        del a
        seq += [hub.count(), hub.primary()]
        b.dismiss()
        seq += [hub.count(), hub.primary()]
        keep = [hub.show(note.ProgressContent(str(i), 0.0)) for i in range(hub.LIMIT)]
        with pytest.raises(OverflowError):
            hub.show(note.ProgressContent("over", 0.0))
        seq += [hub.count(), len(keep)]
        out[name] = [(x.title, x.fraction, x.part) if hasattr(x, "title") else x for x in seq]
    assert out["torch"] == out["jax"]


# -- text ------------------------------------------------------------------


def test_fixed_ui_strings_are_in_the_table_as_aic_tpu_draws_them(monkeypatch):
    """Every fixed string the HUD, the pages (each setting at each of its
    values), the tooltips and the menu draw is made of the glyph table's
    characters, and its mask, composed with PIL blocked, is `aic_tpu`'s
    PIL drawing of it, bit for bit."""
    import sys

    strings = ui_strings()
    assert {"Paused", "Resume", "Settings", "About All is Cubes", "Back", tvui.hud.MENU_TITLE} <= strings
    for name in tpage.SETTING_CYCLES:
        for v in setting_values(name):
            assert f"{name}: {v}" in strings
    for line in tpage.ABOUT_TEXT + tpage.CONTROLS_TEXT:
        if line:
            assert line in strings
    missing = sorted(set("".join(strings)) - set(tfont.glyph_table().glyphs))
    assert not missing, missing
    want = {s: jfont.rasterize_text(s) for s in strings}
    monkeypatch.setitem(sys.modules, "PIL", None)
    tfont.rasterize_text.cache_clear()
    for s in sorted(strings):
        np.testing.assert_array_equal(tfont.rasterize_text(s), want[s], err_msg=repr(s))
