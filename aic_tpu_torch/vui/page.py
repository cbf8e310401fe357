"""UI pages and page navigation (reference: all-is-cubes-ui/src/vui/page.rs,
ui_content/pages.rs:26-235, ui_content/settings.rs).

Port of `aic_tpu/vui/page.py`; the page copy (`ABOUT_TEXT`,
`CONTROLS_TEXT`, titles, button names) is `aic_tpu`'s, string for string,
so the two packages build equal page spaces. A page's snapshot lands on
the page's device (the card unless the caller asks for the CPU) and is
cached: the K1 trace tables are cached per snapshot, so a page that is
shown frame after frame builds its tables once.

The reference models the VUI as a state machine over `VuiPageState`
(Hud / Paused / Settings / AboutText / Progress / Dumb-message) with a
`back()` stack; each state owns a widget-tree page rendered as its own
Space layered over the world. This module is the same shape on our
widget/layout substrate:

- `Page`: one built page — a UI `Space`, its cached device snapshot and
  a framing camera (made per viewport).
- `PageStack`: the navigation state machine (vui_manager.rs
  `set_state`/`back`): `open(id)` pushes, `back()` pops, `current()`
  returns the visible page (None = plain HUD).
- Builders for the reference's page set: paused (pages.rs:26, with
  About/Settings/Quit — the open-page buttons of pages.rs:235),
  settings (pages.rs:152 + settings.rs widget list, bound to the
  session's `Settings` store), about (pages.rs:173: controls +
  project text), progress (pages.rs:101, bound to the notification
  hub), and message (pages.rs:223).

Pages are plain voxel spaces, so they render through the ordinary UI
raytrace layer — no separate UI rasterizer (SURVEY §2.6 deviation).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .hud import _ui_space, ui_camera
from .layout import Column, Leaf, layout_size, realize
from .widgets import Button, Label, ProgressBar

#: Reference pages.rs:173 about-page copy, adapted to this build.
ABOUT_TEXT = [
    "All is Cubes (TPU edition)",
    "a voxel world engine re-designed",
    "for TPU hardware: JAX + Pallas.",
    "",
    "github.com/kpreid/all-is-cubes",
    "is the reference behavior spec.",
]

CONTROLS_TEXT = [
    "W A S D   movement",
    "  E C     fly up/down",
    "Arrows    turn",
    "   L      toggle mouselook",
    "  0-9     select toolbar item",
    "L-mouse   use first tool",
    "R-mouse   use selected tool",
    "   P      toggle pause",
    "Escape    back / pause",
]

#: The settings shown on the settings page and the value cycle a click
#: advances through (settings.rs graphics widgets; enum fields cycle,
#: bool fields toggle).
SETTING_CYCLES: dict[str, tuple] = {
    "lighting_display": ("none", "flat", "smoothstep", "linear"),
    "fog": ("none", "abrupt", "compromise", "physical"),
    "transparency": ("surface", "volumetric", "threshold"),
    "antialiasing": (False, True),
    "show_ui": (True, False),
    "debug_info_text": (True, False),
    "bloom_intensity": (0.0, 0.125, 0.25),
}


def cycle_setting(settings, name: str):
    """Advance one settings field to its next value (the toggle-button
    click semantics of settings.rs) and persist through the store."""
    cycle = SETTING_CYCLES[name]
    cur = getattr(settings.graphics_options(), name)
    try:
        i = cycle.index(cur)
    except ValueError:
        i = -1
    settings.set(**{name: cycle[(i + 1) % len(cycle)]})


@dataclasses.dataclass
class Page:
    """One built page: its space + snapshot on `device`, taken once;
    camera is made per viewport."""

    id: str
    space: object
    state: object = None
    device: object = "cuda"

    def snapshot(self):
        if self.state is None:
            self.state = self.space.snapshot(device=self.device)
        return self.state

    def camera(self, viewport):
        return ui_camera(self.space, viewport)


def _page_space(tree, title: Optional[str] = None, min_w: int = 24, min_h: int = 14):
    """Lay a widget tree into a fresh page space, centered, with an
    optional title line (Page::new_modal_dialog's title slot)."""
    if title:
        tree = Column([Leaf(Label(title, color=(1.0, 1.0, 0.6, 1.0))), tree])
    w, h = layout_size(tree)
    width, height = max(min_w, w + 2), max(min_h, h + 2)
    space = _ui_space(width, height)
    realize(tree, space, ((width - w) // 2, (height - h) // 2, 0))
    return space


def build_paused_page() -> Page:
    """pages.rs:26 new_paused_page: logo, About, Settings, resume, quit."""
    tree = Column(
        [
            Leaf(Button("Resume", action="resume")),
            Leaf(Button("About", action=("open", "about"))),
            Leaf(Button("Settings", action=("open", "settings"))),
            Leaf(Button("Quit", action="quit")),
        ]
    )
    return Page("paused", _page_space(tree, title="Paused"))


def build_settings_page(settings) -> Page:
    """pages.rs:152 new_settings_page_widget_tree: one labeled toggle per
    graphics setting, current value shown in the label; plus Back."""
    opts = settings.graphics_options()
    rows = [
        Leaf(
            Button(
                f"{name}: {getattr(opts, name)}",
                action=("setting", name),
            )
        )
        for name in SETTING_CYCLES
    ]
    rows.append(Leaf(Button("Back", action="back")))
    return Page("settings", _page_space(Column(rows, gap=0), title="Settings"))


def build_about_page() -> Page:
    """pages.rs:173 new_about_page: controls listing + about paragraph."""
    tree = Column(
        [Leaf(Label("Controls", color=(0.7, 1.0, 0.7, 1.0)))]
        + [Leaf(Label(line)) for line in CONTROLS_TEXT if line]
        + [Leaf(Label("About", color=(0.7, 1.0, 0.7, 1.0)))]
        + [Leaf(Label(line)) for line in ABOUT_TEXT if line]
        + [Leaf(Button("Back", action="back"))],
        gap=0,
    )
    return Page("about", _page_space(tree, title="About All is Cubes"))


def build_progress_page(hub) -> Page:
    """pages.rs:101 new_progress_page: primary notification title, bar,
    and part line, frozen at build time (the stack rebuilds the page when
    the hub's primary fingerprint changes — vui_manager page refresh)."""
    content = hub.primary() if hub is not None else None
    title = content.title if content is not None else ""
    fraction = content.fraction if content is not None else 0.0
    part = content.part if content is not None else ""
    tree = Column(
        [
            Leaf(Label(title or " ")),
            Leaf(ProgressBar(fraction=fraction, width=10)),
            Leaf(Label(part or " ")),
            Leaf(Button("Back", action="back")),
        ]
    )
    return Page("progress", _page_space(tree, title="Progress"))


def build_message_page(message: str) -> Page:
    """pages.rs:223 new_message_page: a modal paragraph + Back."""
    lines = [ln for ln in message.split("\n")] or [""]
    tree = Column(
        [Leaf(Label(ln or " ")) for ln in lines]
        + [Leaf(Button("Back", action="back"))],
        gap=0,
    )
    return Page("message", _page_space(tree))


class PageStack:
    """VuiPageState navigation (vui_manager.rs set_state / back()).

    The stack holds page ids; pages are built on demand by the factories
    (bound to session stores), snapshotted on `device` and cached until
    `invalidate()`. An empty stack means the plain HUD is visible.
    """

    def __init__(
        self,
        settings=None,
        notifications=None,
        device="cuda",
    ):
        self.settings = settings
        self.notifications = notifications
        self.device = device
        self._stack: list[str] = []
        self._cache: dict[str, Page] = {}
        self._message: str = ""

    # -- building -----------------------------------------------------------

    def _build(self, page_id: str) -> Page:
        if page_id == "paused":
            return build_paused_page()
        if page_id == "settings":
            return build_settings_page(self.settings)
        if page_id == "about":
            return build_about_page()
        if page_id == "progress":
            return build_progress_page(self.notifications)
        if page_id == "message":
            return build_message_page(self._message)
        raise KeyError(f"unknown page {page_id!r}")

    def page(self, page_id: str) -> Page:
        p = self._cache.get(page_id)
        if p is None:
            p = self._build(page_id)
            p.device = self.device
            self._cache[page_id] = p
        return p

    def invalidate(self, page_id: Optional[str] = None):
        """Drop cached builds (a setting changed, the notification moved
        on) so the next frame re-renders the page (page refresh analog)."""
        if page_id is None:
            self._cache.clear()
        else:
            self._cache.pop(page_id, None)

    # -- navigation ---------------------------------------------------------

    def open(self, page_id: str, message: str = ""):
        """Push a page (VuiMessage::Open). Re-opening the top is a no-op."""
        if page_id == "message":
            self._message = message
            self.invalidate("message")
        if self._stack and self._stack[-1] == page_id:
            return
        if page_id in self._stack:
            self._stack.remove(page_id)
        self._stack.append(page_id)

    def back(self) -> bool:
        """Pop the top page (page.rs back()); False when already at HUD."""
        if not self._stack:
            return False
        self._stack.pop()
        return True

    def clear(self):
        self._stack.clear()

    def current(self) -> Optional[Page]:
        return self.page(self._stack[-1]) if self._stack else None

    @property
    def depth(self) -> int:
        return len(self._stack)
