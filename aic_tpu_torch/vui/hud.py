"""HUD assembly + UI pages (reference: vui/vui_manager.rs, vui/page.rs).

Port of `aic_tpu/vui/hud.py`. `build_hud` lays the session HUD (toolbar,
tooltip, crosshair) into a fresh UI Space; `pause_page` /
`main_menu_page` build menu pages of buttons. `ui_camera` frames the
whole UI plane for the second render layer (HudLayout camera of the
reference); `composite_over` lays the UI layer's traced light over the
world's, on the layers' device.
"""

from __future__ import annotations

import numpy as np

from ..math.grid import GridAab
from ..raytrace import Camera, GraphicsOptions, Viewport
from ..space.sky import Sky
from ..space.space import Space, SpacePhysics
from .layout import Column, Leaf, layout_size, realize
from .widgets import Button, Crosshair, Label, Toolbar, Tooltip

UI_DEPTH = 3


def _ui_space(width: int, height: int) -> Space:
    """An unlit UI space (the reference's HUD space uses no light physics;
    UI layers render with lighting off)."""
    return Space(
        GridAab.from_lower_size((0, 0, 0), (width, height, UI_DEPTH)),
        physics=SpacePhysics(sky=Sky.uniform((0.0, 0.0, 0.0)), light_enabled=False),
    )


def build_hud(inventory, width: int = 24, height: int = 14):
    """The session HUD (vui_manager.rs HudLayout): toolbar bottom-center,
    tooltip above it, crosshair dead center. Returns (space, widgets dict)
    — widgets are kept so the session can redraw dynamic ones."""
    space = _ui_space(width, height)
    toolbar = Toolbar(inventory)
    tooltip = Tooltip(inventory, width=toolbar.slots)
    crosshair = Crosshair()

    tw, th = toolbar.size()
    tx = (width - tw) // 2
    toolbar.draw(space, (tx, 0, 0))
    tooltip.draw(space, (tx, 1, 0))
    crosshair.draw(space, (width // 2, height // 2, 1))
    return space, dict(toolbar=toolbar, tooltip=tooltip, crosshair=crosshair, tx=tx)


def pause_page(width: int = 24, height: int = 14) -> Space:
    """The paused-state page (vui pages): dimmed title + resume/quit."""
    space = _ui_space(width, height)
    tree = Column(
        [
            Leaf(Label("Paused", color=(1.0, 1.0, 0.6, 1.0))),
            Leaf(Button("Resume", action="resume")),
            Leaf(Button("Quit", action="quit")),
        ]
    )
    w, h = layout_size(tree)
    realize(tree, space, ((width - w) // 2, (height - h) // 2, 0))
    return space


#: The main menu's title, `aic_tpu`'s string, so the two menus' spaces
#: are equal.
MENU_TITLE = "All is Cubes (TPU)"


def main_menu_page(templates: list[str], width: int = 30, height: int = 18) -> Space:
    """The main menu (UniverseTemplate::Menu, template.rs:82): a button
    per world template. The page grows to fit its content."""
    tree = Column(
        [Leaf(Label(MENU_TITLE, color=(0.6, 0.9, 1.0, 1.0)))]
        + [Leaf(Button(t, action=("template", t))) for t in templates]
    )
    w, h = layout_size(tree)
    width = max(width, w + 2)
    height = max(height, h + 2)
    space = _ui_space(width, height)
    realize(tree, space, ((width - w) // 2, (height - h) // 2, 0))
    return space


def ui_camera(space: Space, viewport: Viewport) -> Camera:
    """A camera framing the whole UI plane (the reference's HUD camera,
    vui_manager.rs): perspective, centered, lighting/fog off."""
    opts = GraphicsOptions(lighting_display="none", fog="none", transparency="surface")
    cam = Camera(opts, viewport)
    size = space.bounds.size
    cx = space.bounds.lower[0] + size[0] / 2.0
    cy = space.bounds.lower[1] + size[1] / 2.0
    half_h = size[1] / 2.0
    half_w = size[0] / 2.0
    aspect = viewport.width / viewport.height
    fov = np.radians(opts.fov_y)
    # Distance so the UI height (or width/aspect, whichever binds) fits.
    dist = max(half_h, half_w / aspect) / np.tan(fov / 2.0)
    eye = (cx, cy, space.bounds.upper[2] + dist)
    cam.look_at(eye, (cx, cy, space.bounds.lower[2]))
    return cam


def composite_over(ui_light, ui_trans, world_light, world_trans):
    """Premultiplied front-to-back OVER of the UI layer on the world
    (Layers compositing, renderer.rs:424), on the layers' device:
    light f32[H,W,3], transmittance f32[H,W]."""
    light = ui_light + world_light * ui_trans[..., None]
    trans = ui_trans * world_trans
    return light, trans
