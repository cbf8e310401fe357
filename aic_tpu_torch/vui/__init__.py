"""Layer 3: voxel UI framework (reference: all-is-cubes-ui/src/vui).

Port of `aic_tpu/vui`, exporting what it exports (and `text_blocks`).
Widgets are voxel blocks drawn into a dedicated UI `Space`, rendered by a
second camera layer and composited over the world frame — the same
"UI is made of cubes" architecture as the reference's `vui` module
(widget_trait.rs:58, layout.rs, vui_manager.rs): widgets draw into the
UI space on the host (content-time), and the HUD's controllers commit
the cells that changed into its device state.
"""

from .layout import Column, Leaf, Margin, Row, layout_size, realize
from .widgets import (
    Button,
    Crosshair,
    Frame,
    Label,
    ProgressBar,
    Toolbar,
    Tooltip,
    text_blocks,
)
from .hud import build_hud, main_menu_page, pause_page, ui_camera
from .page import (
    Page,
    PageStack,
    build_about_page,
    build_message_page,
    build_paused_page,
    build_progress_page,
    build_settings_page,
    cycle_setting,
)

__all__ = [
    "Page",
    "PageStack",
    "build_about_page",
    "build_message_page",
    "build_paused_page",
    "build_progress_page",
    "build_settings_page",
    "cycle_setting",
    "Button",
    "Column",
    "Crosshair",
    "Frame",
    "Label",
    "Leaf",
    "Margin",
    "ProgressBar",
    "Row",
    "Toolbar",
    "Tooltip",
    "build_hud",
    "layout_size",
    "main_menu_page",
    "pause_page",
    "realize",
    "text_blocks",
    "ui_camera",
]
