"""Layer 3: voxel UI widgets (port of `aic_tpu/vui`, its widgets only).

Widgets are voxel blocks drawn into a Space (the reference's `vui`
module, widget_trait.rs:58). The port has `widgets.py`, which the
exhibits draw with; the layout tree, pages, HUD and menu (`layout.py`,
`page.py`, `hud.py`) come with the frontends (ROADMAP A9).
"""

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

__all__ = [
    "Button",
    "Crosshair",
    "Frame",
    "Label",
    "ProgressBar",
    "Toolbar",
    "Tooltip",
    "text_blocks",
]
