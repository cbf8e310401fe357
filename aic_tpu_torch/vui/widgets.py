"""The widget library (reference: all-is-cubes-ui/src/vui/widgets/).

Copied unchanged from `aic_tpu/vui/widgets.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

Each widget measures itself in whole blocks (`size()`) and draws voxel
blocks into a UI space (`draw`). Visual style follows the reference's
drawn-voxel button/frame themes (widgets/theme.rs) in spirit: dark frame
blocks at the background layer (z = lower.z), icons/text one layer in
front (z + 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import block
from ..block.model import Block, BlockAttributes, TextPrimitive
from ..math.grid import GridAab
from ..text.font import text_tile_count

TEXT_RES = 16

FRAME_COLOR = (0.22, 0.22, 0.25, 1.0)
FRAME_HILIGHT = (0.9, 0.8, 0.3, 1.0)
BUTTON_COLOR = (0.35, 0.35, 0.4, 1.0)


def text_blocks(
    text: str, color=(1.0, 1.0, 1.0, 1.0), resolution: int = TEXT_RES
) -> list[Block]:
    """One Text block per horizontal tile of the laid-out string."""
    n = text_tile_count(text, resolution)
    return [
        Block(
            TextPrimitive(text=text, resolution=resolution, color=color, tile=(i, 0)),
            BlockAttributes(display_name=f"text[{text!r}:{i}]"),
        )
        for i in range(n)
    ]


def _voxel_block(mask: np.ndarray, color, name: str) -> Block:
    """A resolution-R block from a bool[x, y] mask (depth-1 glyph slab),
    built through a scratch Space + Recur like any recursive block."""
    from ..space.space import Space

    r = mask.shape[0]
    sp = Space(GridAab.cube(r))
    b = block.from_color(color, display_name=name + "-voxel")
    for x in range(r):
        for y in range(r):
            if mask[x, y]:
                sp.set((x, y, 0), b)
    return Block(block.Recur(sp, resolution=r), BlockAttributes(display_name=name))


@dataclass
class Label:
    """Text line (widgets text label; text rendered per text/font.py)."""

    text: str
    color: tuple = (1.0, 1.0, 1.0, 1.0)

    def size(self):
        return text_tile_count(self.text, TEXT_RES), 1

    def draw(self, space, lower):
        x, y, z = lower
        for i, b in enumerate(text_blocks(self.text, self.color)):
            space.set((x + i, y, z), b)


@dataclass
class Frame:
    """Plain filled background region (widgets/frame.rs)."""

    width: int
    height: int
    color: tuple = FRAME_COLOR

    def size(self):
        return self.width, self.height

    def draw(self, space, lower):
        x, y, z = lower
        space.fill(
            GridAab.from_lower_size((x, y, z), (self.width, self.height, 1)),
            block.from_color(self.color, display_name="frame"),
        )


@dataclass
class Button:
    """Push button: background slab + label (widgets/button.rs). The
    `action` is invoked by Session click dispatch when the cursor hits
    any of the button's blocks (activation_action analog)."""

    text: str
    action: Optional[object] = None
    color: tuple = BUTTON_COLOR

    def size(self):
        return text_tile_count(self.text, TEXT_RES) + 2, 1

    def draw(self, space, lower):
        x, y, z = lower
        w, h = self.size()
        region = GridAab.from_lower_size((x, y, z), (w, h, 2))
        space.fill(
            GridAab.from_lower_size((x, y, z), (w, h, 1)),
            block.from_color(self.color, display_name=f"button[{self.text}]"),
        )
        for i, b in enumerate(text_blocks(self.text)):
            space.set((x + 1 + i, y, z + 1), b)
        # Register the activation region (vui_manager click dispatch).
        if self.action is not None:
            if not hasattr(space, "ui_actions"):
                space.ui_actions = []
            space.ui_actions.append((region, self.action))


@dataclass
class Crosshair:
    """Center-of-view crosshair (widgets crosshair), one voxel block."""

    color: tuple = (1.0, 1.0, 1.0, 0.9)

    def size(self):
        return 1, 1

    def draw(self, space, lower):
        r = 16
        mask = np.zeros((r, r), bool)
        mid = r // 2
        mask[mid - 1 : mid + 1, mid - 5 : mid + 5] = True
        mask[mid - 5 : mid + 5, mid - 1 : mid + 1] = True
        space.set(lower, _voxel_block(mask, self.color, "crosshair"))


@dataclass
class Toolbar:
    """Inventory toolbar (widgets/toolbar.rs): one slot frame per tool,
    tool icon inside, selected slot highlighted."""

    inventory: object  # universe.cursor.Inventory
    slots: int = 10

    def size(self):
        return self.slots, 1

    def icon_block(self, tool) -> Optional[Block]:
        from ..universe.cursor import Activate, CopyFromSpace, PlaceBlock, RemoveBlock, Stack

        if isinstance(tool, Stack):
            tool = tool.tool if tool.count > 0 else None
        if tool is None:
            return None
        if isinstance(tool, PlaceBlock):
            return tool.block
        if isinstance(tool, RemoveBlock):
            return block.from_color((0.9, 0.3, 0.2, 1.0), display_name="icon-remove")
        if isinstance(tool, Activate):
            return block.from_color((0.3, 0.9, 0.3, 1.0), display_name="icon-activate")
        if isinstance(tool, CopyFromSpace):
            return block.from_color((0.3, 0.5, 0.9, 1.0), display_name="icon-copy")
        return block.from_color((0.7, 0.7, 0.7, 1.0), display_name="icon-tool")

    def draw(self, space, lower):
        x, y, z = lower
        inv = self.inventory
        for s in range(self.slots):
            selected = s == inv.selected
            frame_color = FRAME_HILIGHT if selected else FRAME_COLOR
            space.set(
                (x + s, y, z), block.from_color(frame_color, display_name="slot")
            )
            tool = inv.slots[s] if s < len(inv.slots) else None
            icon = self.icon_block(tool)
            if icon is not None:
                space.set((x + s, y, z + 1), icon)


@dataclass
class Tooltip:
    """Text readout above the toolbar (widgets/tooltip.rs): shows the
    selected tool's name; redraw() updates in place."""

    inventory: object
    width: int = 10

    def size(self):
        return self.width, 1

    def current_text(self) -> str:
        tool = self.inventory.selected_tool()
        return type(tool).__name__ if tool is not None else ""

    def draw(self, space, lower):
        x, y, z = lower
        space.fill(
            GridAab.from_lower_size((x, y, z), (self.width, 1, 1)), block.AIR
        )
        txt = self.current_text()
        if txt:
            for i, b in enumerate(text_blocks(txt)[: self.width]):
                space.set((x + i, y, z), b)


@dataclass
class ProgressBar:
    """Progress readout (widgets/progress_bar.rs)."""

    fraction: float
    width: int = 8

    def size(self):
        return self.width, 1

    def draw(self, space, lower):
        x, y, z = lower
        filled = int(round(np.clip(self.fraction, 0.0, 1.0) * self.width))
        for i in range(self.width):
            c = (0.2, 0.8, 0.3, 1.0) if i < filled else (0.15, 0.15, 0.18, 1.0)
            space.set((x + i, y, z), block.from_color(c, display_name="progress"))
