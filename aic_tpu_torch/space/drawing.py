"""2.5D drawing adapter (reference: all-is-cubes/src/drawing.rs).

Copied unchanged from `aic_tpu/space/drawing.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

The reference adapts `embedded-graphics` `DrawTarget` onto Space
mutations with a `VoxelBrush` mapping each drawn pixel to a set of
(offset, block) pairs. Here the brush paints directly and `draw_points` /
`draw_rect` / `draw_text_line` cover the drawing surface the content
generators use.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..math.grid import GridAab


@dataclass(frozen=True)
class VoxelBrush:
    """drawing.rs:122 VoxelBrush: pixel → several blocks at offsets."""

    points: tuple  # ((dx, dy, dz), Block), ...

    @staticmethod
    def single(block) -> "VoxelBrush":
        return VoxelBrush((((0, 0, 0), block),))

    @staticmethod
    def column(block, height: int) -> "VoxelBrush":
        """A vertical run of `height` copies (common wall brush)."""
        return VoxelBrush(tuple(((0, dy, 0), block) for dy in range(height)))

    def translated(self, offset) -> "VoxelBrush":
        ox, oy, oz = offset
        return VoxelBrush(
            tuple(((dx + ox, dy + oy, dz + oz), b) for (dx, dy, dz), b in self.points)
        )

    def paint(self, space, cube) -> int:
        """Stamp the brush at `cube`; out-of-bounds offsets are skipped
        (drawing.rs draws clip at space bounds). Returns cubes written."""
        x, y, z = cube
        n = 0
        for (dx, dy, dz), b in self.points:
            c = (x + dx, y + dy, z + dz)
            if space.bounds.contains_cube(c):
                space.set(c, b)
                n += 1
        return n


def draw_points(space, brush: VoxelBrush, cubes) -> int:
    n = 0
    for c in cubes:
        n += brush.paint(space, c)
    return n


def draw_rect(space, brush: VoxelBrush, lower, size_xy, plane_z: int = 0) -> int:
    """Outline rectangle on an XY plane (embedded-graphics Rectangle)."""
    x0, y0 = lower
    w, h = size_xy
    n = 0
    for x in range(x0, x0 + w):
        n += brush.paint(space, (x, y0, plane_z))
        n += brush.paint(space, (x, y0 + h - 1, plane_z))
    for y in range(y0 + 1, y0 + h - 1):
        n += brush.paint(space, (x0, y, plane_z))
        n += brush.paint(space, (x0 + w - 1, y, plane_z))
    return n


def draw_text_line(space, text: str, lower, color=(1.0, 1.0, 1.0, 1.0)) -> int:
    """Draw a text line as Text blocks (drawing text via block/text)."""
    from ..vui.widgets import text_blocks

    x, y, z = lower
    blocks = text_blocks(text, color)
    for i, b in enumerate(blocks):
        if space.bounds.contains_cube((x + i, y, z)):
            space.set((x + i, y, z), b)
    return len(blocks)
