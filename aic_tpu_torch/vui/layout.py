"""Widget layout tree (reference: all-is-cubes-ui/src/vui/layout.rs).

Copied unchanged from `aic_tpu/vui/layout.py` (plain Python): the port carries its own
copy because `aic_tpu`'s package imports pull in JAX.

A `LayoutTree` arranges widgets on the UI space's XY plane (measured in
whole blocks, like the reference's cube-granularity layout): `Leaf` wraps
a widget, `Row`/`Column` stack children with a gap, `Margin` pads. The
tree is sized bottom-up (`layout_size`) and drawn top-down (`realize`),
which assigns each widget its lower-left block position.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence


@dataclass(frozen=True)
class Leaf:
    widget: object  # any object with .size() -> (w, h) and .draw(space, lower)


@dataclass(frozen=True)
class Row:
    children: Sequence[object]
    gap: int = 1


@dataclass(frozen=True)
class Column:
    children: Sequence[object]
    gap: int = 1


@dataclass(frozen=True)
class Margin:
    child: object
    margin: int = 1


def layout_size(node) -> tuple[int, int]:
    """(width, height) in blocks of a layout subtree."""
    if isinstance(node, Leaf):
        return node.widget.size()
    if isinstance(node, Margin):
        w, h = layout_size(node.child)
        return w + 2 * node.margin, h + 2 * node.margin
    if isinstance(node, Row):
        sizes = [layout_size(c) for c in node.children]
        w = sum(s[0] for s in sizes) + node.gap * max(len(sizes) - 1, 0)
        h = max((s[1] for s in sizes), default=0)
        return w, h
    if isinstance(node, Column):
        sizes = [layout_size(c) for c in node.children]
        w = max((s[0] for s in sizes), default=0)
        h = sum(s[1] for s in sizes) + node.gap * max(len(sizes) - 1, 0)
        return w, h
    raise TypeError(f"not a layout node: {node!r}")


def realize(node, space, lower: tuple[int, int, int]):
    """Draw the subtree into `space` with its lower-left-front corner at
    `lower` (x, y, z). Children are centered on the cross axis."""
    x, y, z = lower
    if isinstance(node, Leaf):
        node.widget.draw(space, (x, y, z))
        return
    if isinstance(node, Margin):
        realize(node.child, space, (x + node.margin, y + node.margin, z))
        return
    w, h = layout_size(node)
    if isinstance(node, Row):
        cx = x
        for c in node.children:
            cw, ch = layout_size(c)
            realize(c, space, (cx, y + (h - ch) // 2, z))
            cx += cw + node.gap
        return
    if isinstance(node, Column):
        # Top-to-bottom reading order: first child at the top.
        cy = y + h
        for c in node.children:
            cw, ch = layout_size(c)
            cy -= ch
            realize(c, space, (x + (w - cw) // 2, cy, z))
            cy -= node.gap
        return
    raise TypeError(f"not a layout node: {node!r}")
