"""Cornell box template (reference: all-is-cubes-content/src/template.rs:396).

Copied unchanged from `aic_tpu/content/cornell.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

The canonical enclosed GI test scene: white floor/ceiling/back, red left
wall, green right wall, emissive ceiling panel, two white boxes, zero sky.
"""

from __future__ import annotations

import numpy as np

from ..block import Block, BlockAttributes, Atom, from_color
from ..math.grid import GridAab
from ..space import Sky, Space, SpacePhysics


def _scaled_box(lower, size, box_size: int) -> GridAab:
    """template.rs GridAab .multiply(box_size).divide(55) pattern."""
    lo = [c * box_size // 55 for c in lower]
    up = [(l + s) * box_size // 55 for l, s in zip(lower, size)]
    return GridAab.from_lower_upper(lo, [max(u, l + 1) for l, u in zip(lo, up)])


def cornell_box(box_size: int = 32) -> Space:
    box_size = min(box_size, 64)
    bounds = GridAab.from_lower_size((-1, -1, -1), (box_size + 2,) * 3)
    space = Space(
        bounds,
        physics=SpacePhysics(
            sky=Sky.uniform((0.0, 0.0, 0.0)),
            light_max_distance=min(box_size * 2, 255),
        ),
    )
    space.spawn_position = np.array([0.5, 0.5, 1.6]) * box_size

    white = from_color((1.0, 1.0, 1.0, 1.0), "white")
    red = from_color((0.57, 0.025, 0.025, 1.0), "red")
    green = from_color((0.025, 0.236, 0.025, 1.0), "green")
    emission = 1.07 * float(np.sqrt(box_size))
    light = Block(
        Atom(color=(1.0, 1.0, 1.0, 1.0), emission=(emission,) * 3),
        BlockAttributes(display_name="Light"),
    )

    s = box_size
    space.fill(GridAab.from_lower_size((0, -1, 0), (s, 1, s)), white)  # floor
    space.fill(GridAab.from_lower_size((0, s, 0), (s, 1, s)), white)  # ceiling
    # Light panel: the cells [21,55,23]..[34,55,33] scaled, abutted +Y into
    # the ceiling layer.
    panel = _scaled_box((21, 55, 23), (13, 0, 10), s)
    space.fill(
        GridAab.from_lower_size((panel.lower[0], s, panel.lower[2]),
                                (panel.size[0], 1, panel.size[2])),
        light,
    )
    space.fill(GridAab.from_lower_size((0, 0, -1), (s, s, 1)), white)  # back wall
    space.fill(GridAab.from_lower_size((s, 0, 0), (1, s, s)), green)  # right
    space.fill(GridAab.from_lower_size((-1, 0, 0), (1, s, s)), red)  # left
    # The two boxes.
    space.fill(_scaled_box((29, 0, 36), (16, 16, 15), s), white)
    space.fill(_scaled_box((10, 0, 13), (18, 33, 15), s), white)

    space.fast_evaluate_light()
    return space
