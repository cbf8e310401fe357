"""Voxel-block helper shared by the templates.

`voxel_block` copied unchanged from `aic_tpu/content/landscape.py`; the
rest of that module (demo block library, terrain) is not ported yet.
"""

from __future__ import annotations

from ..block import Block, BlockAttributes, Recur
from ..math.grid import GridAab
from ..space import Space


def voxel_block(name: str, resolution: int, paint, collision_fill=True) -> Block:
    """Build a Recur block by calling `paint(space)` on a fresh R³ space
    (the content-side analog of Block::builder().voxels_fn, builder.rs)."""
    sp = Space(GridAab.cube(resolution))
    paint(sp)
    return Block(
        Recur(space=sp, resolution=resolution),
        BlockAttributes(display_name=name),
    )
