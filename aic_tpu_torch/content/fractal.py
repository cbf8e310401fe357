"""Menger sponge template (reference: all-is-cubes-content/src/fractal.rs).

Copied unchanged from `aic_tpu/content/fractal.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

The fractal is built recursively: a level-n sponge is a Space of 3ⁿ cubes
with the center-row cells removed at every scale. We also offer the
reference's signature trick of making the level-1 block itself a `Recur`
voxel block so the fractal recurses *below* cube resolution.
"""

from __future__ import annotations

import numpy as np

from ..block import Block, Recur, from_color
from ..math.grid import GridAab
from ..space import Sky, Space, SpacePhysics


def _sponge_mask(level: int) -> np.ndarray:
    """bool[3^l,3^l,3^l]: True where material exists."""
    mask = np.ones((1, 1, 1), bool)
    for _ in range(level):
        n = mask.shape[0]
        out = np.zeros((3 * n,) * 3, bool)
        for ix in range(3):
            for iy in range(3):
                for iz in range(3):
                    if (ix == 1) + (iy == 1) + (iz == 1) >= 2:
                        continue
                    out[ix * n : (ix + 1) * n, iy * n : (iy + 1) * n, iz * n : (iz + 1) * n] = mask
        mask = out
    return mask


def menger_sponge(
    world_levels: int = 3,
    block_levels: int = 2,
    color=(0.65, 0.6, 0.55, 1.0),
) -> Space:
    """Build a sponge of 3^world_levels cubes whose material block is
    itself a 3^block_levels-resolution sponge (fractal.rs's recursive
    composition)."""
    material = from_color(color, "sponge")
    if block_levels > 0:
        res = 3**block_levels
        inner = Space(GridAab.cube(res))
        m = _sponge_mask(block_levels)
        inner.fill(inner.bounds, lambda c: material if m[c] else None)
        material = Block(Recur(space=inner, resolution=res))

    n = 3**world_levels
    sp = Space(
        GridAab.cube(n),
        physics=SpacePhysics(sky=Sky.default(), light_max_distance=min(2 * n, 255)),
    )
    mask = _sponge_mask(world_levels)
    sp.fill(sp.bounds, lambda c: material if mask[c] else None)
    sp.fast_evaluate_light()
    sp.spawn_position = np.array([n * 1.5, n * 0.75, n * 1.5])
    return sp
