"""Landscape + block-library helpers shared by the big templates.

Copied unchanged from `aic_tpu/content/landscape.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

Reference: all-is-cubes-content/src/{blocks.rs DemoBlocks, landscape
helpers, alg.rs}. Provides a seeded terrain generator (heightfield +
strata), the voronoi-ish scatter helper, and a small library of voxel
blocks (grass with blades, brick, wood, leaves) built as `Recur` blocks —
exercising the recursive-block pipeline the way `install_demo_blocks`
does.
"""

from __future__ import annotations

import numpy as np

from ..block import AIR, Atom, Block, BlockAttributes, Recur, from_color
from ..math.color import np_srgb8_to_linear
from ..math.grid import GridAab
from ..space import Space


def _lin(r, g, b, a=1.0):
    c = np_srgb8_to_linear(np.array([r, g, b]))
    return (float(c[0]), float(c[1]), float(c[2]), a)


def voxel_block(name: str, resolution: int, paint, collision_fill=True) -> Block:
    """Build a Recur block by calling `paint(space)` on a fresh R³ space
    (the content-side analog of Block::builder().voxels_fn, builder.rs)."""
    sp = Space(GridAab.cube(resolution))
    paint(sp)
    return Block(
        Recur(space=sp, resolution=resolution),
        BlockAttributes(display_name=name),
    )


def demo_blocks(seed: int = 0, resolution: int = 8) -> dict:
    """A small DemoBlocks-style provider (blocks.rs): named voxel blocks."""
    rng = np.random.default_rng(seed)
    r = resolution

    dirt = from_color(_lin(110, 73, 40), "dirt")
    stone = from_color(_lin(125, 125, 125), "stone")

    def paint_grass(sp):
        soil = from_color(_lin(110, 73, 40), "soil")
        grass = from_color(_lin(64, 130, 35), "grass-top")
        blade = from_color(_lin(80, 160, 45), "blade")
        sp.fill(GridAab.from_lower_size((0, 0, 0), (r, r - 2, r)), soil)
        sp.fill(GridAab.from_lower_size((0, r - 2, 0), (r, 1, r)), grass)
        for _ in range(r * r // 3):
            x, z = rng.integers(0, r, 2)
            sp.set((int(x), r - 1, int(z)), blade)

    def paint_brick(sp):
        mortar = from_color(_lin(158, 150, 140), "mortar")
        brick = from_color(_lin(144, 76, 61), "brick")
        sp.fill(sp.bounds, brick)
        for y in range(0, r, max(r // 4, 1)):
            sp.fill(GridAab.from_lower_size((0, y, 0), (r, 1, r)), mortar)
        for x in range(0, r, max(r // 2, 1)):
            sp.fill(GridAab.from_lower_size((x, 0, 0), (1, r, r)), mortar)

    def paint_wood(sp):
        dark = from_color(_lin(95, 66, 38), "wood-dark")
        light = from_color(_lin(118, 85, 50), "wood-light")
        for x in range(r):
            sp.fill(
                GridAab.from_lower_size((x, 0, 0), (1, r, r)),
                dark if (x // max(r // 4, 1)) % 2 else light,
            )

    def paint_leaves(sp):
        leaf = from_color(_lin(42, 103, 31, 1.0), "leaf")
        for _ in range(r * r * r // 2):
            x, y, z = rng.integers(0, r, 3)
            sp.set((int(x), int(y), int(z)), leaf)

    def paint_lamp(sp):
        glow = Block(
            Atom(color=(1.0, 1.0, 0.9, 1.0), emission=(6.0, 6.0, 5.0)),
            BlockAttributes(display_name="glow"),
        )
        frame = from_color(_lin(40, 40, 40), "lamp-frame")
        sp.fill(sp.bounds, glow)
        for c in sp.bounds.interior_iter():
            edges = sum(int(v in (0, r - 1)) for v in c)
            if edges >= 2:
                sp.set(c, frame)

    return {
        "dirt": dirt,
        "stone": stone,
        "grass": voxel_block("grass", r, paint_grass),
        "brick": voxel_block("brick", r, paint_brick),
        "wood": voxel_block("wood", r, paint_wood),
        "leaves": voxel_block("leaves", r, paint_leaves),
        "lamp": voxel_block("lamp", r, paint_lamp),
        "road": from_color(_lin(50, 50, 50), "road"),
        "curb": from_color(_lin(180, 180, 170), "curb"),
        "glass": Block(
            Atom(color=(0.72, 0.81, 0.88, 0.25)),
            BlockAttributes(display_name="glass"),
        ),
    }


def heightfield(size_xz, seed: int, amplitude: float = 6.0) -> np.ndarray:
    """Smooth random heightfield via summed shifted noise octaves
    (landscape helper analog of alg.rs gradients)."""
    rng = np.random.default_rng(seed)
    w, d = size_xz
    h = rng.standard_normal((w // 8 + 2, d // 8 + 2))
    # bilinear upsample
    xs = np.linspace(0, h.shape[0] - 1.001, w)
    zs = np.linspace(0, h.shape[1] - 1.001, d)
    x0 = xs.astype(int)
    z0 = zs.astype(int)
    fx = (xs - x0)[:, None]
    fz = (zs - z0)[None, :]
    big = (
        h[x0][:, z0] * (1 - fx) * (1 - fz)
        + h[x0 + 1][:, z0] * fx * (1 - fz)
        + h[x0][:, z0 + 1] * (1 - fx) * fz
        + h[x0 + 1][:, z0 + 1] * fx * fz
    )
    big = big + 0.4 * rng.standard_normal((w, d)) * 0.5
    return (big * amplitude / max(big.std(), 1e-6) * 0.35).astype(np.float32)
