"""demo-city template (reference: all-is-cubes-content/src/city.rs:49).

Copied unchanged from `aic_tpu/content/city.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

A landscape with roads radiating from a central plaza, procedural
buildings ("exhibits" framework simplified to building lots), lamps
(emissive voxel blocks), trees, and a ticking animated block — the scene
BASELINE.json's config 3 steps at 60 Hz (physics + behaviors + meshing).
"""

from __future__ import annotations

import numpy as np

from ..block import AIR, Block
from ..math.grid import GridAab
from ..space import Sky, Space, SpacePhysics
from ..universe import Become
from .landscape import demo_blocks, heightfield


def demo_city(seed: int = 0, size: int = 96, height: int = 24) -> Space:
    rng = np.random.default_rng(seed)
    blocks = demo_blocks(seed)
    half = size // 2
    bounds = GridAab.from_lower_size((-half, -4, -half), (size, height + 4, size))
    # Light physics: the reference city re-enables the DEFAULT light
    # physics after bulk generation (city.rs:134 set_physics with
    # SpacePhysics::default().light = Rays { maximum_distance: 30 },
    # physics.rs:103) — not a larger custom distance.
    space = Space(
        bounds,
        physics=SpacePhysics(sky=Sky.default(), light_max_distance=30),
    )

    hf = heightfield((size, size), seed, amplitude=4.0)

    # Terrain: dirt below, grass surface; roads flatten to y=0.
    for xi in range(size):
        for zi in range(size):
            x = xi - half
            z = zi - half
            on_road = abs(x) <= 2 or abs(z) <= 2
            h = 0 if on_road or (abs(x) < 8 and abs(z) < 8) else int(round(hf[xi, zi]))
            h = max(min(h, 6), -3)
            space.fill(
                GridAab.from_lower_upper((x, -4, z), (x + 1, h, z + 1)), blocks["dirt"]
            )
            top = blocks["road"] if on_road else blocks["grass"]
            space.set((x, h, z), top)

    # Curbs along roads.
    for c in range(-half, half):
        for off in (3, -3):
            if abs(c) > 3:
                space.set((c, 1, off), blocks["curb"])
                space.set((off, 1, c), blocks["curb"])

    # Street lamps.
    for pos in range(-half + 6, half - 4, 12):
        for off in (4, -4):
            for base in ((pos, off), (off, pos)):
                x, z = base
                for y in range(1, 5):
                    space.set((x, y, z), blocks["wood"])
                space.set((x, 5, z), blocks["lamp"])

    # Buildings on lots.
    lots = []
    for qx in (-1, 1):
        for qz in (-1, 1):
            for i in range(2):
                span = max(half - 22, 1)
                lx = qx * (10 + rng.integers(0, span)) + qx * i * 3
                lz = qz * (10 + rng.integers(0, span))
                lots.append((int(lx), int(lz)))
    for lx, lz in lots:
        w = int(rng.integers(5, 10))
        d = int(rng.integers(5, 10))
        h = int(rng.integers(4, min(height - 2, 12)))
        wall = blocks["brick"] if rng.random() < 0.6 else blocks["stone"]
        lot = GridAab.from_lower_size((lx, 0, lz), (w, h, d))
        if not bounds.contains_box(lot.expand(1)):
            continue
        space.fill(lot, wall)
        interior = GridAab.from_lower_size((lx + 1, 0, lz + 1), (w - 2, h - 1, d - 2))
        space.fill(interior, AIR)
        # Door + windows.
        space.fill(GridAab.from_lower_size((lx + w // 2, 0, lz), (1, 2, 1)), AIR)
        for wy in range(1, h - 1, 3):
            for wx in range(lx + 1, lx + w - 1, 2):
                space.set((wx, wy, lz + d - 1), blocks["glass"])
        # Ceiling lamp inside.
        space.set((lx + w // 2, h - 2, lz + d // 2), blocks["lamp"])

    # Trees.
    for _ in range(size // 6):
        x = int(rng.integers(-half + 2, half - 2))
        z = int(rng.integers(-half + 2, half - 2))
        if abs(x) <= 5 or abs(z) <= 5:
            continue
        base_y = 1
        trunk_h = int(rng.integers(3, 6))
        for y in range(base_y, base_y + trunk_h):
            space.set((x, y, z), blocks["wood"])
        canopy = GridAab.from_lower_size(
            (x - 1, base_y + trunk_h - 1, z - 1), (3, 3, 3)
        ).intersection(bounds)
        space.fill(canopy, blocks["leaves"])

    # Exhibits gallery along the +Z road (city.rs exhibits placement):
    # each exhibit sits on a pedestal with a voxel-text name sign.
    from .exhibits import EXHIBITS, place_exhibit

    # Multi-row gallery: exhibits fill a row along +X then wrap to the
    # next row further down the road (the reference's placement walks a
    # spiral of candidate plots, city.rs; rows serve the same purpose).
    ex_x = -half + 6
    row_z = 7
    row_depth = 0
    for exhibit in EXHIBITS:
        if exhibit.heavy:
            # Shared-snapshot cost guard (Exhibit.heavy docstring): R128
            # exhibits pad the whole city's voxel table; shown standalone.
            continue
        ex_sp = exhibit.factory()  # built once; placed below
        sp_size = ex_sp.bounds.size
        if ex_x + sp_size[0] >= half - 2:
            ex_x = -half + 6
            row_z += row_depth + 5
            row_depth = 0
        if row_z + sp_size[2] >= half - 2:
            break  # city footprint exhausted
        place_exhibit(space, exhibit, (ex_x, 1, row_z), blocks["stone"], prebuilt=ex_sp)
        ex_x += sp_size[0] + 4
        row_depth = max(row_depth, sp_size[2])

    # One ticking "traffic light" block cycling colors via tick_action
    # (exercises execute_tick_actions_system every step). The cycle runs
    # through BlockDef handles — immutable blocks cannot close a Become
    # cycle by value (the old chain dead-ended after three transitions).
    from ..block import from_color
    from .exhibits import _become_cycle

    red = from_color((1.0, 0.1, 0.1, 1.0), "signal-red")
    green = from_color((0.1, 1.0, 0.1, 1.0), "signal-green")
    space.set((4, 2, 4), _become_cycle([red, green], period=60)[0])

    space.spawn_position = np.array([0.5, 3.0, half * 0.8])
    space.fast_evaluate_light()
    return space
