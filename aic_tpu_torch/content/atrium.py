"""Atrium template (reference: all-is-cubes-content/src/atrium/mod.rs:50).

Copied unchanged from `aic_tpu/content/atrium.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

A procedural Sponza-like atrium: multi-floor arcades around an open
courtyard, built from voxel-resolution (R16) blocks (atrium/blocks.rs) with
interior lamps and `LightPhysics::Rays` — the scene of BASELINE.json's
north-star raytrace benchmark (config 4: 1080p, recursive R16 blocks +
emissive lighting).
"""

from __future__ import annotations

import numpy as np

from ..block import AIR, Atom, Block, BlockAttributes, from_color
from ..math.color import np_srgb8_to_linear
from ..math.grid import GridAab
from ..space import Sky, Space, SpacePhysics
from .landscape import voxel_block


def _lin(r, g, b, a=1.0):
    c = np_srgb8_to_linear(np.array([r, g, b]))
    return (float(c[0]), float(c[1]), float(c[2]), a)


def _atrium_blocks(resolution: int = 16) -> dict:
    """R16 architectural blocks (atrium/blocks.rs analog)."""
    r = resolution

    def paint_column(sp):
        shaft = from_color(_lin(216, 200, 174), "marble")
        dark = from_color(_lin(160, 147, 135), "marble-shadow")
        cx = r / 2 - 0.5
        for x, y, z in sp.bounds.interior_iter():
            d = max(abs(x - cx), abs(z - cx))
            if d <= r * 0.28:
                sp.set((x, y, z), shaft)
            elif d <= r * 0.34 and (y % (r // 2)) in (0, r // 2 - 1):
                sp.set((x, y, z), dark)

    def paint_arch(sp):
        stone = from_color(_lin(205, 191, 167), "arch-stone")
        cx = r / 2 - 0.5
        for x, y, z in sp.bounds.interior_iter():
            # A rounded arch opening: keep material outside a half-circle.
            dx = (x - cx) / (r / 2)
            dy = y / r
            if dx * dx + (1.0 - dy) * (1.0 - dy) * 0.8 > 0.72:
                sp.set((x, y, z), stone)

    def paint_balustrade(sp):
        stone = from_color(_lin(199, 185, 160), "balustrade")
        for x, y, z in sp.bounds.interior_iter():
            if y < r // 5 or y >= r - r // 5:
                sp.set((x, y, z), stone)
            elif (x // max(r // 4, 1)) % 2 == 0 and abs(z - r / 2) < r * 0.2:
                sp.set((x, y, z), stone)

    def paint_floor(sp):
        a = from_color(_lin(174, 157, 130), "tile-a")
        b = from_color(_lin(147, 129, 105), "tile-b")
        for x, y, z in sp.bounds.interior_iter():
            sp.set((x, y, z), a if ((x // (r // 4)) + (z // (r // 4))) % 2 else b)

    def paint_lamp(sp):
        glow = Block(
            Atom(color=(1.0, 0.95, 0.8, 1.0), emission=(8.0, 7.0, 5.0)),
            BlockAttributes(display_name="flame"),
        )
        iron = from_color(_lin(50, 45, 40), "iron")
        c = r // 2
        for x, y, z in sp.bounds.interior_iter():
            d = abs(x - c) + abs(y - c) + abs(z - c)
            if d <= r // 4:
                sp.set((x, y, z), glow)
            elif d == r // 4 + 1 and (x == c or z == c):
                sp.set((x, y, z), iron)

    def paint_banner(color):
        cloth = Block(Atom(color=color + (1.0,)))

        def paint(sp):
            for x, y, z in sp.bounds.interior_iter():
                # A hanging cloth: thin in z, swallow-tail bottom edge.
                if z != r // 2:
                    continue
                tail = abs(x - (r - 1) / 2) * 2 / r  # 0 center → 1 edge
                if y >= int(tail * r * 0.4):
                    sp.set((x, y, z), cloth)

        return paint

    def paint_firepot(sp):
        flame = Block(
            Atom(color=(1.0, 0.8, 0.4, 1.0), emission=(16.0, 9.0, 2.0)),
            BlockAttributes(display_name="fire"),
        )
        pot = from_color(_lin(60, 50, 45), "firepot")
        c = (r - 1) / 2
        for x, y, z in sp.bounds.interior_iter():
            d = max(abs(x - c), abs(z - c))
            if y < r // 3 and d <= r * 0.35:
                sp.set((x, y, z), pot)
            elif r // 3 <= y < r * 2 // 3 and d <= r * 0.2:
                sp.set((x, y, z), flame)

    banners = {
        name: voxel_block(f"banner-{name}", r, paint_banner(rgb))
        for name, rgb in (
            ("red", (0.8, 0.1, 0.1)),
            ("green", (0.1, 0.6, 0.2)),
            ("blue", (0.1, 0.2, 0.8)),
        )
    }

    return {
        "column": voxel_block("column", r, paint_column),
        "arch": voxel_block("arch", r, paint_arch),
        "balustrade": voxel_block("balustrade", r, paint_balustrade),
        "floor": voxel_block("atrium-floor", r, paint_floor),
        "lamp": voxel_block("atrium-lamp", r, paint_lamp),
        "firepot": voxel_block("firepot", r, paint_firepot),
        "wall": from_color(_lin(217, 205, 178), "plaster"),
        "roof": from_color(_lin(140, 77, 52), "roof-tile"),
        # Sun block (atrium/blocks.rs:265-273): white with emission
        # 40·(1, 1, 0.9843) — the "directional" skylight strip.
        "sun": Block(
            Atom(color=(1.0, 1.0, 1.0, 1.0), emission=(40.0, 40.0, 39.372)),
            BlockAttributes(display_name="sun"),
        ),
        **banners,
    }


def atrium(seed: int = 0, width: int = 60, depth: int = 40, floors: int = 4) -> Space:
    """Full-scale atrium (atrium/mod.rs:40-46 proportions: FLOOR_COUNT=4,
    CEILING_HEIGHT=6, SUN_HEIGHT=10): four arcade floors, a sun strip
    under the open sky (the reference's directional skylight,
    mod.rs:117-127), hanging banners on the balustrades (mod.rs:403-416
    role) and firepots on the courtyard floor."""
    blocks = _atrium_blocks(16)
    floor_h = 6
    sun_height = 10
    height = floors * floor_h + sun_height
    bounds = GridAab.from_lower_size((0, -1, 0), (width, height + 1, depth))
    space = Space(
        bounds,
        physics=SpacePhysics(sky=Sky.default(), light_max_distance=min(max(width, depth), 255)),
    )

    # Ground floor.
    space.fill(GridAab.from_lower_size((0, -1, 0), (width, 1, depth)), blocks["floor"])

    court_margin = 8
    court = GridAab.from_lower_size(
        (court_margin, 0, court_margin),
        (width - 2 * court_margin, height, depth - 2 * court_margin),
    )

    # Perimeter walls.
    for box in [
        GridAab.from_lower_size((0, 0, 0), (width, height, 1)),
        GridAab.from_lower_size((0, 0, depth - 1), (width, height, 1)),
        GridAab.from_lower_size((0, 0, 0), (1, height, depth)),
        GridAab.from_lower_size((width - 1, 0, 0), (1, height, depth)),
    ]:
        space.fill(box, blocks["wall"])

    # Arcade floors around the courtyard.
    for f in range(floors):
        y0 = f * floor_h
        # Floor slabs of the galleries (not over the open courtyard).
        if f > 0:
            slab = GridAab.from_lower_size((1, y0, 1), (width - 2, 1, depth - 2))
            space.fill(slab, blocks["floor"])
            space.fill(
                GridAab.from_lower_size(
                    (court.lower[0], y0, court.lower[2]),
                    (court.size[0], 1, court.size[2]),
                ),
                AIR,
            )
            # Balustrade around the courtyard opening.
            cx0, _, cz0 = court.lower
            cx1, _, cz1 = court.upper
            space.fill(GridAab.from_lower_upper((cx0 - 1, y0 + 1, cz0 - 1), (cx1 + 1, y0 + 2, cz0)), blocks["balustrade"])
            space.fill(GridAab.from_lower_upper((cx0 - 1, y0 + 1, cz1), (cx1 + 1, y0 + 2, cz1 + 1)), blocks["balustrade"])
            space.fill(GridAab.from_lower_upper((cx0 - 1, y0 + 1, cz0), (cx0, y0 + 2, cz1)), blocks["balustrade"])
            space.fill(GridAab.from_lower_upper((cx1, y0 + 1, cz0), (cx1 + 1, y0 + 2, cz1)), blocks["balustrade"])

        # Columns + arches along the courtyard edge.
        cx0, _, cz0 = court.lower
        cx1, _, cz1 = court.upper
        for x in range(cx0 - 1, cx1 + 1, 4):
            for z in (cz0 - 1, cz1):
                for y in range(y0, y0 + floor_h - 2):
                    space.set((x, y, z), blocks["column"])
                space.set((x, y0 + floor_h - 2, z), blocks["arch"])
        for z in range(cz0 - 1, cz1 + 1, 4):
            for x in (cx0 - 1, cx1):
                for y in range(y0, y0 + floor_h - 2):
                    space.set((x, y, z), blocks["column"])
                space.set((x, y0 + floor_h - 2, z), blocks["arch"])

        # Gallery lamps.
        for x in range(3, width - 3, 8):
            space.set((x, y0 + floor_h - 2, 2), blocks["lamp"])
            space.set((x, y0 + floor_h - 2, depth - 3), blocks["lamp"])

    # Banners hanging from the courtyard balustrades (every other bay).
    cx0, _, cz0 = court.lower
    cx1, _, cz1 = court.upper
    banner_names = ["red", "green", "blue"]
    bi = 0
    for f in range(1, floors):
        y0 = f * floor_h
        for x in range(cx0 + 1, cx1 - 1, 8):
            space.set((x, y0 - 1, cz0 - 1), blocks[banner_names[bi % 3]])
            space.set((x, y0 - 1, cz1), blocks[banner_names[(bi + 1) % 3]])
            bi += 1

    # Firepots on the courtyard floor corners.
    for x, z in (
        (cx0 + 2, cz0 + 2),
        (cx1 - 3, cz0 + 2),
        (cx0 + 2, cz1 - 3),
        (cx1 - 3, cz1 - 3),
    ):
        space.set((x, 0, z), blocks["firepot"])

    # Sun strip: a band of emissive sun blocks just under the top of the
    # bounds over the courtyard (mod.rs:117-127 fill abutting PY).
    sun_y = height - 2
    space.fill(
        GridAab.from_lower_size(
            (court.lower[0] + 2, sun_y, court.lower[2] + 2),
            (max(court.size[0] - 4, 1), 1, max(min(court.size[2] - 4, 6), 1)),
        ),
        blocks["sun"],
    )

    # Roof ring over the galleries (courtyard open to the sky).
    roof_y = floors * floor_h
    roof = GridAab.from_lower_size((0, roof_y, 0), (width, 1, depth))
    space.fill(roof, blocks["roof"])
    space.fill(
        GridAab.from_lower_size(
            (court.lower[0], roof_y, court.lower[2]),
            (court.size[0], 1, court.size[2]),
        ),
        AIR,
    )

    space.spawn_position = np.array([width / 2, 2.0, depth / 2])
    space.fast_evaluate_light()
    return space
