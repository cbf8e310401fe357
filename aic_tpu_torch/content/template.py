"""UniverseTemplate: the catalog of buildable demo universes.

Port of `aic_tpu/content/template.py` (the reference's
all-is-cubes-content/src/template.rs:82-126 `UniverseTemplate` with
seeded `TemplateParameters`), copied but for two changes:

- `plaza640`, the port's own world (`plaza.py`), is added;
- `build_universe` snapshots on `device` (the card unless the caller
  asks for the CPU).

Each builder returns a populated Space; `build_universe` puts it in a
Universe as "world" and spawns a player character.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..block import AIR, from_color
from ..math.grid import GridAab
from ..space import Sky, Space, SpacePhysics
from ..universe import Universe


@dataclass(frozen=True)
class TemplateParameters:
    """template.rs TemplateParameters: seed + requested size."""

    seed: int = 0
    size: Optional[int] = None


def _blank(p: TemplateParameters) -> Space:
    """template.rs UniverseTemplate::Blank."""
    return Space(GridAab.cube(p.size or 16))


def _random(p: TemplateParameters) -> Space:
    """UniverseTemplate::Random: noise terrain of random colored blocks."""
    rng = np.random.default_rng(p.seed)
    n = p.size or 32
    sp = Space(GridAab.cube(n), physics=SpacePhysics(sky=Sky.default()))
    palette = [
        from_color((float(r), float(g), float(b), 1.0), f"rand{i}")
        for i, (r, g, b) in enumerate(rng.random((8, 3)))
    ]
    hf = (rng.random((n, n)) * (n // 3)).astype(int) + 1
    for x in range(n):
        for z in range(n):
            for y in range(hf[x, z]):
                sp.set((x, y, z), palette[int(rng.integers(0, len(palette)))])
    sp.fast_evaluate_light()
    return sp


def _dungeon(p: TemplateParameters) -> Space:
    """UniverseTemplate::Dungeon: maze of rooms and corridors
    (dungeon/DungeonGrid analog: grid of rooms with knocked-out walls)."""
    rng = np.random.default_rng(p.seed)
    rooms = 4 if (p.size or 0) < 48 else (p.size or 48) // 12
    room = 7
    n = rooms * room + 1
    h = 6
    sp = Space(
        GridAab.from_lower_size((0, -1, 0), (n, h + 2, n)),
        physics=SpacePhysics(sky=Sky.uniform((0.02, 0.02, 0.03)), light_max_distance=30),
    )
    stone = from_color((0.35, 0.33, 0.3, 1.0), "dungeon-stone")
    floor = from_color((0.25, 0.22, 0.2, 1.0), "dungeon-floor")
    from ..block import Atom, Block, BlockAttributes

    torch = Block(
        Atom(color=(1.0, 0.7, 0.3, 1.0), emission=(5.0, 2.6, 0.9)),
        BlockAttributes(display_name="torch"),
    )
    sp.fill(GridAab.from_lower_size((0, -1, 0), (n, 1, n)), floor)
    sp.fill(GridAab.from_lower_size((0, h, 0), (n, 1, n)), stone)
    # Walls on the full room grid, then knock out doorways with a
    # randomized spanning maze (depth-first).
    for gx in range(rooms + 1):
        sp.fill(GridAab.from_lower_size((gx * room, 0, 0), (1, h, n)), stone)
        sp.fill(GridAab.from_lower_size((0, 0, gx * room), (n, h, 1)), stone)
    visited = np.zeros((rooms, rooms), bool)
    stack = [(0, 0)]
    visited[0, 0] = True
    while stack:
        cx, cz = stack[-1]
        options = [
            (nx, nz, dx, dz)
            for dx, dz in ((1, 0), (-1, 0), (0, 1), (0, -1))
            for nx, nz in [(cx + dx, cz + dz)]
            if 0 <= nx < rooms and 0 <= nz < rooms and not visited[nx, nz]
        ]
        if not options:
            stack.pop()
            continue
        nx, nz, dx, dz = options[int(rng.integers(0, len(options)))]
        # Knock out a doorway between (cx,cz) and (nx,nz).
        if dx:
            wall_x = max(cx, nx) * room
            door_z = cz * room + room // 2
            sp.fill(GridAab.from_lower_size((wall_x, 0, door_z), (1, 3, 2)), AIR)
        else:
            wall_z = max(cz, nz) * room
            door_x = cx * room + room // 2
            sp.fill(GridAab.from_lower_size((door_x, 0, wall_z), (2, 3, 1)), AIR)
        visited[nx, nz] = True
        stack.append((nx, nz))
    # A torch in each room.
    for gx in range(rooms):
        for gz in range(rooms):
            sp.set((gx * room + room // 2, h - 2, gz * room + room // 2), torch)
    # Treasure chests in some rooms (demo_dungeon's chest-with-inventory
    # role, dungeon/demo_dungeon.rs): the chest block carries an
    # Inventory modifier whose item icons render inside the block face
    # (InvInBlock, inv/inv_in_block.rs).
    from ..block import InvInBlock, InventoryModifier

    loot = [
        from_color((0.9, 0.8, 0.1, 1.0), "gold"),
        from_color((0.2, 0.9, 1.0, 1.0), "gem"),
        from_color((0.8, 0.2, 0.1, 1.0), "potion"),
    ]
    chest_base = from_color((0.45, 0.3, 0.15, 1.0), "chest").with_attributes(
        inventory=InvInBlock.default_for_size(4)
    )
    for gx in range(rooms):
        for gz in range(rooms):
            if rng.random() < 0.4:
                icons = tuple(
                    loot[int(rng.integers(0, len(loot)))] if rng.random() < 0.7 else None
                    for _ in range(4)
                )
                sp.set(
                    (gx * room + 1, 0, gz * room + 1),
                    chest_base.with_modifier(InventoryModifier(icons=icons)),
                )
    sp.spawn_position = np.array([room / 2, 2.0, room / 2])
    sp.fast_evaluate_light()
    return sp


def _islands(p: TemplateParameters) -> Space:
    """UniverseTemplate::Islands: floating islands in the sky."""
    from .landscape import demo_blocks

    rng = np.random.default_rng(p.seed)
    n = p.size or 64
    blocks = demo_blocks(p.seed)
    sp = Space(
        GridAab.from_lower_size((-n // 2, -n // 4, -n // 2), (n, n // 2, n)),
        physics=SpacePhysics(sky=Sky.default(), light_max_distance=40),
    )
    for _ in range(max(3, n // 16)):
        cx = int(rng.integers(-n // 2 + 8, n // 2 - 8))
        cz = int(rng.integers(-n // 2 + 8, n // 2 - 8))
        cy = int(rng.integers(-n // 8, n // 8))
        radius = int(rng.integers(4, 9))
        for x in range(cx - radius, cx + radius + 1):
            for z in range(cz - radius, cz + radius + 1):
                r2 = (x - cx) ** 2 + (z - cz) ** 2
                if r2 > radius * radius:
                    continue
                depth = int((radius - np.sqrt(r2)) * 0.8) + 1
                for dy in range(-depth, 1):
                    cube = (x, cy + dy, z)
                    if sp.bounds.contains_cube(cube):
                        sp.set(cube, blocks["grass"] if dy == 0 else blocks["dirt"])
    sp.spawn_position = np.array([0.0, n // 4 - 2.0, 0.0])
    sp.fast_evaluate_light()
    return sp


def build_template_space(name: str, params: TemplateParameters = TemplateParameters()) -> Space:
    """Build the world Space for a named template."""
    from .atrium import atrium
    from .city import demo_city
    from .cornell import cornell_box
    from .fractal import menger_sponge
    from .plaza import plaza
    from .testing import light_bench_space

    if name == "blank":
        return _blank(params)
    if name == "random":
        return _random(params)
    if name == "dungeon":
        return _dungeon(params)
    if name == "islands":
        return _islands(params)
    if name == "cornell-box":
        return cornell_box(params.size or 32)
    if name == "menger-sponge":
        return menger_sponge()
    if name == "lighting-bench" or name == "light-bench":
        s = params.size or 54
        return light_bench_space((s, 16, s))
    if name == "demo-city":
        return demo_city(params.seed, params.size or 96)
    if name == "atrium":
        return atrium(params.seed)
    if name == "plaza640":
        return plaza(params.size or 640)
    if name == "menu":
        # UniverseTemplate::Menu (template.rs:82): a voxel-UI page listing
        # the world templates as buttons (vui/page.rs). The port's own
        # plaza640 is left off, so the menu equals `aic_tpu`'s.
        from ..vui import main_menu_page

        worlds = [t for t in TEMPLATE_NAMES if t not in ("menu", "fail", "plaza640")]
        sp = main_menu_page(worlds)
        sp.spawn_position = np.array(
            [sp.bounds.size[0] / 2.0, sp.bounds.size[1] / 2.0, sp.bounds.upper[2] + 12.0]
        )
        sp.fast_evaluate_light()
        return sp
    if name == "fail":
        raise RuntimeError("UniverseTemplate::Fail (intentional failure for testing)")
    raise KeyError(f"unknown template {name!r}; available: {', '.join(TEMPLATE_NAMES)}")


TEMPLATE_NAMES = [
    "menu",
    "blank",
    "random",
    "dungeon",
    "islands",
    "cornell-box",
    "menger-sponge",
    "lighting-bench",
    "demo-city",
    "atrium",
    "plaza640",
    "fail",
]


def build_universe(
    name: str, params: TemplateParameters = TemplateParameters(), device="cuda"
) -> Universe:
    """A Universe holding the template's space as "world", snapshotted on
    `device` (the card unless the caller asks for the CPU), and a player
    character at its spawn point (or the centre of its bounds);
    template.rs `::build()`."""
    u = Universe(device=device)
    space = build_template_space(name, params)
    u.insert_space("world", space)
    spawn = (
        tuple(float(c) for c in space.spawn_position)
        if space.spawn_position is not None
        else tuple(lo + s / 2 for lo, s in zip(space.bounds.lower, space.bounds.size))
    )
    u.insert_character("player", "world", spawn)
    return u
