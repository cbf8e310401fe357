"""Exhibits: small self-contained demo scenes placed in the demo city.

Copied unchanged from `aic_tpu/content/exhibits.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

Role of the reference's exhibits gallery
(all-is-cubes-content/src/city/exhibit.rs:11 `Exhibit` + exhibits/*.rs):
each exhibit is a named factory producing a small Space that stresses one
engine feature (transparency, composite modifiers, rotations,
resolutions, Move animation, voxel text, color fidelity). The demo-city
generator places them on pedestals around the plaza with voxel-text name
signs (city.rs exhibit placement role).

The factories mirror specific reference exhibits (cited per function);
geometry is re-derived, not copied.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..block import (
    AIR,
    Atom,
    Block,
    BlockAttributes,
    Composite,
    Move,
    Recur,
    Rotate,
    TextPrimitive,
    Zoom,
)
from ..block import from_color
from ..math import faces
from ..math.grid import GridAab, ROTATION_MATRICES, rotation_from_name
from ..space import Sky, Space, SpacePhysics
from ..universe import Become


@dataclass(frozen=True)
class Exhibit:
    """exhibit.rs:11 Exhibit: name + subtitle + factory.

    `heavy` marks exhibits whose palette would blow up a shared snapshot
    (the voxel table pads every entry to the max resolution, so one R128
    block in the demo city would cost 64 MiB × every voxel entry);
    demo_city skips them — they are still built/rendered standalone."""

    name: str
    subtitle: str
    factory: Callable[[], Space]
    heavy: bool = False


def _exhibit_space(size, sky=(0.8, 0.8, 0.8)) -> Space:
    return Space(
        GridAab.from_lower_size((0, 0, 0), size),
        physics=SpacePhysics(sky=Sky.uniform(sky)),
    )


def transparency_exhibit() -> Space:
    """exhibits/transparency.rs TRANSPARENCY_LARGE: panes of decreasing
    alpha in front of reference pillars."""
    sp = _exhibit_space((7, 5, 5))
    alphas = [0.9, 0.7, 0.5, 0.3, 0.1]
    for i, a in enumerate(alphas):
        pane = Block(Atom(color=(0.2, 0.6, 1.0, a)))
        for y in range(1, 4):
            sp.set((1 + i, y, 1), pane)
    pillar = from_color((1.0, 0.3, 0.1, 1.0))
    for x in (1, 3, 5):
        for y in range(1, 4):
            sp.set((x, y, 3), pillar)
    return sp


def composite_exhibit() -> Space:
    """exhibits/composite.rs: the Porter–Duff operator matrix applied to
    two voxel shapes."""
    r = 8
    vox_a = Space(GridAab.from_lower_size((0, 0, 0), (r, r, r)))
    vox_b = Space(GridAab.from_lower_size((0, 0, 0), (r, r, r)))
    red = from_color((1.0, 0.1, 0.1, 1.0))
    blue = from_color((0.1, 0.1, 1.0, 1.0))
    for x in range(r):
        for y in range(r):
            for z in range(r):
                if (x - r / 2) ** 2 + (y - r / 2) ** 2 + (z - r / 2) ** 2 <= (r / 2) ** 2:
                    vox_a.set((x, y, z), red)
                if abs(x - r // 2) <= 1 or abs(y - r // 2) <= 1:
                    vox_b.set((x, y, z), blue)
    a = Block(Recur(space=vox_a, resolution=r))
    b = Block(Recur(space=vox_b, resolution=r))
    ops = ["over", "in", "out", "atop"]
    sp = _exhibit_space((2 * len(ops) + 1, 3, 3))
    for i, op in enumerate(ops):
        sp.set((1 + 2 * i, 1, 1), a.with_modifier(Composite(source=b, operator=op)))
    return sp


def rotation_exhibit() -> Space:
    """exhibits/rotation.rs: an asymmetric block under many rotations."""
    r = 8
    vox = Space(GridAab.from_lower_size((0, 0, 0), (r, r, r)))
    body = from_color((0.8, 0.7, 0.2, 1.0))
    tip = from_color((0.1, 0.8, 0.2, 1.0))
    for y in range(r):
        vox.set((0, y, 0), body)
    for x in range(r):
        vox.set((x, 0, 0), tip)
    vox.set((0, r - 1, 1), tip)
    arrow = Block(Recur(space=vox, resolution=r))
    n = len(ROTATION_MATRICES)
    cols = 8
    rows = (n + cols - 1) // cols
    sp = _exhibit_space((2 * cols + 1, 3, 2 * rows + 1))
    for i in range(n):
        sp.set(
            (1 + 2 * (i % cols), 1, 1 + 2 * (i // cols)),
            arrow.with_modifier(Rotate(i)),
        )
    return sp


def resolution_exhibit() -> Space:
    """exhibits/resolutions.rs: the same sphere at R2..R32."""
    sp = _exhibit_space((13, 3, 3))
    for i, r in enumerate([2, 4, 8, 16, 32]):
        vox = Space(GridAab.from_lower_size((0, 0, 0), (r, r, r)))
        mat = from_color((0.3, 0.6, 0.9, 1.0))
        c = (r - 1) / 2.0
        for x in range(r):
            for y in range(r):
                for z in range(r):
                    if (x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2 <= (r / 2) ** 2:
                        vox.set((x, y, z), mat)
        sp.set((1 + 2 * i, 1, 1), Block(Recur(space=vox, resolution=r)))
    return sp


def move_exhibit() -> Space:
    """exhibits/move_modifier.rs: blocks displaced by Move at several
    phases (the animated version is the elevator; here the phases are laid
    out spatially so a still render shows the modifier working)."""
    sp = _exhibit_space((9, 4, 3))
    base = from_color((0.6, 0.3, 0.7, 1.0))
    for i, dist in enumerate([0, 64, 128, 192]):
        sp.set((1 + 2 * i, 1, 1), base.with_modifier(Move(face=faces.PY, distance=dist)))
    return sp


def text_exhibit() -> Space:
    """exhibits/text_blocks.rs: voxel text rendered from TextPrimitive."""
    sp = _exhibit_space((9, 3, 3))
    from ..text.font import text_tile_count

    # Backdrop wall so the thin glyph slabs read from any angle.
    sp.fill(
        GridAab.from_lower_size((0, 0, 0), (9, 3, 1)),
        from_color((0.25, 0.25, 0.3, 1.0)),
    )
    text = "AIC"
    n = text_tile_count(text, 16)
    for i in range(min(n, 7)):
        sp.set(
            (1 + i, 1, 2),
            Block(
                TextPrimitive(
                    text=text, resolution=16, color=(1.0, 1.0, 0.2, 1.0), tile=(i, 0)
                )
            ),
        )
    return sp


def color_exhibit() -> Space:
    """exhibits/color.rs COLORS: a swatch grid over hue × lightness."""
    cols, rows = 8, 4
    sp = _exhibit_space((cols + 2, 2, rows + 2))
    for i in range(cols):
        for j in range(rows):
            h = i / cols * 6.0
            lightness = (j + 1) / (rows + 1)
            c = np.clip(
                np.array(
                    [abs(h - 3) - 1, 2 - abs(h - 2), 2 - abs(h - 4)], np.float64
                ),
                0,
                1,
            )
            rgb = tuple(float(v) for v in c * lightness)
            sp.set((1 + i, 1, 1 + j), from_color(rgb + (1.0,)))
    return sp


def _become_cycle(frames: list[Block], period: int) -> list[Block]:
    """Close a list of frames into a true tick_action Become cycle.

    Immutable blocks cannot reference each other cyclically by value, so
    the cycle runs through BlockDef handles — frame i's definition holds
    a tick action Becoming the Indirect of frame i+1 (the reference's
    animated content uses block definition handles the same way;
    universe handles are its only cyclic reference mechanism)."""
    from ..block import BlockDef, Indirect

    defs = [BlockDef(AIR) for _ in frames]
    handles = [Block(Indirect(d)) for d in defs]
    n = len(frames)
    for i in range(n):
        defs[i].block = frames[i].with_attributes(
            tick_action=Become(handles[(i + 1) % n]), tick_period=period
        )
    return handles


def animation_exhibit() -> Space:
    """exhibits/animation.rs ANIMATION + BECOME: animated blocks.

    The reference redefines a block's voxel space every frame via an
    AnimatedVoxels/Fire behavior on the anonymous block space; here each
    frame is precomputed as a Recur block and the frames are chained by
    tick_action Become (the device-friendly form — the palette stays
    fixed, so no per-frame re-snapshot; same mechanism as the
    reference's BecomeBlinker)."""
    r = 8
    green_ramp = [
        (0.0, 0.3, 0.0, 1.0),
        (0.0, 0.7, 0.0, 1.0),
        (0.0, 1.0, 0.0, 1.0),
        (0.0, 0.7, 0.7, 1.0),
        (0.0, 0.3, 1.0, 1.0),
    ]
    n_frames = 10
    # Sweep: diagonal bands of the ramp move through the block; some
    # frames are fully transparent, some fully opaque (animation.rs
    # fills pattern with 5 leading AIR entries).
    x, y, z = np.meshgrid(*([np.arange(r)] * 3), indexing="ij")
    loc = x + y + z  # [r,r,r]
    frames = []
    for f in range(n_frames):
        vox = Space(GridAab.from_lower_size((0, 0, 0), (r, r, r)))
        value = (loc - f * 3) % (2 * len(green_ramp))
        for ci, col in enumerate(green_ramp):
            for cube in np.argwhere(value == ci + len(green_ramp)):
                vox.set(tuple(int(c) for c in cube), from_color(col))
        frames.append(
            Block(Recur(space=vox, resolution=r)).with_attributes(animated=True)
        )
    chained = _become_cycle(frames, period=6)

    # Fire: seeded noise flames cycling through 4 frames (Fire behavior
    # analog, precomputed).
    rng = np.random.default_rng(17)
    fire_frames = []
    fy = np.arange(r)[None, :, None] / r
    for f in range(4):
        vox = Space(GridAab.from_lower_size((0, 0, 0), (r, r, r)))
        noise = rng.random((r, r, r))
        mask = noise > (0.3 + 0.7 * fy)  # denser at the bottom
        for cube in np.argwhere(mask):
            heat = 1.0 - cube[1] / r + rng.random() * 0.2
            vox.set(
                tuple(int(c) for c in cube),
                from_color((1.0, float(np.clip(heat, 0, 1)) * 0.7, 0.05, 1.0)),
            )
        fire_frames.append(
            Block(Recur(space=vox, resolution=r)).with_attributes(animated=True)
        )
    fire = _become_cycle(fire_frames, period=4)

    # Blinker pair (animation.rs BECOME exhibit).
    red = from_color((0.9, 0.1, 0.1, 1.0), "blinker-on")
    dim = from_color((0.3, 0.05, 0.05, 1.0), "blinker-off")
    blink = _become_cycle([red, dim], period=30)

    sp = _exhibit_space((7, 3, 3))
    sp.set((1, 1, 1), chained[0])
    for xx in (3, 4):
        sp.set((xx, 1, 1), fire[0])
    sp.set((6, 1, 1), blink[0])
    return sp


def elevator_exhibit() -> Space:
    """exhibits/elevator.rs ELEVATOR: a tall underground shaft
    ("OUT OF SERVICE") — walls around a 3×16×3 void signalling there is
    something below."""
    sp = _exhibit_space((5, 16, 5))
    wall = from_color((0.5, 0.5, 0.55, 1.0), "shaft-wall")
    for y in range(16):
        for x in range(5):
            for z in range(5):
                if x in (0, 4) or z in (0, 4):
                    sp.set((x, y, z), wall)
    return sp


def knot_exhibit() -> Space:
    """exhibits/knot.rs KNOT: a double-strand torus knot carved at R32
    across a 5×5×3 block footprint (complex voxel shape stress).
    Geometry re-derived with vectorized NumPy from the cited math:
    cylindrical coords → torus cross-section → cross-section rotated by
    twists·angle → two strands offset ±split; stripes by strand angle."""
    res = 32
    fx, fy, fz = 5, 5, 3  # block footprint
    nx, ny, nz = fx * res, fy * res, fz * res
    toroidal_radius = res * 1.5
    split = res * 0.5625
    strand_radius = res * 0.25
    twists = 2.5

    # Voxel centers measured from the space midpoint.
    gx = np.arange(nx) - nx / 2 + 0.5
    gy = np.arange(ny) - ny / 2 + 0.5
    gz = np.arange(nz) - nz / 2 + 0.5
    X, Y, Z = np.meshgrid(gx, gy, gz, indexing="ij")
    rho = np.sqrt(X**2 + Y**2)  # cylindrical radius
    cross = np.stack([rho - toroidal_radius, Z], axis=-1)  # torus cross-section
    center_angle = np.arctan2(Y, X)
    ca = np.cos(center_angle * twists)
    sa = np.sin(center_angle * twists)
    rot = np.stack(
        [
            cross[..., 0] * ca - cross[..., 1] * sa,
            (cross[..., 0] * sa + cross[..., 1] * ca) / np.sqrt(2.0),
        ],
        axis=-1,
    )

    def strand(offset_sign):
        kx = rot[..., 0] + offset_sign * split
        ky = rot[..., 1]
        inside = kx**2 + ky**2 < strand_radius**2
        ang = np.arctan2(kx, ky) + center_angle
        return inside, ang

    in1, a1 = strand(-1.0)
    in2, a2 = strand(+1.0)
    a2 = a2 + np.pi  # second strand rotated so the stripes join up
    inside = in1 | in2
    angle = np.where(in1, a1, a2)
    unit = (angle / (2 * np.pi)) % 1.0
    stripe = np.where(unit < 0.25, 1, np.where((unit >= 0.5) & (unit < 0.75), 2, 0))

    paints = [
        from_color((0.7, 0.7, 0.7, 1.0)),
        from_color((0.1, 0.1, 0.9, 1.0)),
        from_color((0.9, 0.7, 0.1, 1.0)),
    ]
    sp = _exhibit_space((fx, fy, fz))
    # space_to_blocks role: chop the drawing grid into Recur blocks,
    # skipping empty cells.
    for bx in range(fx):
        for by in range(fy):
            for bz in range(fz):
                sub = inside[
                    bx * res : (bx + 1) * res,
                    by * res : (by + 1) * res,
                    bz * res : (bz + 1) * res,
                ]
                if not sub.any():
                    continue
                ssub = stripe[
                    bx * res : (bx + 1) * res,
                    by * res : (by + 1) * res,
                    bz * res : (bz + 1) * res,
                ]
                vox = Space(GridAab.from_lower_size((0, 0, 0), (res,) * 3))
                # Bulk fill: intern the three paints once, then write the
                # contents array directly (a 32³ python set() loop per
                # block would dominate city generation).
                idx = np.array([vox.ensure_block(b) for b in paints], np.uint16)
                vox.contents = np.where(sub, idx[ssub], 0).astype(np.uint16)
                sp.set((bx, by, bz), Block(Recur(space=vox, resolution=res)))
    return sp


def zoom_exhibit() -> Space:
    """exhibits/zoom.rs ZOOM: a voxel specimen exploded into an 8³ array
    of Zoom blocks, each magnifying one sub-cube; invisible zoomed cells
    are cancelled to AIR (zoom.rs visible() check)."""
    from ..block import evaluate

    r = 16
    vox = Space(GridAab.from_lower_size((0, 0, 0), (r, r, r)))
    post = from_color((0.3, 0.3, 0.35, 1.0))
    lamp = from_color((1.0, 0.95, 0.6, 1.0))
    c = r // 2
    for y in range(r):
        vox.set((c, y, c), post)
        if y > r - 5:
            for dx, dz in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                vox.set((c + dx, y, c + dz), lamp)
    specimen = Block(Recur(space=vox, resolution=r))

    scale = 8
    # Visibility precheck straight off the specimen's evaluated voxels:
    # a zoomed cell is visible iff its sub-cube holds any alpha>0 voxel
    # (cheaper than evaluating all scale³ Zoom blocks to find the ~2%
    # that survive; matches zoom.rs's visible() cancellation).
    ev = evaluate(specimen)
    alpha = np.asarray(ev.voxels.color[..., 3])
    sub = r // scale
    occupied = (
        alpha.reshape(scale, sub, scale, sub, scale, sub).max(axis=(1, 3, 5)) > 0
    )
    sp = _exhibit_space((scale, scale, scale))
    for x, y, z in np.argwhere(occupied):
        sp.set(
            (int(x), int(y), int(z)),
            specimen.with_modifier(
                Zoom(scale=scale, offset=(int(x), int(y), int(z)))
            ),
        )
    return sp


def destruction_exhibit() -> Space:
    """exhibits/destruction.rs DESTRUCTION: a block at 7 destruction
    stages. Each stage composites the material with a Voronoi mask
    (Composite In reversed); activating a stage Becomes the next one, so
    clicking animates the destruction."""
    from .alg import voronoi_pattern

    width = 7
    res = 16
    rng = np.random.default_rng(3887829)
    pts = rng.random((32, 3))
    material = from_color((0.2, 0.6, 0.2, 1.0), "grass-block")

    stages: list[Block] = []
    next_stage: Block | None = None
    # Build from most-destroyed (last) to first so each stage can chain
    # its activation to the next.
    for stage in reversed(range(width)):
        fraction = (stage + 0.5) / width
        region = voronoi_pattern(
            res, [(tuple(p), 1 if p[1] <= fraction else 0) for p in pts]
        )
        mask_space = Space(GridAab.from_lower_size((0, 0, 0), (res,) * 3))
        white = from_color((1.0, 1.0, 1.0, 1.0))
        for cube in np.argwhere(region == 1):
            mask_space.set(tuple(int(c) for c in cube), white)
        mask = Block(Recur(space=mask_space, resolution=res))
        destroyed = material.with_modifier(
            Composite(source=mask, operator="in", reverse=True)
        )
        if next_stage is not None:
            destroyed = destroyed.with_attributes(
                activation_action=Become(next_stage)
            )
        stages.append(destroyed)
        next_stage = destroyed
    stages.reverse()

    sp = _exhibit_space((width + 2, 3, 3))
    for i, b in enumerate(stages):
        sp.set((1 + i, 1, 1), b)
    return sp


def trees_exhibit() -> Space:
    """exhibits/trees.rs TREES: a 4×4 grid of procedural trees of
    increasing allowed height, on grass, with a growth-stage debug row."""
    from .alg import make_tree

    n, spacing = 4, 6
    size = ((n - 1) * spacing + 5, 20, (n - 1) * spacing + 5)
    sp = _exhibit_space(size)
    grass = from_color((0.2, 0.55, 0.2, 1.0), "grass")
    sp.fill(GridAab.from_lower_size((0, 0, 0), (size[0], 1, size[2])), grass)
    rng = np.random.default_rng(128947981240 % (2**32))
    for ix in range(n):
        for iz in range(n):
            make_tree(
                sp,
                (2 + ix * spacing, 1, 2 + iz * spacing),
                height=2 + ix + iz * 2,
                rng=rng,
            )
    # Growth-stage row: increasingly dense leaf blocks for debugging.
    for i in range(4):
        leaves_res = 4
        vox = Space(GridAab.from_lower_size((0, 0, 0), (leaves_res,) * 3))
        leaf = from_color((0.15, 0.45, 0.12, 1.0))
        density = (i + 1) / 4.0
        lr = np.random.default_rng(i)
        for cube in np.argwhere(lr.random((leaves_res,) * 3) < density):
            vox.set(tuple(int(c) for c in cube), leaf)
        sp.set((2 * i, 1, 0), Block(Recur(space=vox, resolution=leaves_res)))
    return sp


def transparency_structure_exhibit() -> Space:
    """exhibits/transparency.rs TRANSPARENCY_WHOLE_BLOCK +
    TRANSPARENCY_SHRUNKEN_BLOCK: four windowpane walls (one per horizontal
    facing) with alpha increasing by row, around a checkerboard of two
    half-cube R2 glass slabs (depth-sorting/blending stress)."""
    colors = [
        (1.0, 0.5, 0.5),
        (0.5, 1.0, 0.5),
        (0.5, 0.5, 1.0),
        (0.9, 0.9, 0.9),
    ]
    alphas = [0.25, 0.5, 0.75, 0.95]
    sp = _exhibit_space((7, 5, 7))
    cx = cz = 3
    # Four panes at distance 3 from center, one color each.
    walls = [
        [(cx + dx, cz + 3) for dx in (-1, 0, 1)],
        [(cx + 3, cz + dz) for dz in (-1, 0, 1)],
        [(cx + dx, cz - 3) for dx in (-1, 0, 1)],
        [(cx - 3, cz + dz) for dz in (-1, 0, 1)],
    ]
    for color, cells in zip(colors, walls):
        for y, a in enumerate(alphas):
            for (x, z) in cells:
                sp.set((x, y, z), Block(Atom(color=color + (a,))))

    # Center: checkerboard of two R2 half-slabs at alpha 0.99.
    r2 = 2
    slabs = []
    for which in range(2):
        vox = Space(GridAab.from_lower_size((0, 0, 0), (r2, r2, r2)))
        col = (0.9, 0.9, 1.0, 0.99) if which == 0 else (0.05, 0.05, 0.05, 0.99)
        for x in range(r2):
            for y in range(r2):
                for z in range(r2):
                    if (x >= 1) == (which == 0):
                        vox.set((x, y, z), Block(Atom(color=col)))
        slabs.append(Block(Recur(space=vox, resolution=r2)))
    for x in (2, 3, 4):
        for y in range(4):
            for z in (2, 3, 4):
                if (x, z) != (cx, cz):
                    sp.set((x, y, z), slabs[(x + y + z) % 2])
    return sp


def inventory_exhibit() -> Space:
    """exhibits/inventory.rs INVENTORY: a tray block with a 9-slot
    3×3-row InvInBlock configuration, shown holding item blocks next to
    an identical empty tray (in-block inventory rendering stress)."""
    from ..block import BlockAttributes, InvInBlock, IconRow, InventoryModifier

    res = 16
    steel = from_color((0.55, 0.57, 0.6, 1.0))
    vox = Space(GridAab.from_lower_size((0, 0, 0), (res,) * 3))
    for x in range(res):
        for z in range(res):
            vox.set((x, 0, z), steel)  # tray bottom
            if x in (0, res - 1) or z in (0, res - 1):
                vox.set((x, 1, z), steel)  # tray rim
    inv_config = InvInBlock(
        inventory_size=9,
        icon_scale=4,
        render_resolution=res,
        icon_rows=(
            IconRow(first_slot=0, count=3, origin=(1, 1, 1), stride=(5, 0, 0)),
            IconRow(first_slot=3, count=3, origin=(1, 1, 6), stride=(5, 0, 0)),
            IconRow(first_slot=6, count=3, origin=(1, 1, 11), stride=(5, 0, 0)),
        ),
    )
    tray = Block(
        Recur(space=vox, resolution=res),
        attributes=BlockAttributes(display_name="Tray", inventory=inv_config),
    )
    items = [
        from_color((0.9, 0.1, 0.1, 1.0), "red item"),
        from_color((0.1, 0.9, 0.1, 1.0), "green item"),
        from_color((0.1, 0.1, 0.9, 1.0), "blue item"),
        from_color((1.0, 0.95, 0.6, 1.0), "lamp"),
    ]
    filled = tray.with_modifier(
        InventoryModifier(icons=tuple(items), slots=tuple(items))
    )
    sp = _exhibit_space((5, 3, 3))
    sp.set((1, 1, 1), filled)
    sp.set((3, 1, 1), tray.with_modifier(InventoryModifier(icons=(), slots=())))
    return sp


def chunking_exhibit() -> Space:
    """exhibits/chunking.rs CHUNK_CHART: ChunkChart::<16>::new(16*4.99)
    visualization — one translucent cube per chunk in view, showing the
    rounded view volume the mesh updater walks."""
    from ..math.chunking import ChunkChart

    chart = ChunkChart(16.0 * 4.99, chunk_size=16)
    offsets = chart.chunks()  # i32[N,3] chunk offsets, near-to-far
    r = int(np.abs(offsets).max()) + 1
    sp = _exhibit_space((2 * r + 1, 2 * r + 1, 2 * r + 1))
    shell = from_color((0.4, 0.7, 1.0, 0.25), "chunk")
    core = from_color((1.0, 0.85, 0.2, 1.0), "chunk-origin")
    # Only the boundary chunks are drawn opaque-ish; interior stays air so
    # the volume reads as a shell (visualization(), chunking.rs).
    occupied = np.zeros((2 * r + 1,) * 3, bool)
    occupied[tuple((offsets + r).T)] = True
    for off in offsets:
        x, y, z = (int(v) for v in off + r)
        neighbors = [
            (x + dx, y + dy, z + dz)
            for dx, dy, dz in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                               (0, 0, 1), (0, 0, -1))
        ]
        on_shell = any(
            not (
                0 <= nx < occupied.shape[0]
                and 0 <= ny < occupied.shape[1]
                and 0 <= nz < occupied.shape[2]
            )
            or not occupied[nx, ny, nz]
            for nx, ny, nz in neighbors
        )
        if on_shell:
            sp.set((x, y, z), shell)
    sp.set((r, r, r), core)
    return sp


def _slab_block(height_voxels: int, resolution: int) -> Block:
    """A bottom slab filling height_voxels/resolution of the cube
    (make_slab role, content/blocks in the reference)."""
    vox = Space(GridAab.from_lower_size((0, 0, 0), (resolution,) * 3))
    mat = from_color((0.75, 0.75, 0.7, 1.0), f"slab {height_voxels}/{resolution}")
    for y in range(min(height_voxels, resolution)):
        for x in range(resolution):
            for z in range(resolution):
                vox.set((x, y, z), mat)
    return Block(Recur(space=vox, resolution=resolution))


def _rotation_py_to(direction) -> int:
    """Index of a proper rotation (det=+1) mapping +Y to `direction`
    (GridRotation::from_to role, rotation.rs)."""
    target = np.asarray(direction, np.int32)
    y = np.array([0, 1, 0], np.int32)
    for i, m in enumerate(ROTATION_MATRICES):
        if int(np.round(np.linalg.det(m))) == 1 and (m @ y == target).all():
            return i
    raise ValueError(f"no rotation maps +Y to {direction}")


def collision_exhibit() -> Space:
    """exhibits/collision.rs COLLISION: half-slabs rotated so their flat
    side faces each compass offset (a 3×3 ring), plus a staircase of
    slabs of decreasing height — the character-vs-voxel-collision test
    floor."""
    sp = _exhibit_space((7, 3, 6))
    half = _slab_block(2, 4)
    for dx in (-1, 0, 1):
        for dz in (-1, 0, 1):
            if dx == 0 and dz == 0:
                rot = rotation_from_name("RXyZ")  # upside down
            elif dx != 0 and dz != 0:
                continue  # diagonal offsets aren't faces: identity slot skipped
            else:
                rot = _rotation_py_to((dx, 0, dz))
            sp.set((2 + dx, 1, 2 + dz), half.with_modifier(Rotate(rot)))
    # Staircase: slab height 4/4 down to 1/4 along z.
    for i in range(4):
        sp.set((5, 1, 1 + i), _slab_block(4 - i, 4))
    return sp


def _terrain_image(edge: int = 16) -> np.ndarray:
    """A procedural stand-in for the reference's terrain-image.png asset
    (we do not copy assets): sky gradient over a green hill with a brown
    cave mouth; alpha-0 pixels in the top corners exercise the AIR rule."""
    img = np.zeros((edge, edge, 4), np.uint8)
    rr = np.arange(edge)
    hill = (edge * 0.55 + (edge * 0.2) * np.sin(rr / edge * 3.2)).astype(int)
    for c in range(edge):
        for r in range(edge):
            y = edge - 1 - r  # image row 0 is the top
            if y > hill[c]:
                img[r, c] = (120, 170, 230, 255)  # sky
            elif y == hill[c]:
                img[r, c] = (60, 160, 40, 255)  # grass lip (green > blue)
            else:
                img[r, c] = (110, 80, 40, 255)  # earth
    img[0, 0] = img[0, edge - 1] = (0, 0, 0, 0)  # transparent corners
    img[edge // 2 : edge // 2 + 3, edge // 2 : edge // 2 + 3] = (30, 20, 10, 255)
    return img


def images_exhibit() -> Space:
    """exhibits/images.rs IMAGES: block_from_image() of the terrain image
    under rotations RXYZ, RXyZ, RXZY, RxYZ; green-dominant pixels get a
    thickness-2 brush (rotated with the block) so the grass lip sticks
    out of the slab."""
    from .alg import block_from_image, default_srgb_brush
    from ..space.drawing import VoxelBrush

    sp = _exhibit_space((9, 3, 3))
    for i, name in enumerate(("RXYZ", "RXyZ", "RXZY", "RxYZ")):
        rot = rotation_from_name(name)
        m = ROTATION_MATRICES[rot]

        def pixel_fn(pixel, m=m):
            r, g, b, a = pixel
            if (r > b or g > b) and a > 0:
                base = default_srgb_brush(pixel)
                block = base.points[0][1]
                return VoxelBrush(
                    tuple((tuple(m @ np.array([0, 0, dz])), block) for dz in (0, 1))
                )
            return default_srgb_brush(pixel)

        sp.set(
            (1 + 2 * i, 1, 1),
            block_from_image(_terrain_image(), rot, pixel_fn, display_name=name),
        )
    return sp


def make_some_blocks_exhibit() -> Space:
    """exhibits/make_some_blocks.rs: rows of make_some_blocks::<5..1>()
    atoms facing their voxel-block counterparts."""
    from .testing import make_some_blocks, make_some_voxel_blocks

    rows = 5
    sp = _exhibit_space((3, rows, rows))
    for y in range(rows):
        n = rows - y
        atoms = make_some_blocks(n)
        voxels = make_some_voxel_blocks(n)
        for h in range(n):
            sp.set((0, y, h), atoms[h])
            sp.set((2, y, h), voxels[h])
    return sp


def misc_exhibit() -> Space:
    """exhibits/misc.rs MISC_BLOCKS: the demo Crate and Greebly blocks on
    their own pedestal (odd blocks that fit nowhere else)."""
    res = 16
    # Crate: plank box with corner posts and an X brace on each face.
    plank = from_color((0.72, 0.5, 0.25, 1.0))
    post = from_color((0.5, 0.33, 0.15, 1.0))
    vox = Space(GridAab.from_lower_size((0, 0, 0), (res,) * 3))
    for x in range(res):
        for y in range(res):
            for z in range(res):
                edges = sum(c in (0, res - 1) for c in (x, y, z))
                if edges >= 2:
                    vox.set((x, y, z), post)
                elif edges == 1:
                    diag = abs(x - y) <= 1 or abs(y - z) <= 1 or abs(x - z) <= 1 \
                        or abs(x + y - res + 1) <= 1 or abs(y + z - res + 1) <= 1 \
                        or abs(x + z - res + 1) <= 1
                    vox.set((x, y, z), post if diag else plank)
    crate = Block(Recur(space=vox, resolution=res))

    # Greebly: an asymmetric gadget of pipes and fins.
    metal = from_color((0.45, 0.5, 0.55, 1.0))
    accent = from_color((0.8, 0.3, 0.1, 1.0))
    gv = Space(GridAab.from_lower_size((0, 0, 0), (res,) * 3))
    for y in range(res):
        gv.set((res // 2, y, res // 2), metal)
    for x in range(2, res - 2):
        gv.set((x, res // 2, res // 2), metal)
        if x % 3 == 0:
            for dy in range(1, 4):
                gv.set((x, res // 2 + dy, res // 2), accent)
    for z in range(4, res - 4):
        gv.set((res // 2, 4, z), metal)
    greebly = Block(Recur(space=gv, resolution=res))

    sp = _exhibit_space((4, 3, 3))
    sp.set((1, 1, 1), crate)
    sp.set((2, 1, 1), greebly)
    return sp


def smallest_exhibit() -> Space:
    """exhibits/smallest.rs SMALLEST: "World's Smallest Voxel" — a single
    voxel at Resolution::MAX = R128 (1/128th of a block edge), centered on
    the cube floor. The backing space is one cube at offset (64, 0, 64)
    within the R128 grid, exactly like the reference."""
    r = 128
    vox = Space(GridAab.from_lower_size((r // 2, 0, r // 2), (1, 1, 1)))
    vox.set((r // 2, 0, r // 2), from_color((0.04, 0.04, 0.04, 1.0)))
    block = Block(
        Recur(space=vox, resolution=r),
        attributes=BlockAttributes(display_name="World's Smallest Voxel"),
    )
    sp = _exhibit_space((1, 2, 1))
    sp.set((0, 0, 0), block)
    return sp


def ui_blocks_exhibit() -> Space:
    """exhibits/ui.rs UI_BLOCKS + UI_PROGRESS_BAR: the UI system's blocks
    laid out for inspection — tool icons, widget furniture (frame, button,
    crosshair, toolbar), and a column of progress bars at 0..100%."""
    from ..universe.cursor import Activate, PlaceBlock, RemoveBlock, Stack, tool_icon
    from ..vui.widgets import Button, Crosshair, Frame, ProgressBar

    sp = _exhibit_space((8, 6, 2))

    # Icons row: tool icons (inv::Icons provider role) — PlaceBlock shows
    # its block; intrinsic-iconless tools render as labeled buttons.
    tools = [
        Stack(PlaceBlock(from_color((0.8, 0.2, 0.2, 1.0), "red")), 10),
        Stack(PlaceBlock(from_color((0.2, 0.4, 0.9, 1.0), "blue")), 1),
        RemoveBlock(),
        Activate(),
    ]
    col = 0
    for t in tools:
        icon = tool_icon(t)
        if icon is not None:
            sp.set((col, 4, 0), icon)
            col += 1

    # Widget furniture drawn straight into the exhibit space.
    Crosshair().draw(sp, (col + 1, 4, 0))
    Frame(width=3, height=1).draw(sp, (0, 3, 0))
    Button(text="OK").draw(sp, (4, 3, 0))

    # Progress bars at 0/50/100% (UI_PROGRESS_BAR column).
    for i, fraction in enumerate((0.0, 0.5, 1.0)):
        ProgressBar(fraction=fraction, width=5).draw(sp, (1, i, 1))
    return sp


EXHIBITS: tuple[Exhibit, ...] = (
    Exhibit("Transparency", "Alpha blending of surfaces", transparency_exhibit),
    Exhibit("Composite", "Porter-Duff block combination", composite_exhibit),
    Exhibit("Rotations", "All 48 grid rotations", rotation_exhibit),
    Exhibit("Resolutions", "Voxel detail R2-R32", resolution_exhibit),
    Exhibit("Move", "Move modifier phases", move_exhibit),
    Exhibit("Text", "Voxel text blocks", text_exhibit),
    Exhibit("Colors", "Color fidelity swatches", color_exhibit),
    Exhibit("Animation", "Blocks whose definition is animated", animation_exhibit),
    Exhibit("Elevator", "OUT OF SERVICE", elevator_exhibit),
    Exhibit("Knot", "Complex voxel shape", knot_exhibit),
    Exhibit("Zoom", "Modifier::Zoom exploded specimen", zoom_exhibit),
    Exhibit("Destruction", "Animation prototype", destruction_exhibit),
    Exhibit("Trees", "Procedural tree growth", trees_exhibit),
    Exhibit(
        "Glass", "Depth sorting and blending", transparency_structure_exhibit
    ),
    Exhibit("Inventory", "Modifier::Inventory trays", inventory_exhibit),
    Exhibit("ChunkChart", "World chunks in view at 4.99", chunking_exhibit),
    Exhibit("Collision", "Character/world collision floor", collision_exhibit),
    Exhibit("Images", "block_from_image() rotations", images_exhibit),
    Exhibit("Blocks", "make_some_blocks() test sets", make_some_blocks_exhibit),
    Exhibit("Misc", "Crate and greebly", misc_exhibit),
    Exhibit(
        "Smallest", "1/128th of a block", smallest_exhibit, heavy=True
    ),
    Exhibit("UI Blocks", "Icons, widgets, progress", ui_blocks_exhibit),
)


def place_exhibit(
    city: Space, exhibit: Exhibit, origin, pedestal: Block, prebuilt: Space = None
) -> None:
    """Copy an exhibit's space into the city at `origin`, on a pedestal
    slab, with a voxel-text name sign (city.rs exhibit placement role).
    `prebuilt` lets the caller reuse a space it already constructed."""
    sp = prebuilt if prebuilt is not None else exhibit.factory()
    size = sp.bounds.size
    ox, oy, oz = origin
    # Pedestal slab under the exhibit footprint.
    city.fill(
        GridAab.from_lower_size((ox, oy, oz), (size[0], 1, size[2])), pedestal
    )
    contents = sp.contents
    for rel in np.argwhere(contents != 0):
        blk = sp.palette[int(contents[tuple(rel)])]
        cube = (
            ox + int(rel[0]),
            oy + 1 + int(rel[1] - 0),
            oz + int(rel[2]),
        )
        if city.bounds.contains_cube(cube):
            city.set(cube, blk)
    # Name sign: one text block per tile along the front edge.
    from ..text.font import text_tile_count

    n = min(text_tile_count(exhibit.name, 16), size[0])
    for i in range(n):
        cube = (ox + i, oy + 1, oz - 1)
        if city.bounds.contains_cube(cube):
            city.set(
                cube,
                Block(
                    TextPrimitive(
                        text=exhibit.name,
                        resolution=16,
                        color=(1.0, 1.0, 1.0, 1.0),
                        tile=(i, 0),
                    )
                ),
            )
