"""Content-generation helper algorithms.

Copied unchanged from `aic_tpu/content/alg.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

Role of the reference's helper library (all-is-cubes-content/src/alg.rs,
clouds.rs, tree.rs): voronoi voxel patterns, color gradients, wall
iteration, space-to-space copies, cloud layers, and procedural trees —
the vocabulary the templates' worldgen is written in. Numpy-vectorized
re-designs (whole-pattern array evaluation instead of per-cube closures).
"""

from __future__ import annotations

import numpy as np

from ..block import AIR, Atom, Block, from_color
from ..math.grid import GridAab


def voronoi_pattern(resolution: int, points, rng=None, wrap: bool = True):
    """u16[R,R,R] region ids: nearest seed point per voxel
    (alg.rs:69 voronoi_pattern; `wrap` = toroidal distance, used so block
    patterns tile seamlessly). `points`: [(pos 3-tuple in [0,1)³, id)]."""
    r = int(resolution)
    seeds = np.asarray([p for p, _ in points], np.float64)  # [N,3] in [0,1)
    ids = np.asarray([i for _, i in points])
    g = (np.arange(r) + 0.5) / r
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    vox = np.stack([x, y, z], axis=-1)[..., None, :]  # [R,R,R,1,3]
    d = vox - seeds  # [R,R,R,N,3]
    if wrap:
        d = d - np.round(d)
    dist = (d**2).sum(-1)
    return ids[np.argmin(dist, axis=-1)]


def gradient_lookup(gradient, value: float):
    """alg.rs:287: pick from a block gradient by value in [0, 1]."""
    n = len(gradient)
    return gradient[int(np.clip(value * n, 0, n - 1))]


def scale_color(block: Block, scalar: float, quantization: float = 1.0 / 256.0) -> Block:
    """alg.rs:267: scale an Atom block's reflectance, quantized so nearby
    scalars share palette entries."""
    p = block.primitive
    if not isinstance(p, Atom):
        return block
    q = max(quantization, 1e-9)
    color = tuple(
        float(np.round(c * scalar / q) * q) for c in p.color[:3]
    ) + (p.color[3],)
    import dataclasses

    return dataclasses.replace(block, primitive=dataclasses.replace(p, color=color))


def four_walls(bounds: GridAab):
    """alg.rs:177 four_walls: for each of the four vertical walls of
    `bounds`, yield (origin, along_axis_unit, length, depth_unit) so
    callers can iterate wall columns facing inward."""
    lx, ly, lz = bounds.lower
    ux, uy, uz = bounds.upper
    w = ux - lx
    d = uz - lz
    return [
        ((lx, ly, lz), (1, 0, 0), w, (0, 0, 1)),      # -Z wall, inward +Z
        ((ux - 1, ly, lz), (0, 0, 1), d, (-1, 0, 0)),  # +X wall, inward -X
        ((ux - 1, ly, uz - 1), (-1, 0, 0), w, (0, 0, -1)),  # +Z wall
        ((lx, ly, uz - 1), (0, 0, -1), d, (1, 0, 0)),  # -X wall
    ]


def space_to_space_copy(src, src_bounds: GridAab, dst, offset) -> None:
    """alg.rs:227: copy a region of blocks between spaces (palette-mapped
    per cube)."""
    off = np.asarray(offset, np.int64)
    for cube in src_bounds.interior_iter():
        blk = src.block_at(cube)
        target = tuple(int(v) for v in np.asarray(cube) + off)
        if dst.bounds.contains_cube(target):
            dst.set(target, blk)


def clouds(space, region: GridAab, density: float = 0.1, seed: int = 0) -> None:
    """clouds.rs:17: fill a sky layer with semi-transparent white cloud
    blocks; alpha from a smoothed random field thresholded by density."""
    rng = np.random.default_rng(seed)
    size = region.size
    field = rng.random((size[0], size[2]))
    # 2-pass box smoothing for cloud-scale coherence.
    for _ in range(2):
        field = (
            field
            + np.roll(field, 1, 0) + np.roll(field, -1, 0)
            + np.roll(field, 1, 1) + np.roll(field, -1, 1)
        ) / 5.0
    lo = region.lower
    # cloud_block (clouds.rs:28): displayed alpha is level × 0.2, always
    # semi-transparent, no collision.
    levels = [0.25, 0.5, 0.75, 1.0]
    from ..block import BlockAttributes, COLLISION_NONE

    blocks = {
        a: Block(
            Atom(color=(1.0, 1.0, 1.0, a * 0.2), collision=COLLISION_NONE),
            BlockAttributes(display_name="Cloud"),
        )
        for a in levels
    }
    thresh = np.quantile(field, 1.0 - density) if density < 1.0 else field.min()
    for xi in range(size[0]):
        for zi in range(size[2]):
            v = field[xi, zi]
            if v < thresh:
                continue
            a = gradient_lookup(levels, (v - thresh) / max(field.max() - thresh, 1e-6))
            for yi in range(size[1]):
                space.set((lo[0] + xi, lo[1] + yi, lo[2] + zi), blocks[a])


def make_tree(space, base, height: int, rng=None, leaves=None, log=None) -> None:
    """tree.rs:120 make_tree: a trunk with a tapering leaf canopy
    (TreeGrowth radius schedule: radius shrinks toward the top)."""
    rng = rng or np.random.default_rng(0)
    log = log or from_color((0.45, 0.32, 0.18, 1.0), "log")
    leaves = leaves or from_color((0.15, 0.45, 0.12, 1.0), "leaves")
    bx, by, bz = base
    for y in range(height):
        cube = (bx, by + y, bz)
        if space.bounds.contains_cube(cube):
            space.set(cube, log)
    # Canopy: radius from TreeGrowth::from_radius-style shrink.
    for layer, y in enumerate(range(height - 2, height + 2)):
        radius = max(2 - layer // 2, 0)
        for dx in range(-radius, radius + 1):
            for dz in range(-radius, radius + 1):
                if abs(dx) + abs(dz) > radius + 1:
                    continue
                cube = (bx + dx, by + y, bz + dz)
                if space.bounds.contains_cube(cube) and space.block_at(cube) == AIR:
                    space.set(cube, leaves)


# ---------------------------------------------------------------------------
# Image → block (reference: all-is-cubes/src/content/load_image.rs)


def default_srgb_brush(pixel):
    """load_image.rs:251 `default_srgb`: zero-alpha pixels become AIR (so
    collision/selection match expectations); others a solid sRGB atom."""
    from ..math.color import np_srgb8_to_linear
    from ..space.drawing import VoxelBrush

    r, g, b, a = (int(v) for v in pixel)
    if a == 0:
        return VoxelBrush.single(AIR)
    rgb = np_srgb8_to_linear(np.array([r, g, b]))
    return VoxelBrush.single(
        Block(Atom(color=(float(rgb[0]), float(rgb[1]), float(rgb[2]), a / 255.0)))
    )


def space_from_image(image: np.ndarray, rotation: int, pixel_function=None):
    """u8[H,W,4] sRGB image → Space, one brush stamp per pixel.

    Reference: load_image.rs:167 `space_from_image` — pixel (x, y) of the
    image (y flipped so the image reads upright) lands at the rotated
    position of (x, y, 0), with the rotation shifted to the positive
    octant (`to_positive_octant_transform`); the brush itself is NOT
    rotated (callers rotate their brushes, exhibits/images.rs)."""
    from ..math.grid import ROTATION_MATRICES
    from ..space import Space

    if pixel_function is None:
        pixel_function = default_srgb_brush
    h, w = image.shape[:2]
    edge = max(h, w)
    m = ROTATION_MATRICES[rotation]
    # Positive-octant shift for cube coords: axes fed by a negative basis
    # image get offset edge-1 (rotation.rs to_positive_octant_transform).
    t = np.where(m.sum(axis=1) < 0, edge - 1, 0)

    # Bounds = transform of the image slab, expanded by brush extents.
    corners = []
    for cx in (0, w - 1):
        for cy in (0, h - 1):
            corners.append(m @ np.array([cx, cy, 0]) + t)
    corners = np.array(corners)
    lo, hi = corners.min(0), corners.max(0) + 1
    # Brush extents across all pixels (minkowski_sum role).
    brushes = {}
    for r in range(h):
        for c in range(w):
            pix = tuple(int(v) for v in image[r, c])
            if pix not in brushes:
                brushes[pix] = pixel_function(pix)
    offs = np.array(
        [p for br in brushes.values() for (p, _) in br.points] or [(0, 0, 0)]
    )
    lo = lo + np.minimum(offs.min(0), 0)
    hi = hi + np.maximum(offs.max(0), 0)
    space = Space(GridAab.from_lower_upper(tuple(lo), tuple(hi)))
    for r in range(h):
        for c in range(w):
            pix = tuple(int(v) for v in image[r, c])
            pos = m @ np.array([c, h - 1 - r, 0]) + t
            brushes[pix].paint(space, tuple(pos))
    return space


def block_from_image(
    image: np.ndarray, rotation: int, pixel_function=None, display_name: str = ""
) -> Block:
    """Square u8[R,R,4] image → resolution-R voxel block
    (load_image.rs:222 `block_from_image`)."""
    from ..block import BlockAttributes, Recur

    h, w = image.shape[:2]
    if h != w or w & (w - 1) or w > 128:
        raise ValueError(f"image must be square pow2 ≤128, got {w}x{h}")
    sp = space_from_image(image, rotation, pixel_function)
    return Block(
        Recur(space=sp, resolution=w),
        attributes=BlockAttributes(display_name=display_name),
    )
