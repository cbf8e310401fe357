"""light_bench_space: the canonical light-benchmark scene.

Copied unchanged from `aic_tpu/content/testing.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

Reference: all-is-cubes/src/content/testing.rs:25 — a ground slab plus a
grid of randomized 6³ "sections" (solid buildings / hollow shells / random
noise, occasionally semi-transparent), under an octant sky, sized 54×16×54
by the light benchmark (all-is-cubes/benches/light.rs).

RNG streams REPLICATE the reference bit-exactly (`RefRng` below:
Xoshiro256Plus seeded per section via SplitMix64, with rand-0.9 sampling
semantics), so section colors/shapes match the reference's — verified
pixel-level against the `template-light-bench` renderer golden
(tests/test_reference_goldens.py).
"""

from __future__ import annotations

import numpy as np

from ..block import AIR, Block, from_color
from ..math.color import np_srgb8_to_linear
from ..math.grid import GridAab
from ..space import Sky, Space, SpacePhysics

_U64 = (1 << 64) - 1


class RefRng:
    """Xoshiro256Plus + the rand-crate sampling used by the reference
    (rand_xoshiro 0.8 / rand 0.9): seed_from_u64's SplitMix64 expansion,
    next_u32 = high word, Standard f32 = 24 mantissa bits, inclusive
    float ranges via the (high-low)/max_rand scale, Bernoulli via a
    2^64-scaled integer threshold, and Lemire widening-multiply integer
    ranges (the ~2^-32 rejection/correction branches are unreachable for
    the tiny ranges used here and are omitted)."""

    def __init__(self, seed_u64: int):
        x = seed_u64 & _U64
        s = []
        for _ in range(4):
            x = (x + 0x9E3779B97F4A7C15) & _U64
            z = x
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
            s.append(z ^ (z >> 31))
        self.s = s

    def next_u64(self) -> int:
        s = self.s
        result = (s[0] + s[3]) & _U64
        t = (s[1] << 17) & _U64
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = ((s[3] << 45) | (s[3] >> 19)) & _U64
        return result

    def next_u32(self) -> int:
        return self.next_u64() >> 32

    def random_f32_01_inclusive(self) -> float:
        # random_range(0.0..=1.0): value0_1 * scale with value0_1 =
        # (u32 >> 8) * 2^-24 and scale = 1 / ((2^24 - 1) * 2^-24).
        u = self.next_u32() >> 8
        value0_1 = np.float32(u) * np.float32(2.0**-24)
        scale = np.float32(1.0) / (
            np.float32(2**24 - 1) * np.float32(2.0**-24)
        )
        return float(value0_1 * scale)

    def random_bool(self, p: float) -> bool:
        return self.next_u64() < int(p * 2.0**64)

    def random_range_u32(self, n: int) -> int:
        return (self.next_u32() * n) >> 32

SECTION_WIDTH = 6
MARGIN = 4
SECTION_SPACING = SECTION_WIDTH + MARGIN

ALMOST_BLACK = np_srgb8_to_linear(np.array([0x3D, 0x3D, 0x3D]))  # palette.rs:82
DAY_SKY = np_srgb8_to_linear(np.array([243, 243, 255]))


def light_bench_space(requested_size=(54, 16, 54)) -> Space:
    w, h, d = requested_size
    nx = (w - MARGIN) // SECTION_SPACING
    nz = (d - MARGIN) // SECTION_SPACING
    section_height = max(h - 2, 2)
    yup = section_height * 4 // 14
    ydown = section_height - yup

    bounds = GridAab.from_lower_upper(
        (0, -ydown - 1, 0),
        (SECTION_SPACING * nx + MARGIN, 1 + yup, SECTION_SPACING * nz + MARGIN),
    )
    sky = Sky.from_octants(
        # testing.rs:124: octant order (x, y, z) sign bits; ground below,
        # bright +Y on -X side, dim +Y on +X side.
        np.array(
            [
                ALMOST_BLACK, ALMOST_BLACK, DAY_SKY * 2.0, DAY_SKY * 2.0,
                ALMOST_BLACK, ALMOST_BLACK, DAY_SKY * 0.5, DAY_SKY * 0.5,
            ],
            np.float32,
        ),
    )
    space = Space(
        bounds,
        physics=SpacePhysics(sky=sky, light_max_distance=min(max(w, d), 255)),
    )

    # Ground: everything below the top `yup` layers.
    ground = GridAab.from_lower_upper(
        bounds.lower, (bounds.upper[0], bounds.upper[1] - yup, bounds.upper[2])
    )
    space.fill(ground, from_color((0.5, 0.5, 0.5, 1.0), "ground"))

    for sx in range(nx):
        for sz in range(nz):
            # testing.rs:67 — per-section Xoshiro256Plus, seed sx+sz*nx;
            # draw order: r, g, b, alpha-bool, shape.
            rng = RefRng(sx + sz * nx)
            section = GridAab.from_lower_size(
                (MARGIN + sx * SECTION_SPACING, -ydown + 1, MARGIN + sz * SECTION_SPACING),
                (SECTION_WIDTH, section_height, SECTION_WIDTH),
            )
            color = from_color(
                (
                    rng.random_f32_01_inclusive(),
                    rng.random_f32_01_inclusive(),
                    rng.random_f32_01_inclusive(),
                    0.5 if rng.random_bool(0.125) else 1.0,
                ),
                f"section{sx},{sz}",
            )
            shape = rng.random_range_u32(3)
            if shape == 0:
                space.fill(section, color)
            elif shape == 1:
                # Underground hollow room: solid fill stops `yup` below
                # the section top (testing.rs:83 shrink(PY, yup)), then
                # the full-height interior (x/z shrunk by 1) is carved
                # to air — carving through the ground slab too.
                solid = GridAab.from_lower_upper(
                    section.lower,
                    (section.upper[0], section.upper[1] - yup, section.upper[2]),
                )
                space.fill(solid, color)
                interior = GridAab.from_lower_upper(
                    (section.lower[0] + 1, section.lower[1], section.lower[2] + 1),
                    (section.upper[0] - 1, section.upper[1], section.upper[2] - 1),
                )
                space.fill(interior, AIR)
            else:
                # Noise: EVERY cube of the section is written (air
                # overwrites ground below grade — testing.rs:105 fill
                # returns Some(&AIR) for the misses), one Bernoulli draw
                # per cube in interior-iteration (x, y, z) order.
                for (x, y, z) in section.interior_iter():
                    space.set(
                        (x, y, z), color if rng.random_bool(0.25) else AIR
                    )

    space.fast_evaluate_light()
    return space


def make_some_blocks(n: int) -> list[Block]:
    """N distinct fully-opaque atom blocks for tests/demos.

    Reference: all-is-cubes/src/content.rs:46 `make_some_blocks` — block i
    is a grayscale of luminance i/(n-1) named by its index."""
    out = []
    for i in range(n):
        lum = i / (n - 1) if n > 1 else 0.5
        out.append(from_color((lum, lum, lum, 1.0), str(i)))
    return out


def make_some_voxel_blocks(n: int, resolution: int = 16) -> list[Block]:
    """N distinct R16 voxel blocks: a filled grayscale cube with the
    block's index drawn on the front face.

    Reference: all-is-cubes/src/content.rs:81 `make_some_voxel_blocks_txn`
    (filled color + centered digit label; we draw the digit with the
    builtin voxel font instead of the text-primitive plumbing)."""
    from ..block import Recur
    from ..block.model import BlockAttributes
    from ..space.drawing import draw_text_line

    out = []
    for i in range(n):
        lum = i / (n - 1) if n > 1 else 0.5
        vox = Space(GridAab.cube(resolution))
        vox.fill(vox.bounds, from_color((lum, lum, lum, 1.0)))
        label_lum = 1.0 if lum < 0.5 else 0.04
        draw_text_line(
            vox,
            str(i),
            (resolution // 2 - 2, resolution // 2 - 4, resolution - 1),
            color=(label_lum, label_lum, label_lum, 1.0),
        )
        out.append(
            Block(
                Recur(space=vox, resolution=resolution),
                attributes=BlockAttributes(display_name=str(i)),
            )
        )
    return out
