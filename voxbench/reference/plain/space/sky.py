"""Sky model (layer 1): ambient light environment outside a Space.

Copied unchanged from `aic_tpu/space/sky.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

Equivalent of reference `Sky`/`BlockSky` (all-is-cubes/src/space/sky.rs:16,96).
A Sky is either uniform or per-octant; its derived per-face values are
quantized through the PackedLight log encoding exactly as the reference's
``BlockSky`` stores ``PackedLight`` (sky.rs:58 `for_blocks`), so out-of-bounds
light lookups match bit-for-bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..math import lightpack
from ..math.color import np_srgb8_to_linear

#: palette.rs:63 DAY_SKY_COLOR = srgb[243 243 255]
DAY_SKY_COLOR = np_srgb8_to_linear(np.array([243, 243, 255]))


def _octant_index(direction: np.ndarray) -> int:
    """sky.rs:35 sample(): (x>=0)<<2 | (y>=0)<<1 | (z>=0)."""
    return (
        (int(direction[0] >= 0) << 2)
        + (int(direction[1] >= 0) << 1)
        + int(direction[2] >= 0)
    )


@dataclass(frozen=True)
class Sky:
    """octants: f32[8,3] linear RGB; uniform skies have 8 equal rows."""

    octants: np.ndarray

    @staticmethod
    def uniform(color) -> "Sky":
        c = np.asarray(color, np.float32)
        return Sky(np.broadcast_to(c, (8, 3)).copy())

    @staticmethod
    def from_octants(colors) -> "Sky":
        return Sky(np.asarray(colors, np.float32).reshape(8, 3))

    @staticmethod
    def default() -> "Sky":
        return Sky.uniform(DAY_SKY_COLOR)

    def sample(self, direction) -> np.ndarray:
        return self.octants[_octant_index(np.asarray(direction))]

    def mean(self) -> np.ndarray:
        return self.octants.mean(axis=0)

    def block_sky_faces(self) -> np.ndarray:
        """Per-face sky light, PackedLight-quantized (sky.rs:58).

        For each face: average of 4 samples into the octants the face's
        outward hemisphere spans, via the rotated (-1,±1,-1)-corner rays.
        Returns f32[6,3].
        """
        from ..math.faces import FACE_TANGENT_FRAMES

        faces = np.zeros((6, 3), np.float32)
        base_rays = np.array(
            [[-1, -1, -1], [-1, 1, -1], [1, -1, -1], [1, 1, -1]], np.float64
        )
        for f in range(6):
            # rotation_from_nz maps -Z to the face normal; our tangent frame
            # rows are (u, v, n): map (x, y, z) -> x·u + y·v + (-z)·n.
            u, v, n = FACE_TANGENT_FRAMES[f]
            total = np.zeros(3, np.float64)
            for ray in base_rays:
                d = ray[0] * u + ray[1] * v + (-ray[2]) * n
                total += self.sample(d)
            faces[f] = total * 0.25
        # Quantize exactly like PackedLight::some storage.
        return lightpack.np_decode_scalar(lightpack.np_encode_scalar(faces)).astype(np.float32)

    def mean_quantized(self) -> np.ndarray:
        return lightpack.np_decode_scalar(
            lightpack.np_encode_scalar(self.mean())
        ).astype(np.float32)
