"""Octants and octant masks (layer 0).

Copied unchanged from `aic_tpu/math/octant.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

Role of the reference's ``Octant``/``OctantMask``/``OctantMap``
(all-is-cubes-base/src/math/octant.rs), re-designed as plain integer codes
and numpy tables: an octant is an index 0..7 in "zmaj" bit order — bit 2
set ⇔ +X half, bit 1 ⇔ +Y, bit 0 ⇔ +Z (octant.rs:24-41) — and a mask is
a Python int with the same LSB-first bit layout (octant.rs:272-276).
Vector-of-signs tables make octant arithmetic array math so per-chunk /
per-sky-octant data can live on a trailing axis of length 8.
"""

from __future__ import annotations

import numpy as np

NNN, NNP, NPN, NPP, PNN, PNP, PPN, PPP = range(8)

ALL_MASK = 0xFF
NONE_MASK = 0x00

#: i8[8,3] — the sign (+1/−1) of each octant on each axis.
OCTANT_SIGNS = np.array(
    [
        [(1 if o & 4 else -1), (1 if o & 2 else -1), (1 if o & 1 else -1)]
        for o in range(8)
    ],
    np.int8,
)

#: u8[8,3] — the 0/1 corner of (0..2)³ for each octant (`to_01`).
OCTANT_01 = ((OCTANT_SIGNS + 1) // 2).astype(np.uint8)


def octant_from_vector(v) -> int:
    """Octant containing direction `v`; components ≥ 0 count as positive
    (octant.rs:114 `from_vector`)."""
    v = np.asarray(v, np.float64)
    return int(
        (int(v[0] >= 0.0) << 2) | (int(v[1] >= 0.0) << 1) | int(v[2] >= 0.0)
    )


def octant_reflect(octant: int, vec):
    """Negate `vec`'s components on the octant's negative axes
    (octant.rs:180 `reflect`): maps positive-octant data into `octant`."""
    return np.asarray(vec) * OCTANT_SIGNS[octant]


def octant_opposite(octant: int) -> int:
    return octant ^ 0b111


def mask_set(mask: int, octant: int) -> int:
    return mask | (1 << octant)


def mask_get(mask: int, octant: int) -> bool:
    return bool(mask & (1 << octant))


def mask_from_face(face: int) -> int:
    """The four octants on `face`'s side of the origin (octant.rs:303)."""
    return mask_shift(ALL_MASK, face)


def mask_shift(mask: int, face: int) -> int:
    """octant.rs:349 `shift`: move bits across the plane of `face`."""
    from . import faces

    if face == faces.NX:
        return mask >> 4
    if face == faces.PX:
        return (mask << 4) & 0xFF
    if face == faces.NY:
        return (mask & 0b11001100) >> 2
    if face == faces.PY:
        return (mask & 0b00110011) << 2
    if face == faces.NZ:
        return (mask & 0b10101010) >> 1
    return (mask & 0b01010101) << 1


def mask_collapse_to_negative(mask: int, x: bool, y: bool, z: bool) -> int:
    """octant.rs:441: or negative-side bits onto the positive side per
    axis — used to avoid emitting duplicate mirrors for zero coordinates."""
    if x:
        mask = (mask & 0b00001111) | ((mask & 0b11110000) >> 4)
    if y:
        mask = (mask & 0b00110011) | ((mask & 0b11001100) >> 2)
    if z:
        mask = (mask & 0b01010101) | ((mask & 0b10101010) >> 1)
    return mask


def mask_octants(mask: int) -> np.ndarray:
    """Indices of set octants, ascending (first()..last() order)."""
    return np.nonzero([(mask >> o) & 1 for o in range(8)])[0]


def view_direction_mask(frustum_corner_dirs) -> int:
    """camera.rs:261 `view_direction_mask`: mask of octants spanned by the
    view frustum, sampled by its 4 corner rays, 4 edge midpoints, and the
    center ray (sufficient because FOV < 180°).

    frustum_corner_dirs: f64[4,3] — direction vectors of the frustum's
    corner rays (lb, lt, rb, rt order).
    """
    d = np.asarray(frustum_corner_dirs, np.float64)
    lb, lt, rb, rt = d
    mask = NONE_MASK
    for v in (
        lb, lt, rb, rt,
        lb + lt, rb + rt, lt + rt, lb + rb,
        lb + lt + rb + rt,
    ):
        mask = mask_set(mask, octant_from_vector(v))
    return mask
