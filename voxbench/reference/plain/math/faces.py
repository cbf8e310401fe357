"""Axis-aligned face/direction conventions (layer 0).

Copied unchanged from `aic_tpu/math/faces.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

Role equivalent to the reference's ``Face6``/``Face7``/``FaceMap`` types
(all-is-cubes-base/src/math/face.rs:76,104,919), re-designed as plain integer
codes + static numpy tables so that per-face data is an ordinary trailing
array axis of length 6 (or 7) on device.

Face order: NX, NY, NZ, PX, PY, PZ  (indices 0..5), WITHIN = 6.
This matches the reference's ``FaceMap { nx, ny, nz, px, py, pz }`` field
order so per-face tables line up with its semantics.
"""

from __future__ import annotations

import numpy as np

NX, NY, NZ, PX, PY, PZ, WITHIN = 0, 1, 2, 3, 4, 5, 6

FACE_NAMES = ("NX", "NY", "NZ", "PX", "PY", "PZ", "WITHIN")

#: Unit normal of each face, pointing in the direction the face name denotes.
#: (A cube's NX face's normal points in -X; entering a cube moving +X means
#: crossing its NX face.)
FACE_NORMALS = np.array(
    [
        [-1, 0, 0],
        [0, -1, 0],
        [0, 0, -1],
        [1, 0, 0],
        [0, 1, 0],
        [0, 0, 1],
    ],
    dtype=np.int32,
)

#: FACE_NORMALS extended with a zero row for WITHIN (index 6).
FACE7_NORMALS = np.concatenate([FACE_NORMALS, np.zeros((1, 3), np.int32)])

#: Axis (0=x,1=y,2=z) of each of the 6 faces.
FACE_AXES = np.array([0, 1, 2, 0, 1, 2], dtype=np.int32)

#: True for the positive-direction faces.
FACE_IS_POSITIVE = np.array([False, False, False, True, True, True])


def opposite(face: int) -> int:
    """Opposite face; WITHIN maps to itself (face.rs `Face7::opposite`)."""
    if face == WITHIN:
        return WITHIN
    return (face + 3) % 6


OPPOSITE = np.array([3, 4, 5, 0, 1, 2, 6], dtype=np.int32)


def face_from_step(axis: int, positive_step: bool) -> int:
    """Face of the *entered* cube crossed by a ray stepping along `axis`.

    Stepping in +axis enters through the new cube's negative face and vice
    versa (raycast.rs step semantics: `face` points back toward the ray
    origin).
    """
    return axis if positive_step else axis + 3


#: rotation_from_nz frames: for each face, (tangent_u, tangent_v, normal)
#: with u/v = `face.rotation_from_nz()` images of +X/+Y (face.rs:394-403)
#: and normal = FACE_NORMALS[face]. Smooth-light interpolation samples
#: with exactly these frames (sr.rs:263); the choice matters at block
#: corners, where invalid-texel AO amplification is NOT symmetric under
#: tangent sign flips — a freely-chosen basis diverges from the
#: reference's goldens there (sky-* cases).
def _tangent_frame() -> np.ndarray:
    #                  u           v            (per face NX,NY,NZ,PX,PY,PZ)
    uv = np.array(
        [
            [[0, 1, 0], [0, 0, 1]],   # NX (RYZX)
            [[0, 0, 1], [1, 0, 0]],   # NY (RZXY)
            [[1, 0, 0], [0, 1, 0]],   # NZ (identity)
            [[0, -1, 0], [0, 0, 1]],  # PX (RyZx)
            [[0, 0, 1], [-1, 0, 0]],  # PY (RZxy)
            [[1, 0, 0], [0, -1, 0]],  # PZ (RXyz)
        ],
        np.int32,
    )
    frames = np.zeros((6, 3, 3), dtype=np.int32)
    frames[:, 0] = uv[:, 0]
    frames[:, 1] = uv[:, 1]
    frames[:, 2] = FACE_NORMALS
    return frames


FACE_TANGENT_FRAMES = _tangent_frame()
