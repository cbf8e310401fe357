"""Integer grid geometry (layer 0): GridAab, Z-major volumes, rotations.

Copied unchanged from `aic_tpu/math/grid.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

Equivalent of the reference's `GridAab`/`Vol`/`Cube`/`GridRotation`
(all-is-cubes-base/src/math/{grid_aab.rs:20, vol.rs:52, cube.rs:45,
rotation.rs:42}), re-designed for array programming:

- A `GridAab` is a small host-side value object (lower bounds + size).
- Volume data is *not* wrapped: a Space's contents are plain arrays indexed
  ``[x, y, z]`` whose origin corresponds to ``aab.lower``. The reference's
  Z-major linearization (vol.rs:274) corresponds to C-order of an (X, Y, Z)
  array, which we keep so serialized payloads are interchangeable.
- The 48 axis-aligned rotations (rotation.rs:42) are represented as signed
  permutation matrices.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class GridAab:
    """Axis-aligned integer box: cubes with lower <= cube < upper.

    grid_aab.rs:20. Arithmetic is checked by numpy int64 on host; device code
    only ever sees sizes/offsets derived here.
    """

    lower: tuple[int, int, int]
    size: tuple[int, int, int]

    def __post_init__(self):
        if any(s < 0 for s in self.size):
            raise ValueError(f"negative GridAab size {self.size}")

    @staticmethod
    def from_lower_upper(lower, upper) -> "GridAab":
        lower = tuple(int(c) for c in lower)
        upper = tuple(int(c) for c in upper)
        return GridAab(lower, tuple(u - l for l, u in zip(lower, upper)))

    @staticmethod
    def from_lower_size(lower, size) -> "GridAab":
        return GridAab(tuple(int(c) for c in lower), tuple(int(s) for s in size))

    @staticmethod
    def for_block(resolution: int) -> "GridAab":
        """[0, R)³ — the voxel bounds of a block (grid_aab.rs:230)."""
        return GridAab((0, 0, 0), (resolution, resolution, resolution))

    @staticmethod
    def cube(size: int) -> "GridAab":
        return GridAab((0, 0, 0), (size, size, size))

    @property
    def upper(self) -> tuple[int, int, int]:
        return tuple(l + s for l, s in zip(self.lower, self.size))

    def volume(self) -> int:
        x, y, z = self.size
        return x * y * z

    def is_empty(self) -> bool:
        return self.volume() == 0

    def contains_cube(self, cube) -> bool:
        return all(l <= c < u for l, c, u in zip(self.lower, cube, self.upper))

    def contains_box(self, other: "GridAab") -> bool:
        if other.is_empty():
            return True
        return all(
            sl <= ol and ou <= su
            for sl, ol, ou, su in zip(self.lower, other.lower, other.upper, self.upper)
        )

    def intersection(self, other: "GridAab") -> "GridAab":
        lower = tuple(max(a, b) for a, b in zip(self.lower, other.lower))
        upper = tuple(max(l, min(a, b)) for l, a, b in zip(lower, self.upper, other.upper))
        return GridAab.from_lower_upper(lower, upper)

    def union(self, other: "GridAab") -> "GridAab":
        if self.is_empty():
            return other
        if other.is_empty():
            return self
        lower = tuple(min(a, b) for a, b in zip(self.lower, other.lower))
        upper = tuple(max(a, b) for a, b in zip(self.upper, other.upper))
        return GridAab.from_lower_upper(lower, upper)

    def translate(self, offset) -> "GridAab":
        """Translate, clamping to the i32 coordinate range like the
        reference (grid_aab.rs translate_overflow_* tests): a box pushed
        partially outside is clipped, fully outside is squashed to zero
        size at the boundary."""
        i32_min, i32_max = -(2**31), 2**31 - 1
        lower, size = [], []
        for l, s, o in zip(self.lower, self.size, offset):
            nl = l + int(o)
            nu = nl + s
            cl = min(max(nl, i32_min), i32_max)
            cu = min(max(nu, i32_min), i32_max)
            lower.append(cl)
            size.append(max(0, cu - cl) if s > 0 else s)
        return GridAab(tuple(lower), tuple(size))

    def divide(self, divisor: int) -> "GridAab":
        """Scale down, rounding outward (grid_aab.rs divide): lower is
        floor-divided, upper is ceil-divided."""
        if divisor <= 0:
            raise ValueError(
                f"GridAab.divide: divisor must be > 0, not {divisor}"
            )
        lower = tuple(l // divisor for l in self.lower)
        upper = tuple(-((-u) // divisor) for u in self.upper)
        return GridAab.from_lower_upper(lower, upper)

    def multiply(self, scale: int) -> "GridAab":
        """Scale up (grid_aab.rs multiply)."""
        return GridAab(
            tuple(l * scale for l in self.lower),
            tuple(s * scale for s in self.size),
        )

    def transform(self, gid: "Gridgid") -> "GridAab":
        """Apply a rigid transform (grid_aab.rs transform): the rotated
        corner pair is re-sorted into lower/upper."""
        m = gid.matrix()
        a = m @ np.asarray(self.lower, np.int64) + gid.translation
        b = m @ np.asarray(self.upper, np.int64) + gid.translation
        return GridAab.from_lower_upper(
            np.minimum(a, b).tolist(), np.maximum(a, b).tolist()
        )

    def expand(self, by: int) -> "GridAab":
        return GridAab.from_lower_upper(
            tuple(l - by for l in self.lower), tuple(u + by for u in self.upper)
        )

    def interior_iter(self):
        """Iterate cubes in Z-major order (x outer, z inner), as vol.rs ZMaj."""
        lx, ly, lz = self.lower
        sx, sy, sz = self.size
        return (
            (lx + i, ly + j, lz + k)
            for i in range(sx)
            for j in range(sy)
            for k in range(sz)
        )

    def to_slices(self, within: "GridAab"):
        """Index slices of this box relative to a containing box's array."""
        off = tuple(l - wl for l, wl in zip(self.lower, within.lower))
        return tuple(slice(o, o + s) for o, s in zip(off, self.size))


# ---------------------------------------------------------------------------
# Rotations: the 48 signed axis permutations (rotation.rs:42 GridRotation).

def _all_rotation_matrices() -> np.ndarray:
    """All 48 signed permutation matrices, rotations first (det=+1)."""
    mats = []
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product((1, -1), repeat=3):
            m = np.zeros((3, 3), np.int32)
            for row, (axis, sign) in enumerate(zip(perm, signs)):
                m[row, axis] = sign
            mats.append(m)
    mats = np.stack(mats)
    det = np.round(np.linalg.det(mats)).astype(int)
    order = np.argsort(-det, kind="stable")  # rotations (det=1) first
    return mats[order]


ROTATION_MATRICES = _all_rotation_matrices()
IDENTITY_ROTATION = int(
    np.nonzero((ROTATION_MATRICES == np.eye(3, dtype=np.int32)).all(axis=(1, 2)))[0][0]
)


def rotation_from_name(name: str) -> int:
    """Index of the rotation named in the reference's `GridRotation`
    scheme (rotation.rs:42): "R" + images of the x, y, z basis vectors,
    uppercase = positive axis, lowercase = negative (e.g. "RXZy" maps
    x→+x, y→+z, z→−y)."""
    assert name.startswith("R") and len(name) == 4, name
    axes = {"x": 0, "y": 1, "z": 2}
    m = np.zeros((3, 3), np.int32)
    for col, ch in enumerate(name[1:]):
        m[axes[ch.lower()], col] = 1 if ch.isupper() else -1
    matches = np.nonzero((ROTATION_MATRICES == m).all(axis=(1, 2)))[0]
    assert len(matches) == 1
    return int(matches[0])


class Gridgid:
    """Rigid integer transform: rotation (one of the 48) + translation
    (math/gridgid.rs `Gridgid`). Composable, invertible, applies to cubes
    and free points. The rotation is an index into ROTATION_MATRICES."""

    __slots__ = ("rotation", "translation")

    IDENTITY: "Gridgid"

    def __init__(self, rotation: int = None, translation=(0, 0, 0)):
        self.rotation = IDENTITY_ROTATION if rotation is None else int(rotation)
        self.translation = np.asarray(translation, np.int64)

    @staticmethod
    def from_translation(v) -> "Gridgid":
        return Gridgid(IDENTITY_ROTATION, v)

    @staticmethod
    def from_rotation_about(rotation: int, center_cube) -> "Gridgid":
        """Rotation about the center of `center_cube` (gridgid.rs
        `from_rotation_about` role): t = c' − R·c' with c' = 2·cube+1 in
        doubled coordinates; here computed on cube centers exactly using
        the doubled-integer trick."""
        c2 = np.asarray(center_cube, np.int64) * 2 + 1  # doubled center
        m = ROTATION_MATRICES[rotation].astype(np.int64)
        t2 = c2 - m @ c2
        assert (t2 % 2 == 0).all()
        return Gridgid(rotation, t2 // 2)

    def matrix(self) -> np.ndarray:
        return ROTATION_MATRICES[self.rotation].astype(np.int64)

    def transform_point(self, p):
        """Free point (float) transform."""
        return self.matrix().astype(np.float64) @ np.asarray(p, np.float64) + (
            self.translation.astype(np.float64)
        )

    def transform_cube(self, cube):
        """Cube transform (gridgid.rs transform_cube): rotate the cube's
        lower corner accounting for the rotation's corner remap."""
        m = self.matrix()
        lo = m @ np.asarray(cube, np.int64)
        hi = m @ (np.asarray(cube, np.int64) + 1)
        return tuple(int(v) for v in np.minimum(lo, hi) + self.translation)

    def compose(self, other: "Gridgid") -> "Gridgid":
        """self ∘ other (apply `other` first)."""
        rot = compose_rotations(self.rotation, other.rotation)
        t = self.matrix() @ other.translation + self.translation
        return Gridgid(rot, t)

    def inverse(self) -> "Gridgid":
        inv_rot = inverse_rotation(self.rotation)
        m_inv = ROTATION_MATRICES[inv_rot].astype(np.int64)
        return Gridgid(inv_rot, -(m_inv @ self.translation))

    def __eq__(self, other):
        return (
            isinstance(other, Gridgid)
            and self.rotation == other.rotation
            and (self.translation == other.translation).all()
        )

    def __repr__(self):
        return f"Gridgid({rotation_name(self.rotation)}, {tuple(self.translation)})"


def compose_rotations(a: int, b: int) -> int:
    """Index of rotation a∘b."""
    m = ROTATION_MATRICES[a] @ ROTATION_MATRICES[b]
    idx = np.nonzero((ROTATION_MATRICES == m).all(axis=(1, 2)))[0]
    return int(idx[0])


def inverse_rotation(r: int) -> int:
    m = ROTATION_MATRICES[r].T  # signed permutation: inverse = transpose
    idx = np.nonzero((ROTATION_MATRICES == m).all(axis=(1, 2)))[0]
    return int(idx[0])


def rotation_name(index: int) -> str:
    """Inverse of :func:`rotation_from_name`: the reference's name of
    rotation `index` (rotation.rs naming scheme)."""
    m = ROTATION_MATRICES[index]
    letters = []
    for col in range(3):
        axis = int(np.nonzero(m[:, col])[0][0])
        ch = "xyz"[axis]
        letters.append(ch.upper() if m[axis, col] > 0 else ch)
    return "R" + "".join(letters)


def rotate_voxel_array(arr: np.ndarray, rot: np.ndarray) -> np.ndarray:
    """Rotate a cubical voxel array [R,R,R,...] by a signed permutation.

    Equivalent to the reference's `Modifier::Rotate` permuting a `Vol`
    (block/modifier/rotate via vol transform): voxel at position p moves to
    rot·(p - c) + c where c is the cube center.
    """
    assert arr.shape[0] == arr.shape[1] == arr.shape[2]
    perm = [int(np.nonzero(rot[row])[0][0]) for row in range(3)]
    signs = [int(rot[row, perm[row]]) for row in range(3)]
    # out[p] = in[rot^-1 p]; build by moving axes then flipping.
    out = np.transpose(arr, axes=perm + list(range(3, arr.ndim)))
    for row in range(3):
        if signs[row] < 0:
            out = np.flip(out, axis=row)
    return out


Gridgid.IDENTITY = Gridgid()
