"""Host-side (numpy) Amanatides–Woo grid raycaster (layer 0).

Copied unchanged from `aic_tpu/math/raycast.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

Semantic re-derivation of the reference's `Raycaster`
(all-is-cubes-base/src/raycast.rs:63): a DDA over the unit cube grid that
yields, per step, the cube entered, the face through which it was entered
(pointing back toward the ray origin), and the t-distance *in units of the
ray's direction vector* at which the boundary was crossed. The first step is
the cube containing the origin with face WITHIN and t = 0.

This host implementation is used by the light-chart generator
(light/chart.py), content generation, and as the semantic oracle the device
DDA kernels (raytrace/tracer.py) are property-tested against. Conventions
matched to the reference:

- next-boundary t uses `scale_to_integer_step` (raycast.rs:797): smallest
  strictly positive t such that s + t·ds is an integer; +inf for ds == 0,
  NaN-propagating.
- axis tie-break prefers Z, then Y, then X (raycast.rs:584-596's comparison
  chain).
- cube coordinates are confined to the i32 range minus its top cube
  (raycast.rs exiting_integer_limit tests): a start outside it yields
  nothing; walking out of it ends the cast.
- a direction with any non-finite component is treated as zero
  (raycast.rs direction_nan_produces_origin_cube_only).
- `bounds` + `include_exit` reproduce `Raycaster::within(bounds,
  include_exit)` (raycast.rs:223): with `include_exit`, the single step
  crossing out of the bounds is also produced.
- bounded casts fast-forward across empty distance to the bounds like
  raycast.rs:632 (entry-plane intersection, backed up half a cube) so
  huge origin-to-bounds gaps don't cost per-cube steps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .faces import WITHIN, face_from_step

#: Valid cube coordinate range: i32 minus the topmost cube, so a cube's
#: upper corner always fits in i32 (raycast.rs "we don't ever return a
#: step to MAX").
GRID_MIN = -(2**31)
GRID_MAX = 2**31 - 2


def scale_to_integer_step(s: float, ds: float) -> float:
    """Smallest positive t with s + t*ds integral (raycast.rs:797)."""
    if np.isnan(s) or np.isnan(ds):
        return float("nan")
    if ds == 0.0:
        return np.inf
    if ds < 0.0:
        s, ds = -s, -ds
    s = s % 1.0  # rem_euclid
    with np.errstate(over="ignore"):
        return (1.0 - s) / ds


@dataclass
class RaycastStep:
    cube: tuple[int, int, int]
    face: int  # faces.NX..PZ, or WITHIN for the first step
    t_distance: float

    def intersection_point(self, origin, direction):
        """Point where the ray crossed into this cube (raycast.rs:301).

        For the WITHIN step this is the origin itself.
        """
        origin = np.asarray(origin, np.float64)
        direction = np.asarray(direction, np.float64)
        if self.face == WITHIN:
            return origin
        p = origin + direction * self.t_distance
        # Snap the crossing axis to the exact boundary: entering through a
        # negative face (NX/NY/NZ) means crossing the cube's lower boundary;
        # a positive face means its upper boundary.
        axis = self.face % 3
        p[axis] = self.cube[axis] + (0 if self.face < 3 else 1)
        return p


def _cube_valid(cube) -> bool:
    return bool(np.all((cube >= GRID_MIN) & (cube <= GRID_MAX)))


def raycast(
    origin,
    direction,
    bounds=None,
    max_steps: int = 100000,
    t_max: float = np.inf,
    include_exit: bool = False,
):
    """Yield `RaycastStep`s for a ray through the unit grid.

    `bounds` is an optional GridAab; when given, steps outside it are
    suppressed and iteration stops once the ray has exited it after having
    been inside (raycast.rs:223 `within`). With `include_exit`, the first
    step whose cube lies outside the bounds after being inside IS produced
    (its cube is out of bounds), matching `within(bounds, true)`.
    """
    origin = np.asarray(origin, np.float64)
    direction = np.asarray(direction, np.float64)
    # A non-finite or huge (≥1e100) direction component breaks t
    # discrimination; the reference zeroes the whole vector
    # (raycast.rs Parameters::new).
    if not np.all(np.abs(direction) < 1e100):
        direction = np.zeros(3)

    if not np.all(np.isfinite(origin)):
        return

    t_offset = 0.0
    if bounds is not None and bounds.volume() > 0:
        ff = _fast_forward(origin, direction, bounds)
        if ff is None:
            return
        origin, t_offset = ff

    cube = np.floor(origin).astype(np.float64)
    if not _cube_valid(cube):
        return
    cube = cube.astype(np.int64)
    step = np.sign(direction).astype(np.int64)
    with np.errstate(divide="ignore", over="ignore"):
        t_delta = np.where(direction != 0.0, np.abs(1.0 / direction), np.inf)
    tmax = np.array(
        [
            t_offset + scale_to_integer_step(origin[i], direction[i])
            for i in range(3)
        ],
        np.float64,
    )

    def in_bounds(c):
        return bounds is None or bounds.contains_cube(c)

    was_inside = in_bounds(cube)
    if was_inside:
        yield RaycastStep(tuple(int(c) for c in cube), WITHIN, t_offset)

    if not np.any(step != 0):
        return

    for _ in range(max_steps):
        # Axis choice with Z-then-Y-then-X tie preference (raycast.rs:584).
        if tmax[0] < tmax[1]:
            axis = 0 if tmax[0] < tmax[2] else 2
        else:
            axis = 1 if tmax[1] < tmax[2] else 2
        t = tmax[axis]
        if not np.isfinite(t) or t > t_max:
            return
        cube[axis] += step[axis]
        if not _cube_valid(cube):
            return
        tmax[axis] += t_delta[axis]
        face = face_from_step(axis, step[axis] > 0)
        inside = in_bounds(cube)
        if inside:
            was_inside = True
            yield RaycastStep(tuple(int(c) for c in cube), face, float(t))
        elif was_inside:
            if include_exit:
                yield RaycastStep(tuple(int(c) for c in cube), face, float(t))
            return


def _fast_forward(origin, direction, bounds):
    """Advance the ray origin to just before `bounds` (raycast.rs:632).

    Returns (new_origin, t_start) or None when the advanced position is
    unrepresentable (the cast yields nothing either way). The caller adds
    t_start to every scale_to_integer_step-derived t so reported
    t_distances stay relative to the original origin.
    """
    step = np.sign(direction)
    lower = np.asarray(bounds.lower, np.float64)
    upper = lower + np.asarray(bounds.size, np.float64)
    max_t = 0.0
    for axis in range(3):
        if step[axis] == 0:
            continue
        plane = upper[axis] if step[axis] < 0 else lower[axis]
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            t = (plane - origin[axis]) / direction[axis]
        if np.isfinite(t):
            max_t = max(max_t, t)
    if max_t <= 0.0:
        return origin, 0.0
    d_len = float(np.linalg.norm(direction))
    t_start = max_t - 0.5 / d_len if d_len > 0 else max_t
    if not np.isfinite(t_start):
        t_start = max_t
    new_origin = origin + direction * t_start
    if not np.all(np.isfinite(new_origin)) or not _cube_valid(np.floor(new_origin)):
        return None
    return new_origin, t_start


def recursive_raycast_ray(origin, direction, cube, resolution: int):
    """Rescale a ray into a block's voxel grid (raycast.rs:458).

    Returns the sub-ray (origin', direction) such that casting it over the
    [0, R)³ voxel grid visits the block's voxels; sub-t values relate to
    world t by t_world = t_sub / R... — note the reference keeps direction
    unscaled so sub-t is *not* directly comparable to outer t; callers must
    rescale when mixing (we always convert to world t).
    """
    origin = np.asarray(origin, np.float64)
    cube = np.asarray(cube, np.float64)
    return (origin - cube) * resolution, np.asarray(direction, np.float64)
