"""Light propagation chart: static per-ray step tables (host, numpy).

Copied unchanged from `aic_tpu/light/chart.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

The reference precomputes a *prefix tree* over 602 ray paths
(all-is-cubes/src/space/light/chart/generator.rs:53-82: one ray toward each
surface cell of the 11³ direction lattice, weighted per-face by
max(0, cos)) and walks it depth-first per relit cube (updater.rs:421).

TPU re-design: the tree walk is *linear in ray weight* — every per-node
contribution is `f(path prefix) × Σ_f(direction_weights · node_weight_f)`
and `node_weight = Σ ray face_cosines over rays through the node` — so
summing per-ray contributions with each ray's own face_cosines reproduces
the tree result exactly. We therefore flatten the chart to dense per-ray
step tables `[R_RAYS, MAX_STEPS]` (offsets, entry faces, end-of-distance
flags), which turns the whole light computation into masked gathers + a
scan — the shape a TPU wants.

Known deviation: at ray end the sky sample is weighted by the *ray's own*
face cosines rather than the tree node's aggregated weights (updater.rs:900
uses node weights but carries a TODO that those are "the wrong set of
weights"). Identical for uniform skies; a closer directional approximation
for octant skies.
"""

from __future__ import annotations

import functools

import numpy as np

from ..math import faces
from ..math.raycast import raycast

RAY_DIRECTION_STEP = 5
CHART_MAX_T = 127.0  # generator.rs:100 maximum_distance


def generate_directions() -> tuple[np.ndarray, np.ndarray]:
    """All lattice surface directions + per-face cosines.

    Returns (directions f64[R,3] normalized, face_cosines f32[R,6]).
    generator.rs:53 `generate_light_ray_pattern`.

    Precision contract: the reference normalizes in f32 (euclid
    `Vector3D<f32>::normalize`) and only then widens to f64 for the
    raycast (generator.rs:103 `direction.map(f64::from)`). Normalizing in
    f64 instead changes the low bits of near-diagonal directions, which
    flips t_max tie-breaks in the DDA and reroutes those rays one cube
    off — visibly shifting light around diagonal geometry (the golden
    light_spread pillar staircase). So: f32 all the way, then widen.
    """
    rng = range(-RAY_DIRECTION_STEP, RAY_DIRECTION_STEP + 1)
    dirs = []
    for x in rng:
        for y in rng:
            for z in rng:
                if max(abs(x), abs(y), abs(z)) == RAY_DIRECTION_STEP:
                    v = np.array([x, y, z], np.float32)
                    length = np.float32(
                        np.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
                    )
                    dirs.append((v / length).astype(np.float64))
    directions = np.stack(dirs)
    # Cosines in f32 like generator.rs:72-75 (to_f32().dot(to_f32())).
    cosines = np.maximum(
        directions.astype(np.float32) @ np.asarray(faces.FACE_NORMALS, np.float32).T,
        np.float32(0.0),
    )
    return directions, cosines.astype(np.float32)


# Step kinds
STEP_NORMAL = 0
STEP_END = 1  # ray ends here (max distance exceeded) — sky, no cube visit
STEP_PAD = 2  # padding after the end


@functools.lru_cache(maxsize=8)
def build_chart(max_distance: int):
    """Build step tables for a given LightPhysics maximum_distance.

    Returns dict of numpy arrays:
      offsets   i8 [R, S, 3] — relative cube entered at step s (s=0 excluded;
                 step tables start at the first *neighbor* step; the origin
                 cube (Within) is handled separately by the kernel)
      faces_in  u8 [R, S]    — face of the entered cube crossed (0..5)
      kinds     u8 [R, S]    — STEP_NORMAL / STEP_END / STEP_PAD
      cosines   f32[R, 6]
      n_rays, max_steps
    """
    directions, cosines = generate_directions()
    max_d2 = float(max_distance) * float(max_distance)

    all_steps = []
    for d in directions:
        steps = []
        ended = False
        for st in raycast([0.5, 0.5, 0.5], d, t_max=min(CHART_MAX_T, max_distance * 2.0)):
            if st.face == faces.WITHIN:
                continue  # origin cube handled separately
            # updater.rs:443: distance from origin center to entered cube
            # center, squared, compared against maximum_distance².
            center = np.asarray(st.cube, np.float64) + 0.5
            dist2 = ((center - 0.5) ** 2).sum()
            if dist2 > max_d2:
                steps.append((st.cube, st.face, STEP_END))
                ended = True
                break
            steps.append((st.cube, st.face, STEP_NORMAL))
        if not ended:
            # Safety: guarantee an END step (chart t-cap reached first).
            last = steps[-1][0] if steps else (0, 0, 0)
            steps.append((last, 0, STEP_END))
        all_steps.append(steps)

    n_rays = len(all_steps)
    max_steps = max(len(s) for s in all_steps)
    offsets = np.zeros((n_rays, max_steps, 3), np.int8)
    faces_in = np.zeros((n_rays, max_steps), np.uint8)
    kinds = np.full((n_rays, max_steps), STEP_PAD, np.uint8)
    for r, steps in enumerate(all_steps):
        for s, (cube, face, kind) in enumerate(steps):
            offsets[r, s] = cube
            faces_in[r, s] = face
            kinds[r, s] = kind

    return dict(
        offsets=offsets,
        faces_in=faces_in,
        kinds=kinds,
        cosines=cosines,
        n_rays=n_rays,
        max_steps=max_steps,
    )
