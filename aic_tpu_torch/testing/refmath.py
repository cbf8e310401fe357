"""Host-side f64 oracle for the reference renderer's light interpolation.

Port of `aic_tpu/testing/refmath.py`: an independent re-derivation, in
float64 host NumPy, of the reference source's smooth-lighting math, over
a port `SpaceState` on any device (its tensors are read with
`.cpu().numpy()`):

- ``packed_light_oracle``: `SpaceRaytracer::get_packed_light`
  (all-is-cubes-render/src/raytracer/sr.rs:241) including
  `BlockSky::light_outside` (all-is-cubes/src/space/sky.rs:113-147):
  a cube exactly one beyond exactly one bounds face carries that face's
  BlockSky value (the 4-octant average, sky.rs:54-80, PackedLight
  quantized); edge/corner/farther-out cubes are NO_RAYS (value 0,
  AO-weight 0, invalid).
- ``interpolated_light_oracle``: `get_interpolated_light` (sr.rs:248-357):
  half-cube-offset bilinear interpolation of [r,g,b,AO-weight] samples
  (weight 1 Visible / 0.25 Opaque / 0 NoRays-Uninitialized,
  data.rs:145-158), the diagonal light-leak fix, the two-plane normal
  blend by height-in-cube with epsilon 0.5/256, and the final
  ``rgb / max(weight, 0.1)`` renormalization.

Cubes are index-space (0 at the state's lower corner), points in the
same frame. Where the port's tracer disagrees with the oracle beyond
f32 rounding, the fault is the tracer's: the oracle is written against
the Rust math, not against the tracer.
"""

from __future__ import annotations

import numpy as np

from ..math import faces as F
from ..math import lightpack as LP


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def packed_light_oracle(state, cube):
    """(rgb+AO-weight f64[4], valid) for any cube, per sr.rs:241."""
    cube = np.asarray(cube, np.int64)
    size = np.asarray(state.light.shape[:3], np.int64)
    inside = (cube >= 0) & (cube < size)
    if inside.all():
        texel = _host(state.light[cube[0], cube[1], cube[2]])
        rgb = LP.np_decode_scalar(texel[:3].astype(np.float64))
        status = int(texel[3])
        w = {LP.STATUS_VISIBLE: 1.0, LP.STATUS_OPAQUE: 0.25}.get(status, 0.0)
        return np.array([*rgb, w]), status == LP.STATUS_VISIBLE
    at_lower = cube == -1
    at_upper = cube == size
    if (~inside).sum() == 1 and (at_lower | at_upper).sum() == 1:
        axis = int(np.argmax(at_lower | at_upper))
        f = axis if at_lower[axis] else axis + 3
        sky_faces = _host(state.sky_faces).astype(np.float64)
        # The reference stores face skies as PackedLight::some(rgb)
        # (sky.rs:57,64) — quantize through the texel encoding.
        rgb = LP.np_decode_scalar(LP.np_encode_scalar(sky_faces[f]))
        return np.array([*rgb, 1.0]), True
    return np.zeros(4), False  # NO_RAYS (sky.rs:145)


def _modifier(mix: float, mode: str) -> float:
    if mode == "smooth":
        x = min(max(mix, 0.0), 1.0)
        return 3.0 * x**2 - 2.0 * x**3
    if mode == "coarse":
        return (min(max(np.floor(mix * 4.0), 0.0), 3.0) + 0.5) / 4.0
    return mix


def interpolated_light_oracle(state, cube, point, face, mode: str = "linear"):
    """f64 `get_interpolated_light` (sr.rs:248). face is our index
    (NX,NY,NZ,PX,PY,PZ = 0..5); point is the surface point. `mode` is
    "linear", "smooth" (smoothstep) or "coarse"."""
    eps = 0.5 / 256.0
    point = np.asarray(point, np.float64)
    u = np.asarray(F.FACE_TANGENT_FRAMES, np.float64)[face, 0]
    v = np.asarray(F.FACE_TANGENT_FRAMES, np.float64)[face, 1]
    n = np.asarray(F.FACE_NORMALS, np.float64)[face]
    mix1 = np.mod(point @ u - 0.5, 1.0)
    mix2 = np.mod(point @ v - 0.5, 1.0)
    dir1, dir2 = u, v
    if mix1 > 0.5:
        mix1, dir1 = 1.0 - mix1, -u
    if mix2 > 0.5:
        mix2, dir2 = 1.0 - mix2, -v
    mix1 = _modifier(mix1, mode)
    mix2 = _modifier(mix2, mode)
    height = (point - (np.asarray(cube, np.float64) + 0.5)) @ n + 0.5

    def mix4(a, b, amt):
        return a + (b - a) * amt

    def fetch_2d(origin):
        def get(s1, s2):
            p = origin + dir1 * (0.5 * s1) + dir2 * (0.5 * s2)
            return packed_light_oracle(state, np.floor(p))

        near12, _ = get(-1, -1)
        near1far2, v1 = get(-1, 1)
        near2far1, v2 = get(1, -1)
        far12, _ = get(1, 1)
        if (not v1) and (not v2):
            far12 = near12  # diagonal light-leak fix (sr.rs:316-321)
        lo = mix4(near12, near1far2, mix2)
        hi = mix4(near2far1, far12, mix2)
        return mix4(lo, hi, mix1)

    in_front = fetch_2d(point + n * (1.0 - eps))
    if height > 1.0 - eps:
        final = in_front
    else:
        same = fetch_2d(point + n * eps)
        final = mix4(same, in_front, min(max(height, 0.0), 1.0))
    return final[:3] / max(final[3], 0.1)
