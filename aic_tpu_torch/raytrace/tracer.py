"""The general tracer, bounce lighting, and the pieces every tracer
shares, in plain PyTorch.

Port of `aic_tpu/raytrace/tracer.py`, which is XLA code, not Pallas:
`ray_entry_setup` (:334), `_sky_sample` (:1110), `make_phase_shader`
(:383-475) with smooth-lighting interpolation (:130-325), flat light and
volumetric transmittance (:478), and fog, which the kernels' phase loops
share; `trace_rays` (:499-1108), the general tracer; and
`trace_rays_bounce` (:1131).

`trace_rays` holds every state: it walks the packed brick cells
(`SpaceState.cells`, one 4³ brick row gathered per ray and iteration,
`SUBSTEPS` DDA steps inside it), so it has no region or resolution limit.
`render_hdr` sends it the states that neither kernel holds (more than
4096 16³ regions, or voxel resolution above 32 for the megakernel and 16
for the v1 kernel). A beam pre-pass marches the skip field once per
8×8-pixel tile to start each ray past the empty space all of its tile
provably crosses. Each phase walks a list of its walking rays, shrunk
whenever half of them have stopped; a ray's walk is the same whatever
list it is in, so the result is `aic_tpu`'s all-ray loop's. The loop
checks for walkers every `CHECK_EVERY` iterations and counts only the
iterations that began with a walker, as `aic_tpu`'s `lax.while_loop`
runs them; an iteration with no walker changes nothing.

Shading follows the reference's `Surface::to_light` (surface.rs:73-200);
compositing is front-to-back premultiplied alpha. All math is float32.
Where `aic_tpu` used a one-hot matmul or one-hot sum to avoid a TPU
gather, this port indexes directly: the selected values are identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..math import faces, lightpack
from ..space.state import SpaceState
from .accel import RES_SHIFT, SKIP_MASK, SKIP_SHIFT, VISIBLE_BIT, VOXEL_BIT, brick_dims
from .options import (
    LIGHT_BOUNCE,
    LIGHT_COARSE,
    LIGHT_FLAT,
    LIGHT_LINEAR,
    LIGHT_NONE,
    LIGHT_SMOOTHSTEP,
    TRANSPARENCY_THRESHOLD,
    TRANSPARENCY_VOLUMETRIC,
)

INF = float("inf")

HIT_NONE = 0
HIT_ATOM = 1
HIT_VOXEL = 2

#: Maximum volume (cubes) for which the per-(cube, face) interpolation-row
#: table is built (432 B/cube); above it shading fetches texels directly.
_INTERP_ROWS_MAX_VOLUME = 1 << 19


def _table(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _fetch_light_texel(state: SpaceState, cube: torch.Tensor):
    """get_packed_light (sr.rs:241) → ([r,g,b,AO-weight] f32, valid bool);
    out of bounds resolves through BlockSky::light_outside (sky.rs:96)."""
    dev = cube.device
    size = _table(state.light.shape[:3], torch.int32, dev)
    below = cube < 0
    above = cube >= size
    outside_any = (below | above).any(-1)
    ic = torch.minimum(torch.clamp(cube, min=0), size - 1).long()
    flat = (ic[..., 0] * size[1] + ic[..., 1]) * size[2] + ic[..., 2]
    texel = state.light.reshape(-1, 4)[flat]
    stored, valid_stored = _decode_row_texel(texel)

    at_lower = cube == -1
    at_upper = cube == size
    adjacent = at_lower | at_upper
    touching = ((below | above).sum(-1) == 1) & (adjacent.sum(-1) == 1)
    face_idx = torch.argmax(torch.cat([at_lower, at_upper], -1).to(torch.int32), dim=-1)
    sky_rgb = state.sky_faces[face_idx]
    sky_val = torch.cat([sky_rgb, torch.ones_like(sky_rgb[..., :1])], -1)
    outside_val = torch.where(touching[..., None], sky_val, torch.zeros_like(sky_val))
    valid = torch.where(outside_any, touching, valid_stored)
    return torch.where(outside_any[..., None], outside_val, stored), valid


def _interp_modifier(mix, mode: str):
    if mode == LIGHT_SMOOTHSTEP:
        return mix * mix * (3.0 - 2.0 * mix)
    if mode == LIGHT_COARSE:
        # coarsestep (surface.rs:514-518): 4-level quantizer.
        return (torch.clamp(torch.floor(mix * 4.0), 0.0, 3.0) + 0.5) / 4.0
    return mix


def _build_interp_rows(state: SpaceState) -> torch.Tensor:
    """Pack the 18 light texels smooth lighting can touch per (cube, face)
    into one row: u8[vol*6, 18*4] (aic_tpu tracer.py:130).

    Out-of-bounds texels follow BlockSky::light_outside: face slabs carry
    the sky face value with VISIBLE status; edges and corners are NO_RAYS."""
    size = state.light.shape[:3]
    dev = state.light.device
    pad = torch.zeros((size[0] + 2, size[1] + 2, size[2] + 2, 4), dtype=torch.uint8, device=dev)
    pad[..., 3] = lightpack.STATUS_NO_RAYS
    inner = tuple(slice(1, 1 + size[a]) for a in range(3))
    pad[inner] = state.light
    sky_texels = lightpack.encode_rgb(state.sky_faces)  # [6,4]
    for a in range(3):
        lo = list(inner)
        hi = list(inner)
        lo[a] = 0
        hi[a] = size[a] + 1
        pad[tuple(lo)] = sky_texels[a]
        pad[tuple(hi)] = sky_texels[a + 3]

    frames = np.asarray(faces.FACE_TANGENT_FRAMES, np.int32)  # [6,2,3]
    normals = np.asarray(faces.FACE_NORMALS, np.int32)
    per_face = []
    for f in range(6):
        u, v, n = frames[f, 0], frames[f, 1], normals[f]
        shifts = []
        for p in (0, 1):
            for su in (-1, 0, 1):
                for sv in (-1, 0, 1):
                    d = p * n + su * u + sv * v
                    shifts.append(
                        pad[
                            1 + d[0] : 1 + d[0] + size[0],
                            1 + d[1] : 1 + d[1] + size[1],
                            1 + d[2] : 1 + d[2] + size[2],
                        ]
                    )
        per_face.append(torch.stack(shifts, dim=-2))  # [X,Y,Z,18,4]
    rows = torch.stack(per_face, dim=-3)  # [X,Y,Z,6,18,4]
    return rows.reshape(-1, 18 * 4)


def _decode_row_texel(texel: torch.Tensor):
    """u8[...,4] packed texel → (rgbw f32[...,4], valid bool[...])."""
    rgb = lightpack.decode_scalar(texel[..., :3])
    status = texel[..., 3].to(torch.int32)
    one = torch.ones_like(rgb[..., 0])
    weight = torch.where(
        status == lightpack.STATUS_VISIBLE,
        one,
        torch.where(status == lightpack.STATUS_OPAQUE, 0.25 * one, 0.0 * one),
    )
    valid = status == lightpack.STATUS_VISIBLE
    return torch.cat([rgb, weight[..., None]], -1), valid


def _face_frame(face: torch.Tensor):
    dev = face.device
    f = torch.clamp(face, 0, 5).long()
    frames = _table(faces.FACE_TANGENT_FRAMES, torch.float32, dev)
    normals = _table(faces.FACE_NORMALS, torch.float32, dev)
    return f, frames[f, 0], frames[f, 1], normals[f]


def _smooth_light(point, cube, u, v, n, mode, texel_at):
    """get_interpolated_light's math (sr.rs:248): AO-weighted bilinear
    smooth lighting with the diagonal light-leak fix and height blend.
    `texel_at(sample_point)` returns (rgbw, valid) of the texel whose cube
    is floor(sample_point)."""
    eps = 0.5 / 256.0
    mix1 = torch.remainder((point * u).sum(-1) - 0.5, 1.0)
    mix2 = torch.remainder((point * v).sum(-1) - 0.5, 1.0)
    flip1 = mix1 > 0.5
    flip2 = mix2 > 0.5
    mix1 = torch.where(flip1, 1.0 - mix1, mix1)
    mix2 = torch.where(flip2, 1.0 - mix2, mix2)
    dir1 = torch.where(flip1[..., None], -u, u)
    dir2 = torch.where(flip2[..., None], -v, v)
    mix1 = _interp_modifier(mix1, mode)
    mix2 = _interp_modifier(mix2, mode)

    center = cube.to(torch.float32) + 0.5
    height = ((point - center) * n).sum(-1) + 0.5

    def fetch_2d(origin):
        def get(s1, s2):
            return texel_at(origin + dir1 * (0.5 * s1) + dir2 * (0.5 * s2))

        near12, _ = get(-1.0, -1.0)
        near1far2, v_nf = get(-1.0, 1.0)
        near2far1, v_fn = get(1.0, -1.0)
        far12, _ = get(1.0, 1.0)
        leak = (~v_nf) & (~v_fn)
        far12 = torch.where(leak[..., None], near12, far12)
        m2 = mix2[..., None]
        m1 = mix1[..., None]
        lo = near12 * (1 - m2) + near1far2 * m2
        hi = near2far1 * (1 - m2) + far12 * m2
        return lo * (1 - m1) + hi * m1

    in_front = fetch_2d(point + n * (1.0 - eps))
    same = fetch_2d(point + n * eps)
    hmix = torch.clamp(height, 0.0, 1.0)[..., None]
    final = torch.where(
        (height > 1.0 - eps)[..., None], in_front, same * (1 - hmix) + in_front * hmix
    )
    weight = torch.clamp(final[..., 3], min=0.1)
    return final[..., :3] / weight[..., None]


def _interpolated_light_rows(state, rows, cube, point, face, mode: str):
    """Smooth lighting through the interp-row table: one row per hit, the
    texel selected within it (aic_tpu tracer.py:203)."""
    f, u, v, n = _face_frame(face)
    size = state.light.shape[:3]
    cl = cube.long()
    flat = (cl[..., 0] * size[1] + cl[..., 1]) * size[2] + cl[..., 2]
    row = rows[flat * 6 + f].reshape(point.shape[:-1] + (18, 4))
    cube_f = cube.to(torch.float32)

    def texel_at(sample_point):
        off = torch.floor(sample_point) - cube_f  # each component ∈ {-1,0,1}
        su = torch.round((off * u).sum(-1)).to(torch.int64)
        sv = torch.round((off * v).sum(-1)).to(torch.int64)
        sn = torch.round((off * n).sum(-1)).to(torch.int64)
        idx = torch.clamp(sn, 0, 1) * 9 + (torch.clamp(su, -1, 1) + 1) * 3 + (
            torch.clamp(sv, -1, 1) + 1
        )
        texel = torch.gather(row, -2, idx[..., None, None].expand(idx.shape + (1, 4)))
        return _decode_row_texel(texel[..., 0, :])

    return _smooth_light(point, cube, u, v, n, mode, texel_at)


def _interpolated_light(state, cube, point, face, mode: str):
    """Smooth lighting by direct texel fetches (aic_tpu tracer.py:274)."""
    _, u, v, n = _face_frame(face)

    def texel_at(sample_point):
        return _fetch_light_texel(state, torch.floor(sample_point).to(torch.int32))

    return _smooth_light(point, cube, u, v, n, mode, texel_at)


def _flat_light(state: SpaceState, cube, face):
    normals7 = _table(faces.FACE7_NORMALS, torch.int32, cube.device)
    n = normals7[torch.clamp(face, 0, 6).long()]
    rgbw, _ = _fetch_light_texel(state, cube + n)
    return rgbw[..., :3]


def ray_entry_setup(o: torch.Tensor, d: torch.Tensor, size):
    """DDA register init (aic_tpu tracer.py:334): bounds slab test + entry
    one virtual cube early (`within` semantics, raycast.rs:223).

    o, d: f32[n, 3] space-local origins/directions."""
    dev = o.device
    size_i = _table(size, torch.int32, dev)
    size_f = size_i.to(torch.float32)
    d_len = torch.linalg.vector_norm(d, dim=-1)
    max_abs_d = torch.clamp(d.abs().amax(-1), min=1e-30)
    safe_d = torch.where(d == 0.0, torch.full_like(d, 1e-30), d)
    inv_d = 1.0 / safe_d
    step = torch.where(d > 0, 1, torch.where(d < 0, -1, 0)).to(torch.int32)
    step_pos = (step > 0).to(torch.int32)

    t0 = (0.0 - o) * inv_d
    t1 = (size_f - o) * inv_d
    t_lo = torch.minimum(t0, t1)
    t_hi = torch.maximum(t0, t1)
    in_slab = (o >= 0.0) & (o <= size_f)
    inf = torch.full_like(t_lo, INF)
    t_lo = torch.where(d == 0.0, torch.where(in_slab, -inf, inf), t_lo)
    t_hi = torch.where(d == 0.0, torch.where(in_slab, inf, -inf), t_hi)
    t_enter = torch.clamp(t_lo.amax(-1), min=0.0)
    t_exit = t_hi.amin(-1)
    hits_box = t_exit > t_enter

    started_inside = t_lo.amax(-1) <= 0.0
    p_start = o + d * (t_enter[..., None] + 1e-5)
    cube0 = torch.minimum(torch.clamp(torch.floor(p_start).to(torch.int32), min=0), size_i - 1)
    boundary = cube0 + step_pos
    tmax0 = (boundary.to(torch.float32) - o) * inv_d
    tmax0 = torch.where(step == 0, torch.full_like(tmax0, INF), tmax0)
    # Rays entering from outside start one virtual cube early so the first
    # iteration performs the entry crossing and shades the boundary cube.
    entry_axis = torch.argmax(t_lo, dim=-1)
    entry_onehot = torch.nn.functional.one_hot(entry_axis, 3).to(torch.int32)
    cube_pre = cube0 - entry_onehot * step
    tmax_pre = torch.where(entry_onehot == 1, t_enter[..., None], tmax0)
    cube0 = torch.where(started_inside[..., None], cube0, cube_pre)
    tmax0 = torch.where(started_inside[..., None], tmax0, tmax_pre)
    return dict(
        inv_d=inv_d, step=step, step_pos=step_pos, t_delta_base=inv_d.abs(),
        d_len=d_len, max_abs_d=max_abs_d, cube0=cube0, tmax0=tmax0,
        hits_box=hits_box, t_enter=t_enter, t_exit=t_exit,
        started_inside=started_inside,
    )


def _sky_sample(state: SpaceState, d: torch.Tensor) -> torch.Tensor:
    """Sky::sample (sky.rs:35): octant by direction signs."""
    octant = (
        (d[..., 0] >= 0).long() * 4 + (d[..., 1] >= 0).long() * 2 + (d[..., 2] >= 0).long()
    )
    return state.sky_octants[octant]


def _apply_transmittance(alpha, thickness):
    """raytracer_components.rs:215, vectorized. Returns (alpha', coeff)."""
    thickness = torch.clamp(thickness, min=0.0)
    alpha = torch.clamp(alpha, 0.0, 1.0)
    ut = 1.0 - alpha
    dt = torch.pow(torch.clamp(ut, min=0.0), thickness)
    out_alpha = 1.0 - dt
    coeff = torch.where(ut == 1.0, thickness, (dt - 1.0) / torch.clamp(ut - 1.0, max=-1e-9))
    zero = thickness == 0.0
    full = torch.where(alpha >= 1.0, torch.ones_like(alpha), torch.zeros_like(alpha))
    out_alpha = torch.where(zero, full, out_alpha)
    coeff = torch.where(zero, full, coeff)
    return out_alpha, torch.clamp(coeff, min=0.0)


def make_phase_shader(state: SpaceState, options, o, d, d_len, t_to_view, sky_rgb):
    """Build the per-phase hit-buffer shader (Surface::to_light + fog +
    front-to-back compositing).

    Returns shade(hits, light_acc, trans_acc, phase_illum=None) →
    (light_acc', trans_acc'), where `hits` holds hit_kind, hit_idx,
    hit_vflat, hit_face, hit_t, hit_next_t and hit_cube; `phase_illum`
    (f32[n, 3]) replaces the stored-light illumination (bounce lighting's
    hook). Bounce lighting shades Flat here, as past its budget
    (surface.rs:173-177): `trace_rays_bounce` spends the budget."""
    n_rays = o.shape[0]
    tables = state.tables
    n_space = int(np.prod(state.contents.shape))

    fog_on = options.fog != "none"
    fog_blend = float(options.fog_blend())
    lighting = options.lighting_display
    if not state.light_enabled:
        # LightPhysics::None → unit illumination (updater.rs:580 get()).
        lighting = LIGHT_NONE
    transparency = options.transparency

    use_interp_rows = (
        lighting in (LIGHT_LINEAR, LIGHT_SMOOTHSTEP, LIGHT_COARSE)
        and n_space <= _INTERP_ROWS_MAX_VOLUME
    )
    interp_rows = _build_interp_rows(state) if use_interp_rows else None

    # One combined material table, indexed by kind.
    n_pal = tables.palette_rows.shape[0]
    mat_rows = torch.cat([tables.palette_rows, tables.vox_rows.reshape(-1, 8)], 0)

    def shade(hits, light_acc, trans_acc, phase_illum=None):
        has_hit = hits["hit_kind"] != HIT_NONE
        is_vox = hits["hit_kind"] == HIT_VOXEL
        mat_idx = torch.where(is_vox, n_pal + hits["hit_vflat"], hits["hit_idx"])
        mat = mat_rows[mat_idx.long()]
        rgba = mat[..., 0:4]
        emission = mat[..., 4:7]

        alpha = torch.clamp(rgba[..., 3], 0.0, 1.0)
        point = o + d * hits["hit_t"][..., None]
        if transparency == TRANSPARENCY_THRESHOLD:
            alpha = (alpha > options.transparency_threshold).to(torch.float32)
            emission_scaled = emission
        elif transparency == TRANSPARENCY_VOLUMETRIC:
            thickness = (hits["hit_next_t"] - hits["hit_t"]) * d_len
            alpha, coeff = _apply_transmittance(alpha, thickness)
            emission_scaled = emission * coeff[..., None]
        else:
            emission_scaled = emission

        shade_m = has_hit & ((alpha > 0.0) | (emission_scaled != 0.0).any(-1))

        if lighting == LIGHT_NONE:
            illum = torch.ones((n_rays, 3), dtype=torch.float32, device=o.device)
        elif lighting in (LIGHT_FLAT, LIGHT_BOUNCE):
            illum = _flat_light(state, hits["hit_cube"], hits["hit_face"])
        elif use_interp_rows:
            illum = _interpolated_light_rows(
                state, interp_rows, hits["hit_cube"], point, hits["hit_face"], lighting
            )
        else:
            illum = _interpolated_light(
                state, hits["hit_cube"], point, hits["hit_face"], lighting
            )
        if phase_illum is not None:
            illum = phase_illum

        out_rgb = rgba[..., :3] * illum * alpha[..., None] + emission_scaled
        surf_trans = 1.0 - alpha
        if fog_on:
            rel = torch.clamp(hits["hit_t"] * t_to_view, 0.0, 1.0)
            fog_exp = (1.0 - torch.exp(-1.6 * rel)) / 0.79810348
            fog_amount = fog_exp * (1.0 - fog_blend) + rel**4 * fog_blend
            out_rgb = out_rgb * (1.0 - fog_amount[..., None]) + sky_rgb * fog_amount[..., None]
            surf_trans = surf_trans * (1.0 - fog_amount)

        light_acc2 = light_acc + torch.where(
            shade_m[..., None], out_rgb * trans_acc[..., None], torch.zeros_like(out_rgb)
        )
        trans_acc2 = torch.where(shade_m, trans_acc * surf_trans, trans_acc)
        return light_acc2, trans_acc2

    return shade


# -- the general tracer ---------------------------------------------------------

#: Iterations between two checks for walking rays (each check reads one
#: count back to the host).
CHECK_EVERY = 8
#: DDA steps a ray may take inside the brick row it fetched in one
#: iteration (`aic_tpu`'s default, which no caller changes).
SUBSTEPS = 2


def _argmin_axis(tmax: torch.Tensor) -> torch.Tensor:
    """DDA axis choice with the reference's tie-break (raycast.rs:584):
    prefer Z, then Y, then X on equal t."""
    x, y, z = tmax[..., 0], tmax[..., 1], tmax[..., 2]
    return torch.where(x < y, torch.where(x < z, 0, 2), torch.where(y < z, 1, 2))


def _onehot3(axis: torch.Tensor) -> torch.Tensor:
    return (axis[..., None] == torch.arange(3, device=axis.device)).to(torch.int32)


def _fma(a, b, c) -> torch.Tensor:
    """a·b + c rounded once to f32, as XLA's CPU code contracts it (the
    product of two f32 is exact in f64)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _dot3(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Sum of products over the last axis of three, in XLA's order and
    contraction: fma(a2, b2, fma(a1, b1, a0·b0))."""
    out = _fma(a[..., 2], b[..., 2], _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))
    return out[..., None] if keepdim else out


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis of three. The square root is
    taken in f64 and rounded once: the CPU's vectorized f32 `sqrt` is not
    correctly rounded, XLA's is."""
    return torch.sqrt(_dot3(x, x, keepdim).double()).to(torch.float32)


def _tile_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over axes 1 and 3 of [ht, th, wt, th, 3], the terms added one
    at a time in row-major order, as XLA's CPU reduction adds them: a
    beam's start can sit on a knife edge, so its sums follow `aic_tpu`'s."""
    ht, th, wt, tw, c = x.shape
    terms = x.permute(1, 3, 0, 2, 4).reshape(th * tw, ht, wt, c)
    acc = terms[0]
    for k in range(1, th * tw):
        acc = acc + terms[k]
    return acc / float(th * tw)


def _pow2(log2: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_left_shift(torch.ones_like(log2), log2)


def _clamp_cube(cube: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """clip(cube, 0, hi - 1) with a per-ray or per-axis upper bound."""
    return torch.minimum(torch.clamp(cube, min=0), hi - 1)


def trace_rays(
    state: SpaceState,
    origins: torch.Tensor,
    directions: torch.Tensor,
    options,
    include_sky: bool = True,
    max_steps: int | None = None,
    phases: int = 4,
    return_stats: bool = False,
    beam_tile: int = 8,
    return_hits: bool = False,
    count_steps: bool = False,
    illum_override: torch.Tensor | None = None,
):
    """Trace rays (world coords, any batch shape (..., 3), on the state's
    device) through the packed brick cells (`aic_tpu` `trace_rays`).
    Returns (light f32[...,3] premultiplied HDR, transmittance f32[...]);
    with `return_stats` appends {"iters", "walkers": i64[phases] loop
    iterations and walking rays per phase, "unfinished": bool tensor}
    (the RaytraceInfo and Flaws::UNFINISHED analogs); with `return_hits`
    the first phase's hit buffer, its "phases" entry the list of every
    phase's; with `count_steps` the DDA steps per ray (debug_pixel_cost).
    `illum_override` (f32[n, 3]) replaces the first phase's stored-light
    illumination (`trace_rays_bounce`'s hook). `compact=True`, rejected
    in `aic_tpu`, is not ported."""
    dev = state.device
    batch_shape = tuple(origins.shape[:-1])
    lower = torch.as_tensor(state.lower, dtype=torch.float32, device=dev)
    o = origins.reshape(-1, 3).to(device=dev, dtype=torch.float32) - lower
    d = directions.reshape(-1, 3).to(device=dev, dtype=torch.float32)
    if illum_override is not None:
        illum_override = illum_override.reshape(-1, 3)
    n_rays = o.shape[0]
    shape = tuple(state.contents.shape)
    size_i = torch.as_tensor(shape, dtype=torch.int32, device=dev)
    size_f = size_i.to(torch.float32)
    n_space = int(np.prod(shape))
    max_r = state.tables.padded_voxel_resolution
    vox_r3 = max_r**3
    if max_steps is None:
        max_steps = int(2 * (sum(shape) + 8 * max_r))

    entry = ray_entry_setup(o, d, shape)
    d_len, max_abs_d = entry["d_len"], entry["max_abs_d"]
    inv_d, step, step_pos = entry["inv_d"], entry["step"], entry["step_pos"]
    cube0, tmax0 = entry["cube0"], entry["tmax0"]
    hits_box, t_enter, t_exit = entry["hits_box"], entry["t_enter"], entry["t_exit"]
    t_to_view = d_len / float(options.view_distance)
    sky_rgb = _sky_sample(state, d)

    cells_rows = state.cells
    total_bricks = cells_rows.shape[0]
    sbd = brick_dims(shape)
    vbd = brick_dims((max_r, max_r, max_r))
    n_sb = int(np.prod(sbd))
    n_vb = int(np.prod(vbd))

    def brick_key(cube, inner, ventry):
        """Global brick-row index of `cube` in its current grid (the outer
        space's, or a voxel entry's)."""
        b = cube >> 2
        outer = (b[..., 0] * sbd[1] + b[..., 1]) * sbd[2] + b[..., 2]
        innerk = n_sb + ventry * n_vb + (b[..., 0] * vbd[1] + b[..., 1]) * vbd[2] + b[..., 2]
        return torch.where(inner, innerk, outer)

    def fetch_row(bkey):
        return cells_rows[torch.clamp(bkey, 0, total_bricks - 1).long()]

    def cell_in_row(row, cube):
        local = ((cube[..., 0] & 3) << 4) | ((cube[..., 1] & 3) << 2) | (cube[..., 2] & 3)
        return row.gather(-1, local.long()[..., None])[..., 0]

    # ---- beam pre-pass: per-tile conservative start distance ------------
    # Cone-march the skip field for each beam_tile² pixel tile: the whole
    # tile's rays provably hit nothing before the beam's stop distance,
    # so their DDA starts there.
    use_beams = (
        beam_tile > 0
        and len(batch_shape) == 2
        and batch_shape[0] % beam_tile == 0
        and batch_shape[1] % beam_tile == 0
    )

    def beam_start(th):
        ht, wt = batch_shape[0] // th, batch_shape[1] // th
        o_t = o.reshape(ht, th, wt, th, 3)
        d_t = d.reshape(ht, th, wt, th, 3)
        dn = d_t / _norm(d_t, keepdim=True)
        u = _tile_mean(dn)
        u = u / _norm(u, keepdim=True)  # [ht,wt,3]
        o_c = _tile_mean(o_t)
        ub, ocb = u[:, None, :, None, :], o_c[:, None, :, None, :]
        # Cone: radius(s) = r0 + s·spread bounds every tile ray's distance
        # from the centre ray's point at equal projection s.
        spread = 1.15 * _norm(dn - ub).amax(dim=(1, 3))
        r0 = _norm(o_t - ocb).amax(dim=(1, 3))
        # Per-member box entry as projections onto the centre ray.
        proj = _dot3(d_t, ub)  # [ht,th,wt,th]
        ooff = _dot3(o_t - ocb, ub)
        hits_t = hits_box.reshape(ht, th, wt, th) & (proj > 1e-9)
        projc = torch.clamp(proj, min=1e-9)
        inf = torch.full_like(proj, INF)
        s_first = torch.where(hits_t, _fma(t_enter.reshape(ht, th, wt, th), projc, ooff), inf).amin(dim=(1, 3))
        s_last_exit = torch.where(hits_t, _fma(t_exit.reshape(ht, th, wt, th), projc, ooff), -inf).amax(dim=(1, 3))

        max_abs_u = torch.clamp(u.abs().amax(-1), min=1e-30)
        missed = ~torch.isfinite(s_first)  # no member ray meets the box
        done = missed
        t = torch.where(done, 0.0, torch.clamp(s_first, min=0.0))
        no_inner = torch.zeros(t.shape, dtype=torch.bool, device=dev)
        zero_v = torch.zeros(t.shape, dtype=torch.int32, device=dev)
        # Up to 32 marching steps; once every tile is done a step changes
        # nothing, so all 32 run without a check.
        for _ in range(32):
            p = o_c + u * t[..., None]
            # L∞ distance from p to the volume box.
            m = torch.clamp(torch.maximum(-p, p - size_f), min=0.0).amax(-1)
            cube = _clamp_cube(torch.floor(p).to(torch.int32), size_i)
            cell = cell_in_row(fetch_row(brick_key(cube, no_inner, zero_v)), cube)
            vis = (cell & VISIBLE_BIT) != 0
            skip = (cell >> SKIP_SHIFT) & SKIP_MASK
            dist = torch.where(vis, 0, skip).to(torch.float32)
            # Safe empty radius around p: everything within m is outside
            # the box, or no visible cube within dist − m − 2.
            safe = torch.maximum(m, dist - m - 2.0)
            r = r0 + t * spread
            adv = (safe - r) * 0.99 / (max_abs_u + spread)
            good = ~done & (adv > 1e-3) & (t < s_last_exit)
            t = torch.where(good, t + adv, t)
            done = done | ~good
        # Ray-parameter bound: τ ≤ (t − (o_r−o_c)·u) / (d_r·u).
        tau = (t[:, None, :, None] - ooff) / projc
        tau = torch.where((proj > 1e-9) & ~missed[:, None, :, None], torch.clamp(tau, min=0.0), 0.0)
        return tau.reshape(n_rays)

    if use_beams:
        tau_beam = beam_start(beam_tile)
        # Skip ahead only past at least half a cube of proven empty space:
        # a stalled beam keeps the boundary-shading entry init.
        beyond = tau_beam > t_enter + 0.51 / max_abs_d
        t_eff = torch.maximum(t_enter, tau_beam)
        p_b = _fma(d, t_eff[..., None] + 1e-5, o)
        cube_b = _clamp_cube(torch.floor(p_b).to(torch.int32), size_i)
        tmax_b = ((cube_b + step_pos).to(torch.float32) - o) * inv_d
        tmax_b = torch.where(step == 0, INF, tmax_b)
        cube0 = torch.where(beyond[..., None], cube_b, cube0)
        tmax0 = torch.where(beyond[..., None], tmax_b, tmax0)
        # Beam start beyond the volume exit: the ray hits nothing.
        hits_box = hits_box & ~(beyond & (t_eff >= t_exit))

    # ---- origin inside a voxel-block cube: descend immediately ----------
    # (recursive_raycast applies to the origin cube too, raycast.rs:458;
    # the origin voxel itself is not shaded.)
    false1 = torch.zeros(n_rays, dtype=torch.bool, device=dev)
    zero1 = torch.zeros(n_rays, dtype=torch.int32, device=dev)
    cell0 = cell_in_row(fetch_row(brick_key(cube0, false1, zero1)), cube0)
    isvox0 = (
        entry["started_inside"] & hits_box
        & ((cell0 & VOXEL_BIT) != 0) & ((cell0 & VISIBLE_BIT) != 0)
    )
    res0_i = _pow2((cell0 >> RES_SHIFT) & 7)
    res0_f = res0_i.to(torch.float32)
    io0 = (o - cube0.to(torch.float32)) * res0_f[..., None]
    icube0 = torch.minimum(torch.clamp(torch.floor(io0).to(torch.int32), min=0), res0_i[..., None] - 1)
    itmax0 = ((icube0 + step_pos).to(torch.float32) - io0) * inv_d / res0_f[..., None]
    itmax0 = torch.where(step == 0, INF, itmax0)
    iv = isvox0[..., None]

    ctx0 = dict(
        o=o, d=d, inv_d=inv_d, step=step, step_pos=step_pos,
        t_delta_base=entry["t_delta_base"], d_len=d_len, max_abs_d=max_abs_d,
    )
    zi, zf = torch.zeros_like(zero1), torch.zeros(n_rays, dtype=torch.float32, device=dev)
    st = dict(
        cube=torch.where(iv, icube0, cube0),
        tmax=torch.where(iv, itmax0, tmax0),
        mode=isvox0.to(torch.int32),
        res_f=torch.where(isvox0, res0_f, 1.0),
        ventry=torch.where(isvox0, cell0 & 0xFFFF, 0),
        res_i=torch.where(isvox0, res0_i, 1),
        saved_cube=cube0,
        saved_tmax=tmax0,
        block_cube=cube0,
        walking=hits_box,
        hit_kind=zi, hit_idx=zi, hit_vflat=zi, hit_face=zi,
        hit_t=zf, hit_next_t=zf, hit_cube=torch.zeros_like(cube0),
    )
    if count_steps:
        st["steps"] = zi

    def sub_step(st, ctx, row, bkey):
        o, d, inv_d = ctx["o"], ctx["d"], ctx["inv_d"]
        step, step_pos = ctx["step"], ctx["step_pos"]
        walking = st["walking"]
        inner = st["mode"] == 1

        axis = _argmin_axis(st["tmax"])
        t_hit = st["tmax"].amin(-1)
        step_axis = step.gather(-1, axis[..., None])[..., 0]
        face = torch.where(step_axis > 0, axis, axis + 3)
        onehot = _onehot3(axis)
        new_cube = st["cube"] + onehot * step
        # Inner t_delta = base / R (direction scaled by R).
        tdelta = ctx["t_delta_base"] / st["res_f"][..., None]
        new_tmax = st["tmax"] + onehot.to(torch.float32) * tdelta

        # A ray acts this sub-step only if the cell it enters lies in the
        # fetched brick row; otherwise it stalls until the next fetch.
        act = walking & (brick_key(new_cube, inner, st["ventry"]) == bkey)
        grid_hi = torch.where(inner[..., None], st["res_i"][..., None], size_i)
        inside = ((new_cube >= 0) & (new_cube < grid_hi)).all(-1)
        exit_outer = act & ~inner & ~inside
        exit_inner = act & inner & ~inside

        cell = cell_in_row(row, new_cube)
        oc = _clamp_cube(new_cube, grid_hi)
        # Unbricked voxel-table index for shading (vox_rows layout).
        vflat = st["ventry"] * vox_r3 + (oc[..., 0] * max_r + oc[..., 1]) * max_r + oc[..., 2]

        visible = (cell & VISIBLE_BIT) != 0
        is_voxel = (cell & VOXEL_BIT) != 0
        skip = (cell >> SKIP_SHIFT) & SKIP_MASK
        pal_idx = cell & 0xFFFF
        res_log2 = (cell >> RES_SHIFT) & 7

        stepping = act & inside
        hit_atom = stepping & visible & ~is_voxel & ~inner
        hit_vox = stepping & visible & inner
        enter_block = stepping & visible & is_voxel & ~inner
        can_jump = stepping & ~visible & (skip >= 2)

        # Voxel-block entry: push the outer registers, start the inner DDA
        # one virtual voxel early along the entry axis. A block cell's
        # payload is its voxel-table row.
        blk_res = _pow2(res_log2)
        blk_res_f = blk_res.to(torch.float32)
        io = (o - new_cube.to(torch.float32)) * blk_res_f[..., None]
        entry_p_inner = io + d * blk_res_f[..., None] * t_hit[..., None]
        nudge = d * (1e-4 / ctx["d_len"])[..., None]
        icube_entry = torch.minimum(
            torch.clamp(torch.floor(entry_p_inner + nudge).to(torch.int32), min=0), blk_res[..., None] - 1
        )
        itmax = ((icube_entry + step_pos).to(torch.float32) - io) * inv_d / blk_res_f[..., None]
        itmax = torch.where(step == 0, INF, itmax)
        icube_pre = icube_entry - onehot * step
        itmax_pre = torch.where(onehot == 1, t_hit[..., None], itmax)

        # Skip jump: advance (skip-1)·0.99 cubes in the current grid's L∞
        # metric and re-derive the registers from the true origin.
        grid_scale = torch.where(inner, st["res_f"], 1.0)
        jump_dt = (skip.to(torch.float32) - 1.0) * 0.99 / (ctx["max_abs_d"] * grid_scale)
        t_jump = t_hit + jump_dt
        base = torch.where(
            inner[..., None], (o - st["block_cube"].to(torch.float32)) * grid_scale[..., None], o
        )
        p_jump = base + d * (grid_scale * t_jump)[..., None]
        jcube = _clamp_cube(torch.floor(p_jump).to(torch.int32), grid_hi)
        jtmax = ((jcube + step_pos).to(torch.float32) - base) * inv_d / grid_scale[..., None]
        jtmax = torch.where(step == 0, INF, jtmax)

        # Commit by case (stalled rays keep their state).
        eb, ei, cj, w = enter_block[..., None], exit_inner[..., None], can_jump[..., None], act[..., None]
        cube = torch.where(eb, icube_pre, torch.where(
            ei, st["saved_cube"], torch.where(cj, jcube, torch.where(w, new_cube, st["cube"]))))
        tmax = torch.where(eb, itmax_pre, torch.where(
            ei, st["saved_tmax"], torch.where(cj, jtmax, torch.where(w, new_tmax, st["tmax"]))))
        got_hit = hit_atom | hit_vox
        return dict(
            st,
            cube=cube,
            tmax=tmax,
            mode=torch.where(enter_block, 1, torch.where(exit_inner, 0, st["mode"])),
            res_f=torch.where(enter_block, blk_res_f, torch.where(exit_inner, 1.0, st["res_f"])),
            res_i=torch.where(enter_block, blk_res, torch.where(exit_inner, 1, st["res_i"])),
            ventry=torch.where(enter_block, pal_idx, st["ventry"]),
            saved_cube=torch.where(eb, new_cube, st["saved_cube"]),
            saved_tmax=torch.where(eb, new_tmax, st["saved_tmax"]),
            block_cube=torch.where(eb, new_cube, st["block_cube"]),
            walking=walking & ~got_hit & ~exit_outer,
            hit_kind=torch.where(hit_atom, HIT_ATOM, torch.where(hit_vox, HIT_VOXEL, st["hit_kind"])),
            hit_idx=torch.where(got_hit, pal_idx, st["hit_idx"]),
            hit_vflat=torch.where(hit_vox, vflat, st["hit_vflat"]),
            hit_face=torch.where(got_hit, face, st["hit_face"]).to(torch.int32),
            hit_t=torch.where(got_hit, t_hit, st["hit_t"]),
            hit_next_t=torch.where(got_hit, new_tmax.amin(-1), st["hit_next_t"]),
            hit_cube=torch.where(
                got_hit[..., None], torch.where(inner[..., None], st["block_cube"], new_cube), st["hit_cube"]
            ),
        )

    def traversal_body(st, ctx):
        """One iteration: gather the brick row each ray is about to enter,
        then take up to `SUBSTEPS` DDA steps inside it."""
        probe_cube = st["cube"] + _onehot3(_argmin_axis(st["tmax"])) * ctx["step"]
        bkey = brick_key(probe_cube, st["mode"] == 1, st["ventry"])
        row = fetch_row(bkey)
        for _ in range(SUBSTEPS):
            st = sub_step(st, ctx, row, bkey)
        if "steps" in st:
            st = dict(st, steps=st["steps"] + st["walking"].to(torch.int32) * SUBSTEPS)
        return st

    def scatter(full, idx, sub):
        return {k: v.index_copy(0, idx, sub[k]) for k, v in full.items()}

    def run_loop(st):
        """Walk the phase's walking rays for up to `max_steps` iterations.
        Returns the state and the iterations that began with a walker."""
        iters = torch.zeros((), dtype=torch.int64, device=dev)
        idx = torch.nonzero(st["walking"]).squeeze(1)
        if idx.numel() == 0 or max_steps <= 0:
            return st, iters
        sub = {k: v[idx] for k, v in st.items()}
        sctx = {k: v[idx] for k, v in ctx0.items()}
        done = 0
        while done < max_steps:
            for _ in range(min(CHECK_EVERY, max_steps - done)):
                iters += sub["walking"].any()
                sub = traversal_body(sub, sctx)
            done += min(CHECK_EVERY, max_steps - done)
            n_walk = int(sub["walking"].sum())
            if n_walk == 0:
                break
            if 2 * n_walk <= idx.numel() and done < max_steps:
                st = scatter(st, idx, sub)
                keep = torch.nonzero(sub["walking"]).squeeze(1)
                idx = idx[keep]
                sub = {k: v[keep] for k, v in sub.items()}
                sctx = {k: v[keep] for k, v in sctx.items()}
        return scatter(st, idx, sub), iters

    shade_fn = make_phase_shader(state, options, o, d, d_len, t_to_view, sky_rgb)
    light_acc = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    trans_acc = torch.ones(n_rays, dtype=torch.float32, device=dev)
    iters_used, walkers, all_hits = [], [], []
    unfinished = torch.zeros((), dtype=torch.bool, device=dev)
    for phase in range(phases):
        if return_stats:
            walkers.append(st["walking"].sum())
        st, iters = run_loop(st)
        iters_used.append(iters)
        has_hit = st["hit_kind"] != HIT_NONE
        if return_stats:
            # Rays still walking when the loop ran out of fuel.
            unfinished = unfinished | st["walking"].any()
        if return_hits:
            all_hits.append({
                k: st[k] for k in ("hit_kind", "hit_face", "hit_t", "hit_cube", "hit_idx", "hit_vflat")
            })
        if bool(has_hit.any()):
            light_acc, trans_acc = shade_fn(
                st, light_acc, trans_acc, illum_override if phase == 0 else None
            )
        # Resume rays that still transmit (ColorBuf::opaque cutoff).
        resume = has_hit & (trans_acc >= 1.0 / 256.0)
        st = dict(st, walking=resume, hit_kind=torch.zeros_like(st["hit_kind"]))

    if include_sky:
        light_acc = light_acc + sky_rgb * trans_acc[..., None]
        trans_acc = torch.zeros_like(trans_acc)

    out = (light_acc.reshape(batch_shape + (3,)), trans_acc.reshape(batch_shape))
    if return_stats:
        out = out + (dict(
            iters=torch.stack(iters_used), walkers=torch.stack(walkers), unfinished=unfinished,
        ),)
    if return_hits:
        first = dict(all_hits[0])
        first["phases"] = all_hits
        out = out + (first,)
    if count_steps:
        out = out + (st["steps"].reshape(batch_shape),)
    return out


# -- bounce lighting --------------------------------------------------------------


def bounce_from_samples(
    state: SpaceState,
    origins: torch.Tensor,
    directions: torch.Tensor,
    options,
    normal_samples: torch.Tensor,
    include_sky: bool = True,
    phases: int = 4,
):
    """`trace_rays_bounce` on given standard-normal draws f32[samples, n, 3]
    (n = the number of rays): sample i's secondary directions are the hit
    face's normal plus draw i, normalized to the unit sphere."""
    batch_shape = tuple(origins.shape[:-1])
    dev = state.device
    o = origins.reshape(-1, 3).to(device=dev, dtype=torch.float32)
    d = directions.reshape(-1, 3).to(device=dev, dtype=torch.float32)

    _, _, hits = trace_rays(
        state, o, d, options, include_sky=include_sky, phases=1, return_hits=True, beam_tile=0
    )
    has_hit = hits["hit_kind"] != HIT_NONE
    n = _table(faces.FACE_NORMALS, torch.float32, dev)[torch.clamp(hits["hit_face"], 0, 5).long()]
    point = o + d * hits["hit_t"][..., None] + n * 1e-4

    flat_opts = dataclasses.replace(options, lighting_display=LIGHT_FLAT)
    illum = torch.zeros_like(point)
    for sph in normal_samples.to(device=dev, dtype=torch.float32):
        sph = sph / torch.clamp(_norm(sph, keepdim=True), min=1e-9)
        d2 = n + sph
        # Degenerate direction (sample ≈ -normal): fall back to the normal.
        d2 = torch.where(_norm(d2, keepdim=True) < 1e-3, n, d2)
        li, _ = trace_rays(state, point, d2, flat_opts, include_sky=True, phases=2, beam_tile=0)
        illum = illum + li
    illum = illum / float(normal_samples.shape[0])

    light, trans = trace_rays(
        state, o, d, options, include_sky=include_sky, phases=phases,
        illum_override=torch.where(has_hit[..., None], illum, 0.0), beam_tile=0,
    )
    return light.reshape(batch_shape + (3,)), trans.reshape(batch_shape)


def trace_rays_bounce(
    state: SpaceState,
    origins: torch.Tensor,
    directions: torch.Tensor,
    options,
    generator: torch.Generator,
    include_sky: bool = True,
    phases: int = 4,
):
    """LightingOption::Bounce (surface.rs:113-163; `aic_tpu`
    `trace_rays_bounce`): primary hits are illuminated by
    `options.bounce_samples` Lambertian secondary rays (face normal +
    uniform unit-sphere sample, origin nudged off the surface), each
    traced with stored-light Flat shading; later transparency phases
    shade Flat. `generator` (on the state's device) draws the samples:
    bounce is pseudo-random by design. Returns (light, trans)."""
    samples = max(int(options.bounce_samples), 1)
    n = int(np.prod(origins.shape[:-1]))
    draws = torch.randn((samples, n, 3), generator=generator, device=state.device)
    return bounce_from_samples(state, origins, directions, options, draws, include_sky, phases)
