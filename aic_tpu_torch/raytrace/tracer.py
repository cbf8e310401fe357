"""Ray entry, sky sample and the per-phase hit shader, in plain PyTorch.

Port of the pieces of `aic_tpu/raytrace/tracer.py` that the megakernel
path shares with the XLA tracer (there they are XLA code, not Pallas):
`ray_entry_setup` (:334), `_sky_sample` (:1110), `make_phase_shader`
(:383-475) with smooth-lighting interpolation (:130-325), flat light and
volumetric transmittance (:478), and fog. The XLA tracer itself
(`trace_rays`, brick cells, beam pre-pass) is not ported yet.

Shading follows the reference's `Surface::to_light` (surface.rs:73-200);
compositing is front-to-back premultiplied alpha. All math is float32.
Where `aic_tpu` used a one-hot matmul or one-hot sum to avoid a TPU
gather, this port indexes directly: the selected values are identical.
"""

from __future__ import annotations

import numpy as np
import torch

from ..math import faces, lightpack
from ..space.state import SpaceState
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
        inv_d=inv_d, step=step, d_len=d_len, cube0=cube0, tmax0=tmax0,
        hits_box=hits_box,
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

    Returns shade(hits, light_acc, trans_acc) → (light_acc', trans_acc'),
    where `hits` holds hit_kind, hit_idx, hit_vflat, hit_face, hit_t,
    hit_next_t and hit_cube."""
    n_rays = o.shape[0]
    tables = state.tables
    n_space = int(np.prod(state.contents.shape))

    fog_on = options.fog != "none"
    fog_blend = float(options.fog_blend())
    lighting = options.lighting_display
    if not state.light_enabled:
        # LightPhysics::None → unit illumination (updater.rs:580 get()).
        lighting = LIGHT_NONE
    if lighting == LIGHT_BOUNCE:
        raise NotImplementedError("bounce lighting is not ported yet")
    transparency = options.transparency

    use_interp_rows = (
        lighting in (LIGHT_LINEAR, LIGHT_SMOOTHSTEP, LIGHT_COARSE)
        and n_space <= _INTERP_ROWS_MAX_VOLUME
    )
    interp_rows = _build_interp_rows(state) if use_interp_rows else None

    # One combined material table, indexed by kind.
    n_pal = tables.palette_rows.shape[0]
    mat_rows = torch.cat([tables.palette_rows, tables.vox_rows.reshape(-1, 8)], 0)

    def shade(hits, light_acc, trans_acc):
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
        elif lighting == LIGHT_FLAT:
            illum = _flat_light(state, hits["hit_cube"], hits["hit_face"])
        elif use_interp_rows:
            illum = _interpolated_light_rows(
                state, interp_rows, hits["hit_cube"], point, hits["hit_face"], lighting
            )
        else:
            illum = _interpolated_light(
                state, hits["hit_cube"], point, hits["hit_face"], lighting
            )

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
