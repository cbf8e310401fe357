"""Collision geometry: solid boxes around a body and box sweeps, batched
over bodies.

Port of `aic_tpu/physics/collision.py` (the reference's collision core,
all-is-cubes/src/physics/collision.rs), with the body batch as the
leading axis of every tensor where `aic_tpu` vmaps. Every cube in a
(2·WINDOW+1)³ window around a body contributes its solid geometry as
axis-aligned boxes: one unit box for a uniformly hard block, one box of
edge 1/resolution per solid voxel of a voxel block (`vox_solid`). The
swept and overlap tests run over all boxes at once.

- t ties and entry axes follow the slab test like aab_raycast;
- boxes the body already overlaps never block movement
  (StopAt::NotAlreadyColliding), but are reported as `within_any`;
- touching exactly never counts as collision.
"""

from __future__ import annotations

import numpy as np
import torch

from ..space.state import SpaceState, lookup_contents

POSITION_EPSILON = 1e-4  # physics/mod.rs POSITION_EPSILON (nudge gap)
_EPS = 1e-6

#: Half-size of the candidate window (cubes): a body box up to ~2.2 cubes
#: plus one cube of motion per segment.
WINDOW = 2

_OFFSETS = np.stack(
    np.meshgrid(*([np.arange(-WINDOW, WINDOW + 1)] * 3), indexing="ij"), axis=-1
).reshape(-1, 3)


def window_solid_boxes(state: SpaceState, center_cube: torch.Tensor):
    """All solid collision boxes in each body's window.

    center_cube: i64[B,3] world coords. Returns (lo f32[B,N,3], hi
    f32[B,N,3], valid bool[B,N]) in world coordinates; N = 125 uniform
    boxes plus 125·R³ voxel boxes (R the padded collision resolution)."""
    t = state.tables
    dev = center_cube.device
    offsets = torch.as_tensor(_OFFSETS, dtype=torch.int64, device=dev)
    cand = center_cube[:, None, :] + offsets[None]  # [B,C,3] world
    lower = torch.as_tensor(state.lower, dtype=torch.int64, device=dev)
    pal, inside = lookup_contents(state, cand - lower)  # outside the bounds: air
    pal = pal.long()
    cu = t.collision_uniform[pal]  # 1 hard / 0 none / -1 voxel

    cand_f = cand.to(torch.float32)
    uni_lo, uni_hi = cand_f, cand_f + 1.0
    uni_valid = inside & (cu == 1)

    n_vox_entries = t.vox_solid.shape[0]
    if n_vox_entries == 0:
        return uni_lo, uni_hi, uni_valid
    r_pad = t.vox_solid.shape[1]
    ventry = t.voxel_index[pal]
    res = t.collision_res[pal]  # min(resolution, 32): vox_solid's granularity
    solid = t.vox_solid.reshape(n_vox_entries, -1)[ventry.clamp(min=0)]  # [B,C,R³]
    vgrid = torch.as_tensor(
        np.stack(np.meshgrid(*([np.arange(r_pad)] * 3), indexing="ij"), axis=-1).reshape(-1, 3),
        dtype=torch.float32, device=dev,
    )  # [R³,3]
    res_f = res.to(torch.float32)[..., None, None]  # [B,C,1,1]
    vox_lo = cand_f[:, :, None, :] + vgrid[None, None] / res_f
    vox_hi = cand_f[:, :, None, :] + (vgrid[None, None] + 1.0) / res_f
    in_res = (vgrid[None, None] < res_f).all(-1)
    vox_valid = inside[..., None] & (cu == -1)[..., None] & solid & in_res

    b = center_cube.shape[0]
    lo = torch.cat([uni_lo, vox_lo.reshape(b, -1, 3)], dim=1)
    hi = torch.cat([uni_hi, vox_hi.reshape(b, -1, 3)], dim=1)
    valid = torch.cat([uni_valid, vox_valid.reshape(b, -1)], dim=1)
    return lo, hi, valid


def boxes_overlap(lo, hi, body_lo, body_hi):
    """Strict (nonzero-volume) overlap of each box [B,N,3] with each
    body's box [B,3]; touching exactly does not count."""
    return ((body_hi[:, None, :] > lo + _EPS) & (body_lo[:, None, :] < hi - _EPS)).all(-1)


def sweep_boxes(lo, hi, valid, pos, delta, box_lo, box_hi):
    """Swept collision of each moving body box against its candidate
    boxes (Minkowski: the body's origin against boxes grown by its
    extents). Returns dict(hit_any, t_hit, axis, first, dlo, dhi,
    within_any), per body, following collide_along_ray +
    collide_and_advance."""
    dlo = lo - box_hi[:, None, :]
    dhi = hi + (0.0 - box_lo)[:, None, :]
    p = pos[:, None, :]
    dd = delta[:, None, :]

    in_slab0 = (p > dlo + _EPS) & (p < dhi - _EPS)
    overlap0 = in_slab0.all(-1)
    within_any = (valid & overlap0).any(-1)

    safe_d = torch.where(dd == 0.0, torch.full_like(dd, 1e-30), dd)
    t0 = (dlo - p) / safe_d
    t1 = (dhi - p) / safe_d
    t_lo = torch.minimum(t0, t1)
    t_hi = torch.maximum(t0, t1)
    inf = torch.full_like(t_lo, float("inf"))
    t_lo = torch.where(dd == 0.0, torch.where(in_slab0, -inf, inf), t_lo)
    t_hi = torch.where(dd == 0.0, torch.where(in_slab0, inf, -inf), t_hi)
    t_enter = t_lo.amax(-1)
    t_exit = t_hi.amin(-1)
    entry_axis = torch.argmax(t_lo, dim=-1)

    hits = valid & ~overlap0 & (t_enter <= t_exit) & (t_enter >= 0.0) & (t_enter < 1.0)
    t_cand = torch.where(hits, t_enter, torch.full_like(t_enter, float("inf")))
    t_hit = t_cand.amin(-1)
    first = torch.argmin(t_cand, dim=-1)
    axis = entry_axis.gather(1, first[:, None])[:, 0]
    return dict(hit_any=torch.isfinite(t_hit), t_hit=t_hit, axis=axis, first=first,
                dlo=dlo, dhi=dhi, within_any=within_any)


def colliding_at(state: SpaceState, pos, box_lo, box_hi):
    """Is each body box at `pos` [B,3] strictly overlapping a solid box?"""
    center = torch.floor(pos + (box_lo + box_hi) * 0.5).to(torch.int64)
    lo, hi, valid = window_solid_boxes(state, center)
    return (valid & boxes_overlap(lo, hi, pos + box_lo, pos + box_hi)).any(-1)
