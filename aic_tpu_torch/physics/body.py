"""Body physics: axis-aligned boxes against the voxel world, batched over
bodies.

Port of `aic_tpu/physics/body.py` (the reference's step.rs:314
`step_one_body`, :592 `collide_and_advance`, :660 `push_out`, :745
`crush_if_colliding`, :804 `uncrush`). `aic_tpu` vmaps one body's step;
here every tensor carries the body batch as its leading axis, and each
`lax.while_loop` / `fori_loop` is a Python loop with the same exit test,
advancing only the bodies whose test still holds, as a vmapped loop does.

- gravity and the velocity clamp (step.rs:305 VELOCITY_MAGNITUDE_LIMIT);
- swept collision at voxel resolution (collision.py), the movement cut
  into segments of at most one cube so the candidate window covers the
  sweep; each hit zeroes the velocity along its axis and the rest slides;
- recovery in the reference's order (uncrush, push_out, crush), run only
  for the bodies that need it, one body at a time: it is the rare path
  of a body stuck in matter or squeezed.

`aic_tpu`'s documented deviations carry over: push_out finds the exit
surface by sampled bisection, and crush picks the gentlest contact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..space.state import SpaceState
from .collision import POSITION_EPSILON, boxes_overlap, colliding_at, sweep_boxes, window_solid_boxes

VELOCITY_MAGNITUDE_LIMIT = 1e4  # step.rs:305
VELOCITY_EPSILON_SQUARED = 1e-12  # quiescence threshold

#: Body fields and their dtypes; every field has a leading batch axis in a
#: batch of bodies.
BODY_DTYPES = {
    "position": torch.float32, "velocity": torch.float32, "box_lo": torch.float32,
    "box_hi": torch.float32, "occ_lo": torch.float32, "occ_hi": torch.float32,
    "flying": torch.bool, "noclip": torch.bool, "yaw": torch.float32, "pitch": torch.float32,
}


@dataclasses.dataclass(frozen=True)
class Body:
    """physics/body.rs:38 `Body`, one body or a batch of them.

    `occ_lo` / `occ_hi` is the occupying box, relative to the position:
    the collision box, shrunk by crush when the body is squeezed into a
    space smaller than itself."""

    position: torch.Tensor  # f32[...,3] world coords
    velocity: torch.Tensor  # f32[...,3] cubes/s
    box_lo: torch.Tensor  # f32[...,3] collision box, relative to position
    box_hi: torch.Tensor  # f32[...,3]
    occ_lo: torch.Tensor  # f32[...,3] occupying box (crushable)
    occ_hi: torch.Tensor  # f32[...,3]
    flying: torch.Tensor  # bool[...]
    noclip: torch.Tensor  # bool[...]
    yaw: torch.Tensor  # f32[...] look direction (degrees), for characters
    pitch: torch.Tensor  # f32[...]

    @staticmethod
    def make(position, box_lo=(-0.3, 0.0, -0.3), box_hi=(0.3, 1.75, 0.3),
             velocity=(0.0, 0.0, 0.0), flying=False, noclip=False,
             yaw=0.0, pitch=0.0, occ_lo=None, occ_hi=None, device="cuda") -> "Body":
        """One body on `device` (the card unless the caller asks for the
        CPU); a character-sized box by default (body.rs default)."""
        values = dict(
            position=position, velocity=velocity, box_lo=box_lo, box_hi=box_hi,
            occ_lo=box_lo if occ_lo is None else occ_lo, occ_hi=box_hi if occ_hi is None else occ_hi,
            flying=flying, noclip=noclip, yaw=yaw, pitch=pitch,
        )
        return Body(**{k: torch.as_tensor(np.asarray(v), device=device).to(BODY_DTYPES[k])
                       for k, v in values.items()})

    @staticmethod
    def stack(bodies: list) -> "Body":
        return Body(**{k: torch.stack([getattr(b, k) for b in bodies]) for k in BODY_DTYPES})

    @staticmethod
    def cat(batches: list) -> "Body":
        """One batch of the bodies of several batches, in order."""
        return Body(**{k: torch.cat([getattr(b, k) for b in batches]) for k in BODY_DTYPES})

    def row(self, i: int) -> "Body":
        """Body i of a batch, as a batch of one."""
        return Body(**{k: getattr(self, k)[i : i + 1] for k in BODY_DTYPES})

    def set_position(self, position) -> "Body":
        """Functional setter; a non-finite input is ignored wholesale
        (body.rs set_position)."""
        p = torch.as_tensor(position, dtype=torch.float32, device=self.position.device)
        return dataclasses.replace(self, position=torch.where(torch.isfinite(p).all(), p, self.position))

    def set_velocity(self, velocity) -> "Body":
        """Functional setter; a non-finite input is ignored wholesale
        (body.rs set_velocity)."""
        v = torch.as_tensor(velocity, dtype=torch.float32, device=self.velocity.device)
        return dataclasses.replace(self, velocity=torch.where(torch.isfinite(v).all(), v, self.velocity))


def body_from_numpy(fields: dict, device="cuda") -> Body:
    """A port Body on `device` from the numpy arrays of an `aic_tpu` Body
    (one flat dict of its fields by name)."""
    return Body(**{k: torch.as_tensor(np.array(fields[k]), device=device).to(dt) for k, dt in BODY_DTYPES.items()})


def body_to_numpy(body: Body) -> dict:
    """The reverse of `body_from_numpy`."""
    return {k: getattr(body, k).cpu().numpy() for k in BODY_DTYPES}


def _where(cond, a, b):
    """torch.where with `cond` [B] broadcast over trailing axes."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim())), a, b)


def _one_hot(axis, n=3):
    return torch.nn.functional.one_hot(axis, n).to(torch.float32)


def _collide_segment(state: SpaceState, pos, delta, box_lo, box_hi):
    """One collide_and_advance (step.rs:592) per body, |delta| <= 1 cube.
    Returns (new_pos, remaining delta, hit axis or -1, hit_any)."""
    center = torch.floor(pos + (box_lo + box_hi) * 0.5).to(torch.int64)
    lo, hi, valid = window_solid_boxes(state, center)
    sw = sweep_boxes(lo, hi, valid, pos, delta, box_lo, box_hi)
    hit_any, axis, first = sw["hit_any"], sw["axis"], sw["first"]
    oh = _one_hot(axis)
    # Advance to the contact, then snap the hit axis to the contact plane
    # an epsilon short of it (nudge_on_ray, step.rs:620).
    t_adv = sw["t_hit"].clamp(0.0, 1.0)
    advanced = pos + delta * t_adv[:, None]
    rows = torch.arange(pos.shape[0], device=pos.device)
    plane = torch.where(
        delta[rows, axis] > 0,
        sw["dlo"][rows, first, axis] - POSITION_EPSILON,
        sw["dhi"][rows, first, axis] + POSITION_EPSILON,
    )
    snapped = advanced * (1.0 - oh) + plane[:, None] * oh
    new_pos = _where(hit_any, snapped, pos + delta)
    remaining = _where(hit_any, delta * (1.0 - t_adv[:, None]), torch.zeros_like(delta))
    remaining = _where(hit_any, remaining * (1.0 - oh), remaining)
    return new_pos, remaining, torch.where(hit_any, axis, -1), hit_any


# --- recovery: push_out / crush / uncrush (one body: batches of one) --------

# 27 push-out directions (step.rs:666-684); the zero one is replaced by
# minus the velocity.
_DIRS = np.stack(
    np.meshgrid(*([np.array([-1.0, 0.0, 1.0])] * 3), indexing="ij"), axis=-1
).reshape(-1, 3).astype(np.float32)

_PUSH_SAMPLES = 8
_PUSH_STEP = 0.25  # reach = 2.0 cubes
_PUSH_BISECT = 10


def _push_out(state: SpaceState, body: Body) -> Body:
    """push_out (step.rs:660) for a batch of one: move the position out of
    solid matter along the direction with the shortest clear distance."""
    pos, box_lo, box_hi = body.position, body.box_lo, body.box_hi
    colliding = colliding_at(state, pos, box_lo, box_hi)[0]
    dirs = torch.as_tensor(_DIRS, device=pos.device)
    is_zero = (dirs == 0.0).all(-1)
    dirs = torch.where(is_zero[:, None], -body.velocity, dirs)
    norms = torch.sqrt((dirs * dirs).sum(-1))
    unit = dirs / torch.clamp(norms, min=1e-30)[:, None]
    usable = norms > 1e-30
    ts = (torch.arange(_PUSH_SAMPLES, dtype=torch.float32, device=pos.device) + 1.0) * _PUSH_STEP

    def clear_at(d, t):
        return ~colliding_at(state, pos + d * t, box_lo, box_hi)[0]

    dists = []
    for j in range(unit.shape[0]):  # one window at a time, as aic_tpu's lax.map
        d = unit[j]
        first_clear, found = ts[-1], torch.zeros((), dtype=torch.bool, device=pos.device)
        for k in range(_PUSH_SAMPLES):
            c = clear_at(d, ts[k])
            first_clear = torch.where(c & ~found, ts[k], first_clear)
            found = found | c
        t_lo, t_hi = first_clear - _PUSH_STEP, first_clear
        for _ in range(_PUSH_BISECT):
            mid = 0.5 * (t_lo + t_hi)
            c = clear_at(d, mid)
            t_lo, t_hi = torch.where(c, t_lo, mid), torch.where(c, mid, t_hi)
        dists.append(torch.where(found & usable[j], t_hi + POSITION_EPSILON,
                                 torch.full_like(t_hi, float("inf"))))
    dists = torch.stack(dists)
    best = torch.argmin(dists)
    ok = colliding & torch.isfinite(dists[best])
    return dataclasses.replace(body, position=torch.where(ok, pos + unit[best] * dists[best], pos))


_CRUSH_ITERS = 6
_OPP = [3, 4, 5, 0, 1, 2]


def _crush(state: SpaceState, body: Body) -> Body:
    """crush_if_colliding (step.rs:745) for a batch of one: shrink the
    occupying box one face at a time (the face of least penetration)
    until it is free of collision."""
    pos = body.position
    center = torch.floor(pos + (body.box_lo + body.box_hi) * 0.5).to(torch.int64)
    lo, hi, valid = window_solid_boxes(state, center)
    occ_lo, occ_hi = body.occ_lo, body.occ_hi
    box_out = torch.cat([-lo[0], hi[0]], dim=-1)  # [N,6] outward coords
    for _ in range(_CRUSH_ITERS):
        abs_lo, abs_hi = pos + occ_lo, pos + occ_hi
        contacts = (valid & boxes_overlap(lo, hi, abs_lo, abs_hi))[0]
        occ_out = torch.cat([-abs_lo[0], abs_hi[0]])
        depth = occ_out[None, :] + box_out[:, _OPP]
        depth = torch.where(depth >= 0.0, depth, torch.full_like(depth, float("inf")))
        least = torch.where(contacts, depth.amin(-1), torch.full_like(depth[:, 0], float("inf")))
        n_best = torch.argmin(least)
        f_best = torch.argmin(depth[n_best])
        d_best = depth[n_best, f_best]
        any_contact = torch.isfinite(least[n_best]) & contacts.any()
        onehot = _one_hot(f_best % 3)
        is_pos = f_best >= 3
        new_lo = torch.where(is_pos, occ_lo, occ_lo + onehot * d_best)
        new_hi = torch.where(is_pos, occ_hi - onehot * d_best, occ_hi)
        apply = any_contact & (new_lo <= new_hi).all()
        occ_lo, occ_hi = torch.where(apply, new_lo, occ_lo), torch.where(apply, new_hi, occ_hi)
    return dataclasses.replace(body, occ_lo=occ_lo, occ_hi=occ_hi)


_UNCRUSH_ITERS = 3


def _uncrush(state: SpaceState, body: Body) -> Body:
    """uncrush (step.rs:804) for a batch of one: regrow the occupying box
    toward the collision box one axis at a time, the axis of largest
    volume gain first (ties: the last of X, Y, Z, as Rust's max_by_key)."""
    if not bool(((body.occ_lo != body.box_lo) | (body.occ_hi != body.box_hi)).any()):
        return body
    pos = body.position[0]
    center = torch.floor(body.position + (body.box_lo + body.box_hi) * 0.5).to(torch.int64)
    lo, hi, valid = window_solid_boxes(state, center)
    unc_lo, unc_hi = body.position + body.box_lo, body.position + body.box_hi
    contacts_unc = (valid & boxes_overlap(lo, hi, unc_lo, unc_hi))[0]
    if not bool(contacts_unc.any()):  # no collision at all: uncrush fully
        return dataclasses.replace(body, occ_lo=body.box_lo, occ_hi=body.box_hi)
    lo, hi, unc_lo, unc_hi = lo[0], hi[0], unc_lo[0], unc_hi[0]
    unc_out = torch.cat([-unc_lo, unc_hi])
    box_out = torch.cat([-lo, hi], dim=-1)
    limit = -box_out[:, _OPP].T  # [6,N]
    eps = 1e-6
    inf = float("inf")

    def with_axis(base, values):
        """[3,3]: `base` with axis a set to values[a], for each a."""
        out = base[None].repeat(3, 1)
        idx = torch.arange(3, device=base.device)
        out[idx, idx] = values
        return out

    occ_lo, occ_hi = body.occ_lo[0], body.occ_hi[0]
    for _ in range(_UNCRUSH_ITERS):
        abs_lo, abs_hi = pos + occ_lo, pos + occ_hi
        exp_lo, exp_hi = with_axis(abs_lo, unc_lo), with_axis(abs_hi, unc_hi)
        inter = ((exp_hi[:, None, :] > lo[None] + eps) & (exp_lo[:, None, :] < hi[None] - eps)).all(-1)
        relevant = contacts_unc[None, :] & inter  # [3,N]
        neg_side = hi.T <= pos[:, None]
        pos_side = lo.T >= pos[:, None]
        middle = relevant & ~neg_side & ~pos_side
        occ_out = torch.cat([-abs_lo, abs_hi])
        rel6 = torch.cat([relevant & neg_side, relevant & pos_side], dim=0)
        side_min = torch.where(rel6, limit, torch.full_like(limit, inf)).amin(-1)
        mid6 = torch.cat([middle.any(-1)] * 2)
        clear = torch.minimum(unc_out, torch.minimum(
            torch.where(mid6, occ_out, torch.full_like(occ_out, inf)), side_min))
        cand_lo, cand_hi = with_axis(abs_lo, -clear[:3]), with_axis(abs_hi, clear[3:])
        valid_box = ((cand_lo <= cand_hi).all(-1) & (cand_lo <= pos[None]).all(-1)
                     & (cand_hi >= pos[None]).all(-1))
        vol0 = torch.prod(abs_hi - abs_lo)
        vols = torch.prod(cand_hi - cand_lo, dim=-1)
        gains = torch.where(valid_box, vols - vol0, torch.full_like(vols, -inf))
        best = 2 - torch.argmax(gains.flip(0))
        improve = gains[best] > 0.0
        abs_lo = torch.where(improve, cand_lo[best], abs_lo)
        abs_hi = torch.where(improve, cand_hi[best], abs_hi)
        occ_lo, occ_hi = abs_lo - pos, abs_hi - pos
    return dataclasses.replace(body, occ_lo=occ_lo[None], occ_hi=occ_hi[None])


def _needs_recovery(state: SpaceState, bodies: Body) -> torch.Tensor:
    crushed = ((bodies.occ_lo != bodies.box_lo) | (bodies.occ_hi != bodies.box_hi)).any(-1)
    stuck = colliding_at(state, bodies.position, bodies.box_lo, bodies.box_hi)
    return (crushed | stuck) & ~bodies.noclip


def _recover(state: SpaceState, body: Body) -> Body:
    """Recovery of one body in reference order (step.rs:370-386)."""
    return _crush(state, _push_out(state, _uncrush(state, body)))


def _step(state: SpaceState, bodies: Body, dt: float, gravity: torch.Tensor):
    """step_one_body (step.rs:314) for every body of the batch."""
    b = bodies
    velocity = _where(b.flying | b.noclip, b.velocity, b.velocity + gravity * dt)
    vmag2 = (velocity**2).sum(-1)
    velocity = _where(
        vmag2 > VELOCITY_MAGNITUDE_LIMIT**2,
        velocity * (VELOCITY_MAGNITUDE_LIMIT / torch.sqrt(torch.clamp(vmag2, min=1e-30)))[:, None],
        velocity,
    )
    velocity = torch.where(torch.isfinite(velocity), velocity, torch.zeros_like(velocity))
    quiescent = vmag2 <= VELOCITY_EPSILON_SQUARED
    delta = velocity * dt

    # Movement in segments of at most one cube per axis; each may slide.
    pos, d, vel = b.position.clone(), delta.clone(), velocity.clone()  # updated in place below
    contacts = torch.zeros(d.shape[:1] + (6,), dtype=torch.bool, device=d.device)
    fuel = torch.ceil(delta.abs().amax(-1)).to(torch.int32) + 8
    while True:
        # The bodies whose loop goes on (one read-back a segment, the loop's
        # exit test); the others keep their carry, as in a vmapped loop.
        act = ((fuel > 0) & (d.abs().amax(-1) > 1e-9)).nonzero().squeeze(1)
        if act.numel() == 0:
            break
        da = d[act]
        seg_scale = torch.minimum(torch.ones_like(da[:, 0]), 1.0 / torch.clamp(da.abs().amax(-1), min=1e-9))
        seg = da * seg_scale[:, None]
        new_pos, rem_seg, axis, hit = _collide_segment(state, pos[act], seg, b.box_lo[act], b.box_hi[act])
        rest = da * (1.0 - seg_scale)[:, None]
        a0 = axis.clamp(min=0)
        axis_oh = torch.where((axis >= 0)[:, None], _one_hot(a0), torch.zeros_like(seg))
        rows = torch.arange(act.numel(), device=d.device)
        face = torch.where(seg[rows, a0] > 0, a0 + 3, a0)
        hit_face = torch.zeros_like(contacts[act])
        hit_face[rows, face] = True
        pos[act] = new_pos
        d[act] = (rem_seg + rest) * (1.0 - axis_oh)
        vel[act] = vel[act] * (1.0 - axis_oh)
        contacts[act] = contacts[act] | (hit_face & hit[:, None])
        fuel[act] = fuel[act] - 1

    # noclip bodies move unobstructed (step.rs:335); quiescent ones rest.
    new_pos = _where(b.noclip, b.position + delta, pos)
    new_vel = _where(b.noclip, velocity, vel)
    new_pos = _where(quiescent, b.position, new_pos)
    return dataclasses.replace(b, position=new_pos, velocity=new_vel), dict(
        on_ground=contacts[:, 1], contacts=contacts, quiescent=quiescent)


def step_bodies(state: SpaceState, bodies: Body, dt: float, gravity):
    """One physics step of a batch of bodies (the device form of
    body_physics_step_system, space/step.rs:68). Recovery (uncrush →
    push_out → crush) runs first for the bodies that need it; then every
    body moves. Returns (bodies, dict of per-body on_ground, contacts,
    quiescent)."""
    gravity = torch.as_tensor(gravity, dtype=torch.float32, device=bodies.position.device)
    needs = _needs_recovery(state, bodies).tolist()
    if any(needs):
        bodies = Body.cat([_recover(state, bodies.row(i)) if n else bodies.row(i) for i, n in enumerate(needs)])
    return _step(state, bodies, float(np.float32(dt)), gravity)


def push_out(state: SpaceState, bodies: Body) -> Body:
    """push_out for each body of a batch."""
    return Body.cat([_push_out(state, bodies.row(i)) for i in range(bodies.position.shape[0])])


def crush_if_colliding(state: SpaceState, bodies: Body) -> Body:
    """crush_if_colliding for each body of a batch."""
    return Body.cat([_crush(state, bodies.row(i)) for i in range(bodies.position.shape[0])])


def uncrush(state: SpaceState, bodies: Body) -> Body:
    """uncrush for each body of a batch."""
    return Body.cat([_uncrush(state, bodies.row(i)) for i in range(bodies.position.shape[0])])
