"""Reference-procedure light evaluation (port of `aic_tpu/light/refproc.py`).

The reference's golden images are rendered from light fields produced by
``fast_evaluate_light()`` followed by ``evaluate_light(1, ..)``
(test-renderers/cases/src/lib.rs:1396-1397), not from the fixed point of
the light equation: its queue updater refuses to re-enqueue 1-unit
differences (updater.rs:343-354), so propagation chains stall where the
dense solver (`dense.py`) goes on to the fixed point.

- `fast_evaluate_seed`: the column-scan seed and initial queue
  (updater.rs:531), which `evaluate_light_dense` also starts from.
- `evaluate_light_reference`: the priority-bucket queue. Each round pops
  up to `_CHUNK` cubes at the current maximum priority, chosen by the same
  numpy calls in the same order as `aic_tpu`'s (so both pop the same
  cubes while their fields agree), relights them from the same field with
  `relight_batch` (K2's listed kernel over 64 rows on the card, the plain
  walk on the CPU), applies every nonzero difference, guess-fills
  uninitialized neighbours (updater.rs:307-335) and re-enqueues the
  ray-walk dependencies of each cube whose light moved by more than one
  step (`_deps_scatter`).

The queue's bookkeeping (the priority field, the guess-fill's writes) is
host numpy, as in `aic_tpu`: the guess-fill writes face by face with
fancy indexing, where the last write to a neighbour shared by two changed
cubes wins, an order indexed assignment on CUDA does not promise. The
chart walks run on the state's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..math import faces, lightpack
from ..space.state import SpaceState, lookup_contents
from .chart import STEP_END, STEP_PAD

#: Queue priorities (queue.rs:25-45).
PRIORITY_ESTIMATED = 200

#: Pops a round: the reference's threaded updater pops 32 requests,
#: computes them from the same field, then applies all 32
#: (updater.rs:205-246).
_CHUNK = 32

#: Rows a round's batch is padded to (`aic_tpu` pads to the next power
#: of two, at least 64, so that its compiled walk keeps one shape).
_ROWS = 64


def fast_evaluate_seed(state: SpaceState):
    """``fast_evaluate_light`` (updater.rs:531-576): returns
    ``(seeded_state, priority u8[X,Y,Z] numpy)``.

    Per (x, z) column scanned from +Y down: opaque-for-light cubes set
    OPAQUE (and cover everything below), visible cubes and cubes adjacent
    to visible ones are queued at ESTIMATED with light = sky's +Y face
    (uninitialized black when covered), all others NO_RAYS. Host numpy,
    as in `aic_tpu`."""
    contents = state.contents.cpu().numpy()
    t = state.tables
    visible_t = t.visible.cpu().numpy()
    opaque_t = t.opaque_faces.cpu().numpy()
    emission_t = t.light_emission.cpu().numpy()
    vis = visible_t[contents]
    opaque_flc = opaque_t[contents].all(-1) & ~(emission_t[contents] != 0).any(-1)

    # covered[x,y,z]: any opaque-for-light cube strictly above (higher y).
    above = np.flip(np.cumsum(np.flip(opaque_flc, 1), axis=1), 1)
    covered = (above - opaque_flc) > 0

    # adjacent-visible in 6 directions (OOB neighbors are not visible).
    adj = np.zeros_like(vis)
    for a in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[a] = slice(None, -1)
        hi[a] = slice(1, None)
        adj[tuple(lo)] |= vis[tuple(hi)]
        adj[tuple(hi)] |= vis[tuple(lo)]

    queued = ~opaque_flc & (vis | adj)

    sky_py = np.concatenate(
        [
            lightpack.np_encode_scalar(state.sky_faces.cpu().numpy()[faces.PY]),
            [lightpack.STATUS_VISIBLE],
        ]
    ).astype(np.uint8)

    light = np.zeros(contents.shape + (4,), np.uint8)
    light[..., 3] = lightpack.STATUS_NO_RAYS
    light[opaque_flc] = (0, 0, 0, lightpack.STATUS_OPAQUE)
    light[queued & covered] = (0, 0, 0, lightpack.STATUS_UNINITIALIZED)
    light[queued & ~covered] = sky_py

    prio = np.where(queued, PRIORITY_ESTIMATED, 0).astype(np.uint8)
    state = dataclasses.replace(state, light=torch.as_tensor(light, device=state.device))
    return state, prio


def _deps_scatter(state: SpaceState, cubes: torch.Tensor, prios: torch.Tensor) -> torch.Tensor:
    """Scatter each batch cube's requeue priority onto its ray-walk
    dependencies (`aic_tpu` refproc.py:121): u8[X,Y,Z] of the largest
    priority each cube receives, on the state's device.

    Replays `relight_batch`'s masked chart walk (its branches depend on
    the contents alone, not on the light) and marks the cubes whose stored
    light the walk reads: the cube behind a struck face (updater.rs:827)
    and a passed-through cube (updater.rs:874). Reads outside the bounds
    are dropped (updater.rs:109-113). Plain PyTorch, as `aic_tpu`'s is
    XLA: every (cube, ray, step) at once, but for the alpha each ray
    carries, multiplied step by step (no read-back), so that a ray ends
    exactly where `aic_tpu`'s step loop ends it."""
    from .update import _chart_device

    dev = cubes.device
    cubes = cubes.to(torch.int64)
    ch = _chart_device(state.light_max_distance, dev)
    t = state.tables
    size = tuple(state.contents.shape)
    size_v = torch.as_tensor(size, dtype=torch.int64, device=dev)
    b, n_rays = cubes.shape[0], ch["n_rays"]
    normals = torch.as_tensor(faces.FACE_NORMALS, dtype=torch.int64, device=dev)

    idx0, _ = lookup_contents(state, cubes)
    idx0 = idx0.long()
    origin_opaque = t.opaque_faces[idx0].all(-1)
    origin_visible = t.visible[idx0]
    nidx, _ = lookup_contents(state, cubes[:, None, :] + normals[None, :6])
    nidx = nidx.long()
    n_visible = t.visible[nidx]
    n_emissive = (t.light_emission[nidx] != 0).any(-1)
    opp = torch.as_tensor(faces.OPPOSITE[:6], dtype=torch.long, device=dev)
    dir_weights = (origin_visible[:, None] | n_visible[:, opp] | n_emissive).to(torch.float32)
    ray_w = dir_weights @ ch["cosines"].T  # [B,R]

    mean_alpha = t.face_colors[idx0, 6, 3].clamp(0.0, 1.0)
    root_pickup = origin_visible & ~origin_opaque & (mean_alpha < 1.0)
    alpha0 = torch.where(root_pickup, 1.0 - mean_alpha, torch.ones_like(mean_alpha))
    # Opaque origins never walk (compute_light:370-383).
    alpha = torch.where(origin_opaque[:, None], 0.0, alpha0[:, None].expand(b, n_rays))
    live = (ray_w > 0.0) & (alpha > 0.0)
    prio = prios.to(torch.uint8)[:, None, None].expand(b, n_rays, ch["max_steps"])

    # Every step of every ray at once, as if the ray were still walking:
    # what it meets depends on the contents alone.
    pos = cubes[:, None, None, :] + ch["offsets"][None]  # [B,R,S,3]
    f_in = ch["faces_in"][None].expand(b, -1, -1)
    idx, inside = lookup_contents(state, pos)
    row = idx.long() * 6 + f_in
    hit_alpha = t.light_face_rows[row, 3].clamp(0.0, 1.0)
    flags = t.light_face_rows[row, 4]
    opaque_f = torch.fmod(flags, 2.0) >= 1.0  # flags are 0-3: fmod is remainder
    pad = (ch["kinds"] == STEP_PAD)[None]
    exits = ~pad & ((ch["kinds"] == STEP_END)[None] | ~inside)
    interacting = ~pad & ~exits & (flags >= 2.0)
    struck = interacting & (hit_alpha > 0.0)
    hit_opaque = struck & opaque_f
    through = interacting & (hit_alpha < 1.0) & ~hit_opaque

    # The ray's alpha after each step, multiplied in the walk's order
    # (struck, then through), so that it reaches 0 where the walk's does.
    one = torch.ones_like(hit_alpha)
    a_struck = torch.where(struck & ~hit_opaque, 1.0 - hit_alpha, one)
    a_through = torch.where(through, 1.0 - hit_alpha, one)
    spent = torch.empty_like(struck)
    for s in range(ch["max_steps"]):
        alpha = alpha * a_struck[..., s] * a_through[..., s]
        spent[..., s] = alpha <= 0.0
    ends = (~pad & (exits | hit_opaque | spent)).to(torch.int32)
    # Walking at a step: live at the start and ended at no earlier step.
    walking = live[..., None] & ((torch.cumsum(ends, -1) - ends) == 0)

    deps = torch.zeros(int(np.prod(size)), dtype=torch.uint8, device=dev)
    for at, mask in ((pos + normals[f_in], struck & walking), (pos, through & walking)):
        ok = ((at >= 0) & (at < size_v)).all(-1) & mask
        pc = torch.minimum(at.clamp(min=0), size_v - 1)
        flat = (pc[..., 0] * size[1] + pc[..., 1]) * size[2] + pc[..., 2]
        deps.scatter_reduce_(0, flat.reshape(-1), torch.where(ok, prio, 0).reshape(-1), "amax")
    return deps.reshape(size)


def _difference_priority_ref(old: np.ndarray, new: np.ndarray) -> np.ndarray:
    """data.rs:193 exactly: max abs component diff; +63 (saturating) when
    the status differs."""
    old = old.astype(np.int32)
    new = new.astype(np.int32)
    diff = np.abs(old[..., :3] - new[..., :3]).max(-1)
    return np.where(old[..., 3] != new[..., 3], np.minimum(diff + 63, 255), diff)


def evaluate_light_reference(state: SpaceState, max_rounds: int = 10000) -> SpaceState:
    """``fast_evaluate_light(); evaluate_light(1)`` as the reference's
    golden generation runs it (`aic_tpu` refproc.py:240). Returns the lit
    state, on the state's device.

    A round's batch: every cube at the current maximum priority, up to
    `_CHUNK` of them drawn by `np.random.default_rng(0)`; their new light
    comes from the same pre-round field. The reference pops a priority in
    arbitrary hash order, so any order is a member of the same family of
    stalled fields."""
    from .update import relight_batch

    dev = state.device
    state, prio = fast_evaluate_seed(state)
    contents = state.contents.cpu().numpy()
    fully_opaque = state.tables.opaque_faces.cpu().numpy()[contents].all(-1)  # guess-fill gate

    light = state.light.cpu().numpy().copy()
    normals = np.asarray(faces.FACE_NORMALS)
    size = contents.shape

    rng = np.random.default_rng(0)  # stands in for the hash-order pops
    for _round in range(max_rounds):
        p = prio.max()
        if p <= 1:
            break
        # Pop up to _CHUNK cubes at the current max priority (re-derived
        # every round: requeues may raise the max mid-drain).
        bucket = np.argwhere(prio == p)
        if len(bucket) > _CHUNK:
            bucket = bucket[rng.choice(len(bucket), _CHUNK, replace=False)]
        bn = len(bucket)
        cubes_pad = np.zeros((_ROWS, 3), np.int32)
        cubes_pad[:bn] = bucket
        cubes = torch.as_tensor(cubes_pad, device=dev)
        valid = torch.arange(_ROWS, device=dev) < bn
        state = dataclasses.replace(state, light=torch.as_tensor(light, device=dev))
        new = relight_batch(state, cubes, valid).cpu().numpy()[:bn]
        old = light[bucket[:, 0], bucket[:, 1], bucket[:, 2]]
        diff = _difference_priority_ref(old, new)

        # Pop the chunk, then apply any nonzero difference.
        prio[bucket[:, 0], bucket[:, 1], bucket[:, 2]] = 0
        changed = diff > 0
        ch_cubes = bucket[changed]
        light[ch_cubes[:, 0], ch_cubes[:, 1], ch_cubes[:, 2]] = new[changed]

        # Guess-fill uninitialized, not-fully-opaque neighbours of changed
        # cubes with the changed cube's rgb (updater.rs:307), face by face.
        for f in range(6):
            npos = ch_cubes + normals[f]
            ok = ((npos >= 0) & (npos < size)).all(-1)
            npos_ok = npos[ok]
            src = new[changed][ok]
            if not len(npos_ok):
                continue
            tgt = light[npos_ok[:, 0], npos_ok[:, 1], npos_ok[:, 2]]
            fill = (tgt[:, 3] == lightpack.STATUS_UNINITIALIZED) & ~fully_opaque[
                npos_ok[:, 0], npos_ok[:, 1], npos_ok[:, 2]]
            guess = src.copy()
            guess[:, 3] = lightpack.STATUS_UNINITIALIZED
            tgt[fill] = guess[fill]
            light[npos_ok[:, 0], npos_ok[:, 1], npos_ok[:, 2]] = tgt

        # Re-enqueue the dependencies of cubes whose difference exceeds 1
        # at Priority::from_difference = d/2 + 1 (queue.rs:47).
        requeue = diff > 1
        if requeue.any():
            rq = np.zeros(_ROWS, np.uint8)
            rq[:bn] = np.where(requeue, diff // 2 + 1, 0)
            dep_prio = _deps_scatter(state, cubes, torch.as_tensor(rq, device=dev)).cpu().numpy()
            prio = np.maximum(prio, dep_prio)

    return dataclasses.replace(state, light=torch.as_tensor(light, device=dev))
