"""The reference's fast light seed (port of `aic_tpu/light/refproc.py`).

Only `fast_evaluate_seed` is ported: the seed `evaluate_light_dense`
starts from. The queue-emulating `evaluate_light_reference` comes with
the step loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..math import faces, lightpack
from ..space.state import SpaceState

#: Queue priorities (queue.rs:25-45).
PRIORITY_ESTIMATED = 200


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
