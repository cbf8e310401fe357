"""The device tick: tick-action palette remaps and the tick's light rounds
on the state's device.

Port of `aic_tpu/universe/device_step.py`. Every `Become` / `DestroyTo`
tick action whose target block is already interned is a palette remap:
contents become remap[contents] where the action fires, which is exact
compare-and-set semantics because contents are palette indices. The
changed cubes and their 6 neighbours mark light-dirty, the packed cells
are rebuilt, and the tick's incremental light rounds run, all as a short
run of tensor operations on the state's device. The stats stay there as
tensors; the step reads nothing back to the host per tick.

`aic_tpu` branches on `lax.cond(edits > 0)`. Here the tick number is a
host integer, so whether an action's schedule fires is known on the host
without a read-back; when one fires, the remap, the dirty marks and the
cell rebuild are applied whatever the cubes hold, since they change
nothing where no cube fires (contents equal, no dirty bump, the same
cells). A host `if` on the edit count would cost a sync each tick.

Actions that are not remaps (Neighbors, StartMove, custom operations,
or a Become whose target is not interned yet) take the host path:
`compile_tick_plan` returns None and `Universe.step` runs the per-cube
loop. A Become chain interns its frames over its first cycle and is a
remap from then on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..light.dense import _shift
from ..light.update import light_update_round, note_queue, queue_known_empty
from ..math import faces
from .op import Become, DestroyTo


@dataclasses.dataclass(frozen=True)
class TickPlan:
    """A space's tick actions as a palette remap.

    `actions` holds (palette index, target index, period) for each entry
    whose action changes it: the remap is that many compare-selects over
    the volume. `remap` and `period` (host numpy, one entry per padded
    palette index) keep the whole plan for the host mirror
    (`Universe._apply_plan_host`)."""

    remap: np.ndarray  # i32[P]: the firing target (i where no action)
    period: np.ndarray  # i32[P]: tick period; 0 = no action
    actions: tuple = ()


def compile_tick_plan(space, padded_palette_size: int) -> TickPlan | None:
    """The space's tick actions as a palette remap, or None when an action
    needs the host path (see the module docstring)."""
    p = padded_palette_size
    if space.palette_len() > p:
        # The host palette outgrew the device tables: the caller must
        # resnapshot before a device plan is valid.
        return None
    remap = np.arange(p, dtype=np.int32)
    period = np.zeros(p, np.int32)
    acts = []
    for i in range(space.palette_len()):
        att = space.evaluated(i).attributes
        op = att.tick_action
        if op is None:
            continue
        if not isinstance(op, (Become, DestroyTo)):
            return None
        tgt = space._block_to_index.get(op.block)
        if tgt is None:
            return None  # target not interned yet: the host path interns it
        per = max(int(getattr(att, "tick_period", 1) or 1), 1)
        remap[i] = tgt
        period[i] = per
        if tgt != i:
            acts.append((int(i), int(tgt), per))
    return TickPlan(remap=remap, period=period if acts else np.zeros(p, np.int32), actions=tuple(acts))


def device_tick(state, plan: TickPlan, tick: int, light_rounds: int, light_batch: int):
    """One space tick on the state's device. Returns (state, stats): the
    cubes the tick actions changed (`edits`), and the light rounds' cubes
    `updated`, `max_diff` of the last round and `queue_remaining`, each a
    tensor on the device. The rounds stop where the queue is known to be
    empty (`queue_known_empty`, read without waiting for the card)."""
    idx = state.contents
    firing = [(i, tgt) for i, tgt, per in plan.actions if tick % per == 0]
    edits = torch.zeros((), dtype=torch.int64, device=idx.device)
    if firing:
        from ..raytrace.accel import brick_dims, build_trace_cells, cell_payload, to_bricks

        newc = idx
        for i, tgt in firing:
            newc = torch.where(idx == i, tgt, newc)
        changed = newc != idx
        edits = changed.sum()
        bump = torch.where(changed, 255, 0).to(torch.uint8)
        dirty = torch.maximum(state.light_dirty, bump)
        for f in range(6):
            dirty = torch.maximum(dirty, _shift(bump, faces.FACE_NORMALS[f]))
        t = state.tables
        space_cells = build_trace_cells(newc, t.visible, t.voxel_index >= 0, t.res_log2,
                                        payload=cell_payload(t.voxel_index))
        n_sb = int(np.prod(brick_dims(idx.shape)))
        cells = torch.cat([to_bricks(space_cells), state.cells[n_sb:]], dim=0)
        state = dataclasses.replace(state, contents=newc, light_dirty=dirty, cells=cells)

    stats = dict(
        updated=torch.zeros((), dtype=torch.int64, device=idx.device),
        max_diff=torch.zeros((), dtype=torch.int32, device=idx.device),
        queue_remaining=(state.light_dirty > 0).sum(),
    )
    total_updated = stats["updated"]
    for _ in range(light_rounds):
        if queue_known_empty(state):
            break
        state, stats = light_update_round(state, batch_size=light_batch)
        note_queue(state, stats["queue_remaining"])
        total_updated = total_updated + stats["updated"]
    stats["updated"] = total_updated
    stats["edits"] = edits
    return state, stats
