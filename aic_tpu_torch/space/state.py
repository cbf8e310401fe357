"""Device-resident Space state (layer 1) as torch tensors.

Port of `aic_tpu/space/state.py`: frozen dataclasses of tensors with a
`.to(device)` method take the place of the JAX package's registered
pytrees. Layouts are the JAX package's, with one dtype rule forced by
CPU torch (no `>>`, `>=`, gather or `min` for uint32, no `max` for
uint16): `contents` is int32 where `aic_tpu` holds uint16.

`cells` holds the packed outer cells as 4³ brick rows (`raytrace/
accel.py`), built by the snapshot as `aic_tpu` builds them
(`space.py:338-415`): the v1 trace path classifies its hits through
them; the megakernel path reads its classify pages instead.

`state_from_numpy` / `state_to_numpy` convert to and from the numpy
arrays of an `aic_tpu` `SpaceState`, so tests can feed one state to both
packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

#: BlockTables field → dtype in the port.
TABLE_DTYPES = {
    "resolution": torch.int32,
    "visible": torch.bool,
    "opaque_faces": torch.bool,
    "face_colors": torch.float32,
    "light_emission": torch.float32,
    "collision_uniform": torch.int32,
    "collision_res": torch.int32,
    "voxel_index": torch.int32,
    "res_log2": torch.int32,
    "light_face_rows": torch.float32,
    "palette_rows": torch.float32,
    "vox_rows": torch.float32,
    "vox_solid": torch.bool,
}

#: SpaceState tensor field → dtype in the port.
STATE_DTYPES = {
    "contents": torch.int32,
    "light": torch.uint8,
    "light_dirty": torch.uint8,
    "cells": torch.int32,
    "sky_faces": torch.float32,
    "sky_octants": torch.float32,
    "sky_mean": torch.float32,
}


def _to(obj, device):
    changes = {
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
    }
    return dataclasses.replace(obj, **changes)


@dataclass(frozen=True)
class BlockTables:
    """Palette-derived per-block data (host block eval output).

    P = padded palette size, V = padded voxel-entry count, R = padded
    voxel resolution. Rows beyond the live palette are air-like."""

    resolution: torch.Tensor  # i32[P]   (1 for atoms)
    visible: torch.Tensor  # bool[P]  visible_or_animated
    opaque_faces: torch.Tensor  # bool[P,6]
    face_colors: torch.Tensor  # f32[P,7,4] faces 0..5 + mean color at 6
    light_emission: torch.Tensor  # f32[P,3]
    collision_uniform: torch.Tensor  # i32[P]: -1 non-uniform, else class
    collision_res: torch.Tensor  # i32[P] min(resolution, 32)
    voxel_index: torch.Tensor  # i32[P]: -1 = atom, else row in vox_* tables
    res_log2: torch.Tensor  # i32[P]
    light_face_rows: torch.Tensor  # f32[P*6, 8] face rgba, flags, emission
    palette_rows: torch.Tensor  # f32[P,8]: atom rgba, emission rgb, spare
    vox_rows: torch.Tensor  # f32[V,R,R,R,8]: voxel rgba, emission rgb, spare
    vox_solid: torch.Tensor  # bool[V,Rc,Rc,Rc]

    @property
    def padded_voxel_resolution(self) -> int:
        return self.vox_rows.shape[1]

    def to(self, device) -> "BlockTables":
        return _to(self, device)


@dataclass(frozen=True)
class SpaceState:
    """Complete device state of one Space."""

    contents: torch.Tensor  # i32[X,Y,Z] palette indices
    light: torch.Tensor  # u8[X,Y,Z,4] PackedLight texels
    light_dirty: torch.Tensor  # u8[X,Y,Z] relight priority (0 = clean)
    cells: torch.Tensor  # i32[n_bricks, 64] packed cells, space then voxel entries
    tables: BlockTables
    sky_faces: torch.Tensor  # f32[6,3] BlockSky per-face (quantized)
    sky_octants: torch.Tensor  # f32[8,3]
    sky_mean: torch.Tensor  # f32[3] (quantized)
    lower: tuple[int, int, int]
    light_max_distance: int
    light_enabled: bool

    @property
    def device(self) -> torch.device:
        return self.contents.device

    def to(self, device) -> "SpaceState":
        return dataclasses.replace(_to(self, device), tables=self.tables.to(device))


def state_from_numpy(
    fields: dict[str, np.ndarray],
    *,
    lower,
    light_max_distance: int,
    light_enabled: bool,
    device="cuda",
) -> SpaceState:
    """Build a port SpaceState on `device` (the card unless the caller
    asks for the CPU) from the numpy arrays of an `aic_tpu` SpaceState:
    one flat dict holding the state's fields and its tables' fields by
    name."""

    def tensor(name, dtype):
        return torch.as_tensor(np.array(fields[name]), device=device).to(dtype)

    tables = BlockTables(**{k: tensor(k, dt) for k, dt in TABLE_DTYPES.items()})
    return SpaceState(
        tables=tables,
        lower=tuple(int(v) for v in lower),
        light_max_distance=int(light_max_distance),
        light_enabled=bool(light_enabled),
        **{k: tensor(k, dt) for k, dt in STATE_DTYPES.items()},
    )


def state_to_numpy(state: SpaceState) -> tuple[dict[str, np.ndarray], dict]:
    """The reverse of `state_from_numpy`: (flat field dict, static dict).

    `contents` comes back as uint16, the JAX package's dtype."""
    fields = {k: getattr(state, k).cpu().numpy() for k in STATE_DTYPES}
    fields["contents"] = fields["contents"].astype(np.uint16)
    fields.update({k: getattr(state.tables, k).cpu().numpy() for k in TABLE_DTYPES})
    static = dict(
        lower=state.lower,
        light_max_distance=state.light_max_distance,
        light_enabled=state.light_enabled,
    )
    return fields, static
