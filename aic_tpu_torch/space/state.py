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

The device lookups and the device half of a transaction commit
(`in_bounds_mask`, `lookup_contents`, `lookup_light`,
`scatter_set_cubes`) are `aic_tpu/space/state.py:113-190` on tensors on
the state's device; `visible_light_volume` and `window_state` (:193-267)
cut a large state down to the camera's view before it is rendered.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import profiling

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

    @property
    def padded_palette_size(self) -> int:
        return self.resolution.shape[0]

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

    @property
    def size(self) -> tuple[int, int, int]:
        return tuple(self.contents.shape)

    def cube_to_index(self, cubes: torch.Tensor) -> torch.Tensor:
        """World cube coords (..., 3) → array indices (..., 3)."""
        return cubes - torch.as_tensor(self.lower, dtype=cubes.dtype, device=cubes.device)

    def to(self, device) -> "SpaceState":
        return dataclasses.replace(_to(self, device), tables=self.tables.to(device))


def in_bounds_mask(state: SpaceState, idx: torch.Tensor) -> torch.Tensor:
    """Mask of index-space positions (..., 3) inside the contents array,
    compared with the shape's Python ints: nothing goes to the card."""
    X, Y, Z = state.contents.shape
    return (idx >= 0).all(-1) & (idx[..., 0] < X) & (idx[..., 1] < Y) & (idx[..., 2] < Z)


def _flat_index(shape, idx: torch.Tensor) -> torch.Tensor:
    """Flat i64 index of positions (..., 3), clamped into `shape`."""
    X, Y, Z = shape
    x = idx[..., 0].clamp(0, X - 1).long()
    y = idx[..., 1].clamp(0, Y - 1).long()
    z = idx[..., 2].clamp(0, Z - 1).long()
    return (x * Y + y) * Z + z


def lookup_contents(state: SpaceState, idx: torch.Tensor):
    """Palette indices at index-space positions (..., 3), and the in-bounds
    mask; out-of-bounds positions read 0 (air)."""
    mask = in_bounds_mask(state, idx)
    vals = state.contents.reshape(-1)[_flat_index(state.contents.shape, idx)]
    return torch.where(mask, vals, 0), mask


def lookup_light(state: SpaceState, idx: torch.Tensor):
    """Light texels at index-space positions (..., 3) → (u8[..., 4],
    in-bounds mask). Callers substitute the sky outside the bounds."""
    mask = in_bounds_mask(state, idx)
    vals = state.light.reshape(-1, 4)[_flat_index(state.contents.shape, idx)]
    return vals, mask


def scatter_set_cubes(state: SpaceState, idx: torch.Tensor, new_indices: torch.Tensor) -> SpaceState:
    """contents[idx] = new_indices, as a new state: the device half of a
    `SpaceTransaction` commit. Positions are index-space i32[N, 3] whose
    preconditions the caller has checked; positions outside the bounds are
    dropped. The cubes and their 6 neighbours are marked light-dirty
    (255), and the packed cells (skip field included) are rebuilt from
    the new contents on the state's device."""
    from ..math.faces import FACE7_NORMALS

    dev = state.contents.device
    idx = idx.to(device=dev, dtype=torch.int64)
    shape = state.contents.shape
    n = state.contents.numel()
    inside = in_bounds_mask(state, idx)
    # Rows outside the bounds write into one spare element past the end.
    flat = torch.where(inside, _flat_index(shape, idx), n)
    contents = torch.cat([state.contents.reshape(-1), state.contents.new_zeros(1)])
    contents[flat] = new_indices.to(device=dev, dtype=contents.dtype)
    contents = contents[:n].reshape(shape)

    with profiling.wait("space.mark_offsets"):
        offsets = torch.as_tensor(FACE7_NORMALS, dtype=torch.int64, device=dev)
    nb = (idx[:, None, :] + offsets).reshape(-1, 3)
    dirty = torch.cat([state.light_dirty.reshape(-1), state.light_dirty.new_zeros(1)])
    marked = torch.where(in_bounds_mask(state, nb), _flat_index(shape, nb), n)
    with profiling.wait("space.mark_dirty"):  # the 255 goes to the card as a blocking copy
        dirty[marked] = 255
    dirty = dirty[:n].reshape(shape)
    with profiling.span("txn.cells"):
        cells = _cells_for(state, contents)
    return dataclasses.replace(state, contents=contents, light_dirty=dirty, cells=cells)


def _cells_for(state: SpaceState, contents: torch.Tensor, tables: BlockTables | None = None) -> torch.Tensor:
    """Packed cells for `contents` under the state's palette (`tables`, the
    state's on `contents`' device), on that device: the space bricks built
    anew (skip field included), the voxel entries' brick rows of
    `state.cells` kept."""
    from ..raytrace.accel import brick_dims, build_trace_cells, cell_payload, to_bricks

    t = state.tables if tables is None else tables
    space_cells = build_trace_cells(contents, t.visible, t.voxel_index >= 0, t.res_log2,
                                    payload=cell_payload(t.voxel_index))
    n_sb = int(np.prod(brick_dims(state.contents.shape)))
    return torch.cat([to_bricks(space_cells), state.cells[n_sb:].to(contents.device)], dim=0)


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


def visible_light_volume(state: SpaceState, view_position, view_distance: float):
    """World-coordinate window for which rendering needs data: the view
    sphere's bounding box (plus a chunk-diagonal margin) intersected with
    the space bounds (gpu/src/light_texture.rs:39 visible_light_volume).

    Returns (lower, upper) world coords, always a non-empty box clipped
    to the state's bounds."""
    margin = 16.0 * 1.75  # CAMERA_MARGIN_RADIUS (light_texture.rs:34)
    p = np.asarray(view_position, np.float64)
    r = float(view_distance) + margin
    lo = np.floor(p - r).astype(np.int64)
    hi = np.ceil(p + r).astype(np.int64)
    s_lo = np.asarray(state.lower, np.int64)
    s_hi = s_lo + np.asarray(state.contents.shape, np.int64)
    lo = np.clip(lo, s_lo, s_hi - 1)
    hi = np.clip(hi, lo + 1, s_hi)
    return tuple(int(v) for v in lo), tuple(int(v) for v in hi)


def window_state(state: SpaceState, lower, upper, device=None) -> SpaceState:
    """The state cut to the world-coordinate window [lower, upper), on
    `device` (the state's own by default; only the window and the tables
    are copied there) (the big-world analog of the reference's windowed
    light texture, gpu/src/light_texture.rs:139-239). Contents and light
    are sliced; the packed cells' space-brick section is rebuilt for the
    window by `build_trace_cells` on tensors (the skip field must not see
    visibility outside it), and the voxel entries' brick rows are shared
    unchanged. Rays that leave the window see the sky."""
    lo_w = np.asarray(lower, np.int64)
    hi_w = np.asarray(upper, np.int64)
    s_lo = np.asarray(state.lower, np.int64)
    rel_lo, rel_hi = lo_w - s_lo, hi_w - s_lo
    size = np.asarray(state.contents.shape, np.int64)
    if (rel_lo < 0).any() or (rel_hi > size).any() or (rel_hi <= rel_lo).any():
        raise ValueError(f"window {lower}..{upper} outside state bounds")
    sl = tuple(slice(int(a), int(b)) for a, b in zip(rel_lo, rel_hi))

    dev = state.device if device is None else torch.device(device)
    contents = state.contents[sl].to(dev).contiguous()
    tables = state.tables if dev == state.device else state.tables.to(dev)
    return dataclasses.replace(
        state,
        contents=contents,
        light=state.light[sl].to(dev).contiguous(),
        light_dirty=state.light_dirty[sl].to(dev).contiguous(),
        cells=_cells_for(state, contents, tables),
        tables=tables,
        sky_faces=state.sky_faces.to(dev),
        sky_octants=state.sky_octants.to(dev),
        sky_mean=state.sky_mean.to(dev),
        lower=tuple(int(v) for v in lo_w),
    )
