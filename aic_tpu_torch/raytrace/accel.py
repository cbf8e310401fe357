"""Packed outer cells and the skip-distance field.

Port of `aic_tpu/raytrace/accel.py` (the port carries its own copy: that
package's imports pull in JAX). The snapshot packs one i32 per cube on
the host (numpy) and stores the cells as 4³ brick rows; the v1 trace
path (`trace_kernel_v1`) classifies each hit cube through them. A
transaction commit or a device tick rebuilds them from the new contents
on the state's device: `pack_cells`, `to_bricks`, `cell_payload` and
`build_trace_cells` take numpy arrays or tensors, as `aic_tpu`'s take
numpy or JAX arrays, and `skip_distance_field` is the tensor twin of
`np_skip_distance_field`. Both halves give the same bits.

Packed cell layout (i32):
  bits  0..15  payload: palette index for atoms, voxel-table row for
               voxel blocks
  bit   16     visible (block contributes to rendering)
  bit   17     is_voxel (resolution > 1 → descend into the voxel grid)
  bits 18..23  skip distance D (0..63): all cubes at chebyshev distance
               < D are invisible (D = 0 on visible cubes)
  bits 24..26  log2(resolution)

Voxel cells (i32[V, R, R, R]) use the same bit 16 / 18..23 scheme.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

VISIBLE_BIT = 1 << 16
VOXEL_BIT = 1 << 17
SKIP_SHIFT = 18
SKIP_MASK = 63
RES_SHIFT = 24
MAX_SKIP = 63



def unpack_cell(cell: torch.Tensor):
    """A packed cell's fields (`aic_tpu` accel.py:37): (palette or voxel
    index, visible, voxel block, skip distance, log2 of the resolution)."""
    idx = cell & 0xFFFF
    visible = (cell & VISIBLE_BIT) != 0
    is_voxel = (cell & VOXEL_BIT) != 0
    skip = (cell >> SKIP_SHIFT) & SKIP_MASK
    res_log2 = (cell >> RES_SHIFT) & 7
    return idx, visible, is_voxel, skip, res_log2


#: Cells per brick edge; a brick row holds 4³ = 64 cells.
BRICK = 4


def np_skip_distance_field(visible: np.ndarray, cap: int = 15) -> np.ndarray:
    """Chebyshev distance to the nearest visible cube, clamped to `cap`:
    i32, 0 on visible cubes. `cap` passes of a separable 3³ min filter."""
    d = np.where(visible, 0.0, float(cap)).astype(np.float32)
    for _ in range(cap):
        m = d
        for axis in range(3):
            p = np.pad(m, [(1, 1) if a == axis else (0, 0) for a in range(3)],
                       constant_values=np.inf)
            sls = lambda s: tuple(  # noqa: E731
                slice(s, s + d.shape[a]) if a == axis else slice(None) for a in range(3)
            )
            m = np.minimum(np.minimum(p[sls(0)], p[sls(1)]), p[sls(2)])
        d = np.minimum(d, m + 1.0)
    return d.astype(np.int32)


def skip_distance_field(visible: torch.Tensor, cap: int = 15) -> torch.Tensor:
    """`np_skip_distance_field` on a bool tensor, on its device: each
    pass's 3³ min filter (+inf outside) is a max pool of the negated
    field, which takes the same minimum over the same values."""
    d = torch.where(visible, 0.0, float(cap)).to(torch.float32)[None, None]
    for _ in range(cap):
        m = -F.max_pool3d(-d, 3, stride=1, padding=1)
        d = torch.minimum(d, m + 1.0)
    return d[0, 0].to(torch.int32)


def pack_cells(contents, palette_visible, palette_voxel, palette_res_log2, skip, payload=None):
    """Assemble packed cells from int[X,Y,Z] palette indices, per-palette
    rows and the skip field. `payload` (per palette entry) goes in the
    low 16 bits; the palette index when it is None. Numpy arrays or
    tensors (all of one kind)."""
    if isinstance(contents, np.ndarray):
        take, i32 = (lambda t: t[contents]), (lambda a: a.astype(np.int32))
    else:
        idx = contents.long()
        take, i32 = (lambda t: t[idx]), (lambda a: a.to(torch.int32))
    low = contents if payload is None else take(payload)
    return (
        i32(low)
        | i32(take(palette_visible)) * VISIBLE_BIT
        | i32(take(palette_voxel)) * VOXEL_BIT
        | (i32(skip) & SKIP_MASK) << SKIP_SHIFT
        | i32(take(palette_res_log2)) << RES_SHIFT
    )


def brick_dims(shape):
    """Number of bricks along each axis for a cell grid `shape`."""
    return tuple((s + BRICK - 1) // BRICK for s in shape)


def to_bricks(cells3d):
    """[X,Y,Z] cells → [n_bricks, 64] brick rows (row-local order
    lx*16 + ly*4 + lz), padded to brick multiples with 0 (air). A numpy
    array or a tensor."""
    bx, by, bz = brick_dims(cells3d.shape)
    if isinstance(cells3d, np.ndarray):
        pads = [(0, b * BRICK - s) for b, s in zip((bx, by, bz), cells3d.shape)]
        p = np.pad(cells3d, pads).reshape(bx, BRICK, by, BRICK, bz, BRICK).transpose(0, 2, 4, 1, 3, 5)
    else:
        p = cells3d.new_zeros((bx * BRICK, by * BRICK, bz * BRICK))
        p[: cells3d.shape[0], : cells3d.shape[1], : cells3d.shape[2]] = cells3d
        p = p.reshape(bx, BRICK, by, BRICK, bz, BRICK).permute(0, 2, 4, 1, 3, 5)
    return p.reshape(bx * by * bz, BRICK**3)


def cell_payload(palette_voxel_index):
    """Low-16-bit cell payload per palette entry: the voxel-table row of a
    voxel block, else the palette index. A numpy array or a tensor."""
    if isinstance(palette_voxel_index, np.ndarray):
        idx = np.arange(palette_voxel_index.shape[0], dtype=np.int32)
        return np.where(palette_voxel_index >= 0, palette_voxel_index, idx)
    idx = torch.arange(palette_voxel_index.shape[0], dtype=torch.int32, device=palette_voxel_index.device)
    return torch.where(palette_voxel_index >= 0, palette_voxel_index, idx)


def build_trace_cells(contents, palette_visible, palette_voxel, palette_res_log2, cap=15, payload=None):
    """Visibility grid → skip field → packed cells, in numpy for numpy
    arrays and on the tensors' device for tensors."""
    if isinstance(contents, np.ndarray):
        skip = np_skip_distance_field(palette_visible[contents], cap)
    else:
        skip = skip_distance_field(palette_visible[contents.long()], cap)
    return pack_cells(contents, palette_visible, palette_voxel, palette_res_log2, skip, payload)
