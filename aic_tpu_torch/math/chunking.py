"""ChunkChart: distance-sorted chunk iteration for view-distance worlds.

Copied unchanged from `aic_tpu/math/chunking.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

The reference precomputes one octant of chunk offsets sorted by a
nearest-approach distance metric and mirrors it on demand per octant
(all-is-cubes/src/chunking.rs:179 `ChunkChart`, :404 `compute_chart_octant`,
:465 `AxisMirrorIter`). Every big-world feature hangs off this order:
near-to-far mesh updates, far-to-near transparency, draw culling.

TPU/numpy re-design: instead of a lazy iterator, the chart *materializes*
the full mirrored, masked, distance-sorted offset list as one `[N, 3]`
int32 array (`ChunkChart.chunks()`). Callers vectorize over it (gather
chunk states, slice prefixes for budgets) rather than looping; the
per-view-distance octant array is cached, and the octant expansion is
table math on the :mod:`~aic_tpu.math.octant` sign tables rather than a
per-vector mirror iterator.

Distance semantics match chunking.rs exactly:

- a chunk is included iff ``(max(|c|−1, 0))² < ⌈(view_distance/size)²⌉``
  — the Minkowski sum of the view sphere with the origin chunk
  (chunking.rs:420-428 `compute_chart_octant`, strict ``<``);
- sort key is ``(nearest_approach_squared, off_plane_count, x, y, z)``
  (chunking.rs:434-463 `depth_sort_key` / `Distance`), so coordinate-
  plane chunks count as nearer than off-plane ones at equal approach
  distance and the order is deterministic;
- mirroring skips duplicate images on zero coordinates via
  `mask_collapse_to_negative` and an octant mask culls chunks invisible
  in the view direction (chunking.rs:296-307, :465-509).
"""

from __future__ import annotations

import functools

import numpy as np

from . import octant as oct

#: Chunk edge length used by the mesh/render subsystems (the GPU
#: renderer's `ChunkSize16`, all-is-cubes-gpu/src/space.rs:46).
CHUNK_SIZE = 16


def cube_to_chunk(cube, chunk_size: int = CHUNK_SIZE):
    """Chunk position containing `cube` (chunking.rs:111), floor division."""
    return tuple(int(v) for v in np.floor_divide(np.asarray(cube), chunk_size))


def point_to_chunk(point, chunk_size: int = CHUNK_SIZE):
    """Chunk position containing the free `point` (chunking.rs:124)."""
    return tuple(
        int(v)
        for v in np.floor_divide(
            np.floor(np.asarray(point, np.float64)).astype(np.int64), chunk_size
        )
    )


def chunk_distance_squared_for_view(offsets: np.ndarray):
    """(nearest_approach_squared, off_plane_count) per offset row
    (chunking.rs:445 `chunk_distance_squared_for_view`, on |offsets|)."""
    a = np.abs(np.asarray(offsets, np.int64))
    nearest_sq = (np.maximum(a - 1, 0) ** 2).sum(-1)
    off_plane = (a > 0).sum(-1)
    return nearest_sq, off_plane


@functools.lru_cache(maxsize=32)
def _octant_chunks(view_distance_sq_chunks: int) -> np.ndarray:
    """One sorted octant of chunk offsets: i32[K,3], coordinates ≥ 0."""
    r = int(view_distance_sq_chunks) + 1
    g = np.arange(r, dtype=np.int64)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    c = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    nearest_sq, off_plane = chunk_distance_squared_for_view(c)
    keep = nearest_sq < view_distance_sq_chunks
    c, nearest_sq, off_plane = c[keep], nearest_sq[keep], off_plane[keep]
    order = np.lexsort((c[:, 2], c[:, 1], c[:, 0], off_plane, nearest_sq))
    return c[order].astype(np.int32)


def _sanitize_and_square(view_distance: float, chunk_size: int) -> int:
    """chunking.rs:240 `sanitize_and_square_distance`."""
    vd = float(view_distance)
    vd = max(vd, 0.0) if np.isfinite(vd) else 0.0
    vd /= float(chunk_size)
    return int(np.ceil(vd * vd))


@functools.lru_cache(maxsize=64)
def _expanded(view_distance_sq_chunks: int, mask: int) -> np.ndarray:
    """Mirror the sorted octant into all `mask` octants, preserving the
    near-to-far order, skipping duplicate images on zero coordinates."""
    oc = _octant_chunks(view_distance_sq_chunks)
    zero = oc == 0  # [K,3]
    signs = oct.OCTANT_SIGNS.astype(np.int32)  # [8,3]
    # An octant o is emitted for chunk k iff o is in the mask after
    # collapsing k's zero axes (AxisMirrorIter::new).
    emit = np.zeros((len(oc), 8), bool)
    for zp in range(8):  # zero-pattern, bits like octant bits (x=4,y=2,z=1)
        rows = (
            (zero[:, 0] == bool(zp & 4))
            & (zero[:, 1] == bool(zp & 2))
            & (zero[:, 2] == bool(zp & 1))
        )
        if not rows.any():
            continue
        m = oct.mask_collapse_to_negative(
            mask, bool(zp & 4), bool(zp & 2), bool(zp & 1)
        )
        for o in oct.mask_octants(m):
            emit[rows, o] = True
    mirrored = oc[:, None, :] * signs[None, :, :]  # [K,8,3]
    # Row-major selection = chunk-major, octant-minor: the same nesting
    # as flat_map(AxisMirrorIter) with first() = ascending octant index.
    return np.ascontiguousarray(mirrored[emit], np.int32)


class ChunkChart:
    """chunking.rs:179 `ChunkChart` for a given chunk size."""

    def __init__(self, view_distance: float, chunk_size: int = CHUNK_SIZE):
        self.chunk_size = int(chunk_size)
        self.view_distance_in_squared_chunks = _sanitize_and_square(
            view_distance, chunk_size
        )

    def resize_if_needed(self, view_distance: float) -> None:
        self.view_distance_in_squared_chunks = _sanitize_and_square(
            view_distance, self.chunk_size
        )

    def chunks(self, origin=None, mask: int = oct.ALL_MASK) -> np.ndarray:
        """All chunk positions in view, nearest-first: i32[N,3].

        `origin`: chunk position of the viewpoint (chunk coords), added
        to every offset; `mask`: octant visibility mask, e.g. from
        :func:`~aic_tpu.math.octant.view_direction_mask`
        (chunking.rs:296 `chunks()`).
        """
        offsets = _expanded(self.view_distance_in_squared_chunks, int(mask))
        if origin is None:
            return offsets
        return offsets + np.asarray(origin, np.int32)

    def count_all(self) -> int:
        return len(_expanded(self.view_distance_in_squared_chunks, oct.ALL_MASK))


# --- compat helpers (older callers) ------------------------------------------


def chunk_chart(view_distance_chunks: float) -> np.ndarray:
    """Offsets i32[N,3] within `view_distance_chunks` (chunk units),
    near-to-far. Thin wrapper over :class:`ChunkChart` with chunk_size 1."""
    return ChunkChart(float(view_distance_chunks), chunk_size=1).chunks()


def chunks_near(center_chunk, view_distance_cubes: float, chunk_size: int = CHUNK_SIZE):
    """Iterate chunk positions near→far around `center_chunk`
    (chunking.rs:298 `chunks()`)."""
    chart = ChunkChart(float(view_distance_cubes), chunk_size=chunk_size)
    for row in chart.chunks(origin=np.asarray(center_chunk, np.int32)):
        yield tuple(int(v) for v in row)
