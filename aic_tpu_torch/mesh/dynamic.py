"""Dynamic chunked scene meshing (reference: all-is-cubes-mesh/src/dynamic/).

Port of `aic_tpu/mesh/dynamic.py` (host numpy, unchanged). The device
tick's palette remap (`Universe._apply_plan_host`) rewrites the host
contents without a journal entry, in both packages, so a chunk it
changed is re-meshed only when something else dirties it.

`ChunkedSpaceMesh` maintains per-16³-chunk meshes of a Space, dirty-
tracked through the space's edit journal (`Space.drain_edits`, the
SpaceChange-listener analog — chunked_mesh.rs:856
CsmTodo::modify_block_and_adjacent) and updated near-to-far from the view
position under a per-call chunk budget (chunked_mesh.rs:218-595's
Deadline, re-expressed as a fixed count per SURVEY §2.9). Meshing itself
is host work feeding export/rasterization; the raytracer renders straight
from device state.

The reference's `MeshJobQueue` (dynamic/job.rs) offloads chunk meshing to
worker threads; `update(jobs=n)` accepts a `concurrent.futures` executor
for the same purpose (host threads are free while the card renders).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..math import chunking
from .mesher import SpaceMesh, _mesh_arrays, visible_faces

CHUNK_SIZE = 16  # gpu/src/space.rs:46 CHUNK_SIZE


@dataclasses.dataclass
class CsmUpdateInfo:
    """chunked_mesh.rs:704 CsmUpdateInfo."""

    chunks_updated: int = 0
    chunks_remaining: int = 0
    triangles: int = 0


class ChunkedSpaceMesh:
    """Per-chunk meshes with dirty tracking + near-to-far budgeted update."""

    def __init__(self, space, chunk_size: int = CHUNK_SIZE):
        self.space = space
        self.chunk_size = chunk_size
        size = space.bounds.size
        self.grid = tuple(
            (s + chunk_size - 1) // chunk_size for s in size
        )  # chunks per axis
        self.meshes: dict[tuple[int, int, int], SpaceMesh] = {}
        self.dirty: set[tuple[int, int, int]] = {
            (x, y, z)
            for x in range(self.grid[0])
            for y in range(self.grid[1])
            for z in range(self.grid[2])
        }
        space.drain_edits()  # we start fully dirty; clear the journal

    def chunks_of_cube(self, rel) -> set:
        """The chunks an edit of a cube dirties: its own and any chunk
        sharing a face with the cube (edits at chunk borders change
        neighbor culling — CsmTodo::modify_block_and_adjacent)."""
        cs = self.chunk_size
        chunks = set()
        for d in ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)):
            c = tuple((rel[a] + d[a]) // cs for a in range(3))
            if all(0 <= c[a] < self.grid[a] for a in range(3)):
                chunks.add(c)
        return chunks

    def absorb_edits(self):
        """Pull the space's edit journal into chunk dirty flags."""
        edits = self.space.drain_edits()
        if edits == "all":
            self.dirty = {
                (x, y, z)
                for x in range(self.grid[0])
                for y in range(self.grid[1])
                for z in range(self.grid[2])
            }
            return
        for rel in edits:
            self.dirty |= self.chunks_of_cube(rel)

    def _mesh_chunk(self, chunk, vis, face_colors):
        cs = self.chunk_size
        lo = [chunk[a] * cs for a in range(3)]
        hi = [min(lo[a] + cs, self.space.bounds.size[a]) for a in range(3)]
        sl = tuple(slice(lo[a], hi[a]) for a in range(3))
        sub_contents = self.space.contents[sl]
        sub_vis = vis[(slice(None),) + sl]
        lower = np.asarray(self.space.bounds.lower, np.float32) + np.asarray(
            lo, np.float32
        )
        return _mesh_arrays(sub_contents, sub_vis, face_colors, lower)

    def update(
        self,
        view_position,
        budget_chunks: int = 8,
        executor: Optional[object] = None,
    ) -> CsmUpdateInfo:
        """Re-mesh up to `budget_chunks` dirty chunks, nearest first
        (ChunkChart near-to-far order, chunked_mesh.rs:376-388)."""
        self.absorb_edits()
        if not self.dirty:
            return CsmUpdateInfo(0, 0, self._triangles())

        rel_view = np.asarray(view_position, np.float64) - np.asarray(
            self.space.bounds.lower, np.float64
        )
        view_chunk = np.asarray(
            chunking.point_to_chunk(rel_view, self.chunk_size), np.int64
        )

        def dist(c):
            # ChunkChart's Distance order (chunking.rs:434 depth_sort_key):
            # nearest-approach², then off-plane count, then coordinates.
            off = np.asarray(c, np.int64) - view_chunk
            nearest_sq, off_plane = chunking.chunk_distance_squared_for_view(off)
            return (int(nearest_sq), int(off_plane), tuple(off))

        order = sorted(self.dirty, key=dist)[:budget_chunks]
        # Face visibility computed once per update (vectorized whole-space
        # pass; cheap relative to quad emission).
        vis = visible_faces(self.space)
        face_colors = np.stack(
            [
                self.space.evaluated(i).face_colors
                for i in range(self.space.palette_len())
            ]
        )
        if executor is not None:
            futures = {
                c: executor.submit(self._mesh_chunk, c, vis, face_colors)
                for c in order
            }
            for c, fut in futures.items():
                self.meshes[c] = fut.result()
                self.dirty.discard(c)
        else:
            for c in order:
                self.meshes[c] = self._mesh_chunk(c, vis, face_colors)
                self.dirty.discard(c)
        return CsmUpdateInfo(
            chunks_updated=len(order),
            chunks_remaining=len(self.dirty),
            triangles=self._triangles(),
        )

    def _triangles(self) -> int:
        return sum(m.triangle_count for m in self.meshes.values())

    def depth_sort_for_view(self, view_position):
        for m in self.meshes.values():
            m.depth_sort_for_view(view_position)

    def combined(self) -> SpaceMesh:
        """Concatenate all chunk meshes (export path)."""
        parts = [m for m in self.meshes.values() if not m.is_empty()]
        if not parts:
            return SpaceMesh(
                positions=np.zeros((0, 3), np.float32),
                colors=np.zeros((0, 4), np.float32),
                indices=np.zeros((0,), np.uint32),
            )
        positions, colors, indices = [], [], []
        v_off = 0
        per_chunk_off = {}
        for m in parts:
            per_chunk_off[id(m)] = v_off
            positions.append(m.positions)
            colors.append(m.colors)
            v_off += len(m.positions)
        cursor = 0
        ranges = {}
        for opaque in (True, False):
            start = cursor
            for m in parts:
                lo, hi = m.opaque_range if opaque else m.transparent_range
                if hi <= lo:
                    continue
                indices.append(m.indices[lo:hi].astype(np.uint32) + per_chunk_off[id(m)])
                cursor += hi - lo
            ranges[opaque] = (start, cursor)
        return SpaceMesh(
            positions=np.concatenate(positions),
            colors=np.concatenate(colors),
            indices=np.concatenate(indices) if indices else np.zeros((0,), np.uint32),
            opaque_range=ranges[True],
            transparent_range=ranges[False],
        )
