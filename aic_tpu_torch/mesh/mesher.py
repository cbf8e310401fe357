"""Triangle-mesh generation: vectorized face culling + quad emission.

Port of `aic_tpu/mesh/mesher.py`, host numpy and native C++ as there
(`aic_tpu_torch/native`, built with g++ at first use); every `greedy` and
`style` argument takes `aic_tpu`'s branch, the native one where
`aic_tpu` has g++. `aic_tpu`'s design notes follow.

TPU-native re-design of the reference's meshing stack
(all-is-cubes-mesh: block_mesh/analyze.rs:159 surface analysis,
space_mesh.rs:199 `SpaceMesh::compute` with interior-face culling,
dynamic/chunked_mesh.rs chunking):

Instead of per-block sweep-line triangulation, visible faces are computed
for the whole Space (or chunk) at once as dense boolean masks — face f of
cube c is visible iff c's block is visible and the neighbor through f does
not have an opaque facing face (space_mesh culling rule). Quads are then
emitted per visible face; `greedy` merging joins coplanar same-block
rectangles.

Documented deviation (SURVEY §7 step 7): the reference deliberately uses
T-junction-free sweep-line triangulation instead of greedy meshing
(planar/mod.rs:34-40). We emit per-face unit quads by default (no
T-junctions either, at higher vertex count) and offer greedy merging as an
opt-in for export compactness.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..math import faces
from ..space.space import Space

# Vertices of a unit quad for each face, counter-clockwise looking at the
# face from outside. Corner order: (u0v0, u1v0, u1v1, u0v1) in the face's
# tangent frame.
_FACE_QUADS = np.zeros((6, 4, 3), np.float32)
for _f in range(6):
    # Positive cyclic tangents (NOT faces.FACE_TANGENT_FRAMES, whose signs
    # follow the reference's rotation_from_nz for light interpolation and
    # would place quad corners at negative offsets).
    _axis = _f % 3
    _u = np.zeros(3, np.float32)
    _v = np.zeros(3, np.float32)
    _u[(_axis + 1) % 3] = 1.0
    _v[(_axis + 2) % 3] = 1.0
    _n = faces.FACE_NORMALS[_f].astype(np.float32)
    # Negative faces lie on the cube's lower boundary (coordinate 0 along
    # the axis); positive faces on the upper boundary (coordinate 1).
    base = np.maximum(_n, 0.0)
    corners = [base, base + _u, base + _u + _v, base + _v]
    if _f < 3:
        corners = corners[::-1]  # flip winding so normals point outward
    _FACE_QUADS[_f] = np.stack(corners)


@dataclass
class SpaceMesh:
    """space_mesh.rs:39 SpaceMesh: positions + indices + per-vertex color,
    split opaque/transparent (transparent second, depth-sortable)."""

    positions: np.ndarray  # f32[V,3]
    colors: np.ndarray  # f32[V,4]
    indices: np.ndarray  # u32[T*3]
    opaque_range: tuple[int, int] = (0, 0)
    transparent_range: tuple[int, int] = (0, 0)
    #: Optional texture path (mesh/atlas.py): normalized atlas UVs per
    #: vertex + the packed RGBA atlas image. Untextured vertices point at
    #: the atlas's white texel so COLOR_0 × texture composes.
    uvs: np.ndarray | None = None  # f32[V,2]
    texture: np.ndarray | None = None  # u8[H,W,4]

    def shrink_indices(self) -> "SpaceMesh":
        """Downcast indices to u16 when the vertex count allows — the
        reference's IndexVec u16/u32 switching (mesh/src/index_vec.rs):
        halves index memory for the common small-mesh case."""
        if len(self.positions) <= 0xFFFF and self.indices.dtype != np.uint16:
            self.indices = self.indices.astype(np.uint16)
        return self

    @property
    def triangle_count(self) -> int:
        return len(self.indices) // 3

    def is_empty(self) -> bool:
        return len(self.indices) == 0

    def depth_sort_for_view(self, view_position) -> None:
        """space_mesh.rs:393: re-sort transparent triangles far-to-near."""
        lo, hi = self.transparent_range
        if hi <= lo:
            return
        tri = self.indices[lo:hi].reshape(-1, 3)
        centers = self.positions[tri].mean(axis=1)
        d2 = ((centers - np.asarray(view_position, np.float32)) ** 2).sum(-1)
        order = np.argsort(-d2, kind="stable")
        self.indices[lo:hi] = tri[order].reshape(-1)


def visible_faces(space: Space) -> np.ndarray:
    """bool[6, X, Y, Z]: which cube faces need geometry.

    Culling rule (space_mesh.rs interior-face suppression): face f of cube
    c is emitted iff block(c) is visible and the neighbor across f does not
    have an opaque face toward c. World boundary counts as open sky (faces
    at the border are emitted).
    """
    ev = [space.evaluated(i) for i in range(space.palette_len())]
    visible = np.array([e.visible for e in ev], bool)
    opaque = np.stack([e.opaque for e in ev])  # [P,6]

    grid_visible = visible[space.contents]
    out = np.zeros((6,) + space.contents.shape, bool)
    for f in range(6):
        n = faces.FACE_NORMALS[f]
        # Neighbor's facing side is f's opposite.
        opp = faces.opposite(f)
        neighbor_opaque_face = opaque[:, opp][space.contents]
        # Shift: neighbor at c + n. Pad with "not opaque" (open boundary).
        shifted = np.zeros_like(neighbor_opaque_face)
        src = [slice(None)] * 3
        dst = [slice(None)] * 3
        for ax in range(3):
            if n[ax] > 0:
                src[ax] = slice(1, None)
                dst[ax] = slice(0, -1)
            elif n[ax] < 0:
                src[ax] = slice(0, -1)
                dst[ax] = slice(1, None)
        shifted[tuple(dst)] = neighbor_opaque_face[tuple(src)]
        # Also cull faces of fully-opaque-adjacent identical... (covered)
        out[f] = grid_visible & ~shifted
    return out


def _greedy_rects(mask2d: np.ndarray, ids2d: np.ndarray):
    """Greedy rectangle merge over one face plane: same-id contiguous
    rectangles. Yields (u0, v0, w, h, id)."""
    mask = mask2d.copy()
    h_, w_ = mask.shape
    for u in range(h_):
        v = 0
        while v < w_:
            if not mask[u, v]:
                v += 1
                continue
            bid = ids2d[u, v]
            # Extend along v.
            v2 = v
            while v2 + 1 < w_ and mask[u, v2 + 1] and ids2d[u, v2 + 1] == bid:
                v2 += 1
            # Extend along u.
            u2 = u
            while u2 + 1 < h_ and (
                mask[u2 + 1, v : v2 + 1].all()
                and (ids2d[u2 + 1, v : v2 + 1] == bid).all()
            ):
                u2 += 1
            mask[u : u2 + 1, v : v2 + 1] = False
            yield u, v, u2 - u + 1, v2 - v + 1, bid
            v = v2 + 1


def mesh_space(space: Space, greedy: bool = True, style: str | None = None) -> SpaceMesh:
    """Generate the triangle mesh of a Space (SpaceMesh::compute).

    `style`: "unit" (per-face quads), "greedy" (merged rectangles — may
    create T-junction shading seams), or "no_t_junction" (merged
    rectangles fan-triangulated with every lattice boundary vertex — the
    reference planar triangulator's quality contract, implemented by the
    native C++ component native/triangulate.cpp). Block colors
    come from the evaluated per-face colors; recursive blocks are rendered
    at block granularity here — use `mesh_space_voxel_detail` for
    voxel-granular instances of recursive blocks.
    """
    if style is None:
        style = "greedy" if greedy else "unit"
    ev_face_colors = np.stack(
        [space.evaluated(i).face_colors for i in range(space.palette_len())]
    )  # [P,6,4]
    if style == "greedy":
        visible_table = np.array(
            [space.evaluated(i).visible_or_animated() for i in range(space.palette_len())],
            np.uint8,
        )
        opaque_table = np.stack(
            [space.evaluated(i).opaque for i in range(space.palette_len())]
        ).astype(np.uint8)
        return _mesh_arrays_native(
            space.contents, visible_table, opaque_table, ev_face_colors,
            np.asarray(space.bounds.lower, np.float32),
        )
    vis = visible_faces(space)
    if style == "no_t_junction":
        return _mesh_arrays_triangulated(
            space.contents, vis, ev_face_colors,
            np.asarray(space.bounds.lower, np.float32),
        ).shrink_indices()
    return _mesh_arrays(
        space.contents,
        vis,
        ev_face_colors,
        np.asarray(space.bounds.lower, np.float32),
        style == "greedy",
    ).shrink_indices()


def _mesh_arrays_triangulated(contents, vis, ev_face_colors, lower):
    """No-T-junction emission via the native triangulator (per plane)."""
    from ..native import triangulate_plane

    all_pos, all_col = [], []
    idx_by_alpha = {True: [], False: []}
    v_base = 0
    for f in range(6):
        axis = f % 3
        u_ax, v_ax = (axis + 1) % 3, (axis + 2) % 3
        vis_f = vis[f].transpose(axis, u_ax, v_ax)
        ids_f = contents.transpose(axis, u_ax, v_ax)
        plane_off = 1.0 if f >= 3 else 0.0
        for w in range(vis_f.shape[0]):
            plane = vis_f[w]
            if not plane.any():
                continue
            verts2, tris2, tri_ids = triangulate_plane(plane, ids_f[w])
            if len(tris2) == 0:
                continue
            pos = np.zeros((len(verts2), 3), np.float32)
            pos[:, axis] = w + plane_off
            pos[:, u_ax] = verts2[:, 0]
            pos[:, v_ax] = verts2[:, 1]
            pos += lower
            # The triangulator's ring is clockwise in (u, v); positive
            # faces need CCW (outward normals), so flip for f >= 3.
            if f >= 3:
                tris2 = tris2[:, ::-1].copy()
            # Per-vertex color via the triangles that reference each vertex
            # (vertices are per-rectangle, so this is well defined).
            vcol = np.zeros((len(verts2), 4), np.float32)
            cols = ev_face_colors[tri_ids, f]  # [M,4]
            vcol[tris2.reshape(-1)] = np.repeat(cols, 3, axis=0)
            all_pos.append(pos)
            all_col.append(vcol)
            opaque_sel = cols[:, 3] >= 1.0
            for opaque in (True, False):
                sel = opaque_sel == opaque
                if sel.any():
                    idx_by_alpha[opaque].append(
                        (tris2[sel].reshape(-1) + v_base).astype(np.uint32)
                    )
            v_base += len(verts2)

    indices, ranges, cursor = [], {}, 0
    for opaque in (True, False):
        start = cursor
        for ix in idx_by_alpha[opaque]:
            indices.append(ix)
            cursor += len(ix)
        ranges[opaque] = (start, cursor)
    return SpaceMesh(
        positions=(
            np.concatenate(all_pos) if all_pos else np.zeros((0, 3), np.float32)
        ),
        colors=(
            np.concatenate(all_col) if all_col else np.zeros((0, 4), np.float32)
        ),
        indices=(
            np.concatenate(indices) if indices else np.zeros((0,), np.uint32)
        ),
        opaque_range=ranges[True],
        transparent_range=ranges[False],
    )


def _mesh_arrays_native(
    contents: np.ndarray,
    visible_table: np.ndarray,
    opaque_faces_table: np.ndarray,
    ev_face_colors: np.ndarray,
    lower: np.ndarray,
):
    """Whole-space greedy meshing through the native C++ mesher
    (native/space_mesher.cpp). Quad rows expand to vertex buffers as
    vectorized numpy."""
    from ..native import mesh_space_greedy

    rows = mesh_space_greedy(contents, visible_table, opaque_faces_table)
    if len(rows) == 0:
        z = np.zeros
        return SpaceMesh(z((0, 3), np.float32), z((0, 4), np.float32), z((0,), np.uint32))
    face = rows[:, 0]
    axis = face % 3
    u_ax = (axis + 1) % 3
    v_ax = (axis + 2) % 3
    n = len(rows)
    base = np.zeros((n, 3), np.float32)
    scale = np.ones((n, 3), np.float32)
    r_idx = np.arange(n)
    base[r_idx, axis] = rows[:, 1]
    base[r_idx, u_ax] = rows[:, 2]
    base[r_idx, v_ax] = rows[:, 3]
    scale[r_idx, u_ax] = rows[:, 4]
    scale[r_idx, v_ax] = rows[:, 5]
    quads = _FACE_QUADS[face] * scale[:, None, :] + base[:, None, :] + lower
    colors = ev_face_colors[rows[:, 6], face]  # [N,4]

    opaque = colors[:, 3] >= 1.0
    order = np.argsort(~opaque, kind="stable")
    quads, colors, opaque = quads[order], colors[order], opaque[order]
    n_op = int(opaque.sum())
    positions = quads.reshape(-1, 3).astype(np.float32)
    vcolors = np.repeat(colors, 4, axis=0).astype(np.float32)
    tri = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    indices = (tri[None, :] + (np.arange(n, dtype=np.uint32) * 4)[:, None]).reshape(-1)
    return SpaceMesh(
        positions=positions,
        colors=vcolors,
        indices=indices,
        opaque_range=(0, n_op * 6),
        transparent_range=(n_op * 6, n * 6),
    ).shrink_indices()


def _mesh_arrays(
    contents: np.ndarray,
    vis: np.ndarray,
    ev_face_colors: np.ndarray,
    lower: np.ndarray,
    greedy: bool = True,
) -> SpaceMesh:
    """Quad emission over (sub)arrays; `lower` is the world position of
    contents[0,0,0]. Shared by whole-space meshing and per-chunk meshing
    (dynamic.py)."""
    quads_by_alpha = {True: [], False: []}  # opaque? -> list of (quad verts, color)
    for f in range(6):
        axis = f % 3
        u_ax, v_ax = (axis + 1) % 3, (axis + 2) % 3
        vis_f = vis[f].transpose(axis, u_ax, v_ax)  # [W, U, V]
        ids_f = contents.transpose(axis, u_ax, v_ax)
        for w in range(vis_f.shape[0]):
            plane = vis_f[w]
            if not plane.any():
                continue
            ids = ids_f[w]
            rects = (
                _greedy_rects(plane, ids)
                if greedy
                else (
                    (u, v, 1, 1, ids[u, v])
                    for u, v in zip(*np.nonzero(plane))
                )
            )
            for u, v, du, dv, bid in rects:
                color = ev_face_colors[bid, f]
                base = np.zeros(3, np.float32)
                base[axis] = w
                base[u_ax] = u
                base[v_ax] = v
                scale = np.ones(3, np.float32)
                scale[u_ax] = du
                scale[v_ax] = dv
                quad = _FACE_QUADS[f] * scale + base + lower
                quads_by_alpha[color[3] >= 1.0].append((quad, color))

    all_positions = []
    all_colors = []
    all_indices = []
    ranges = {}
    cursor = 0
    for opaque_pass in (True, False):
        start = cursor
        for quad, color in quads_by_alpha[opaque_pass]:
            i0 = len(all_positions)
            all_positions.extend(quad)
            all_colors.extend([color] * 4)
            all_indices.extend([i0, i0 + 1, i0 + 2, i0, i0 + 2, i0 + 3])
            cursor += 6
        ranges[opaque_pass] = (start, cursor)

    return SpaceMesh(
        positions=np.asarray(all_positions, np.float32).reshape(-1, 3),
        colors=np.asarray(all_colors, np.float32).reshape(-1, 4),
        indices=np.asarray(all_indices, np.uint32),
        opaque_range=ranges[True],
        transparent_range=ranges[False],
    )


def block_mesh(ev) -> SpaceMesh:
    """Voxel-detail mesh of one evaluated block in unit-cube coordinates
    (block_mesh.rs:48 BlockMesh: analyze → triangulate per face plane).

    Visible voxel faces (voxel alpha > 0, neighbor not opaque) are merged
    per plane by the native no-T-junction triangulator, keyed by a local
    palette of distinct voxel colors so merged rectangles are color-
    uniform. Positions are scaled by 1/R to fill [0,1]³.
    """
    from ..native import triangulate_plane

    vox = ev.voxels
    r = vox.resolution
    alpha = vox.color[..., 3]
    vis_vox = alpha > 0.0
    opaque_vox = alpha >= 1.0

    # Local color palette → ids for merge keying.
    flat_colors = vox.color.reshape(-1, 4)
    uniq, inv = np.unique(np.round(flat_colors, 6), axis=0, return_inverse=True)
    ids3 = inv.reshape(vox.color.shape[:3]).astype(np.uint16)

    all_pos, all_col = [], []
    idx_by_alpha = {True: [], False: []}
    v_base = 0
    inv_r = 1.0 / r
    for f in range(6):
        axis = f % 3
        u_ax, v_ax = (axis + 1) % 3, (axis + 2) % 3
        n = faces.FACE_NORMALS[f]
        # Occlusion: neighbor voxel through f opaque → face hidden.
        shifted = np.zeros_like(opaque_vox)
        src = [slice(None)] * 3
        dst = [slice(None)] * 3
        for ax in range(3):
            if n[ax] > 0:
                src[ax] = slice(1, None)
                dst[ax] = slice(0, -1)
            elif n[ax] < 0:
                src[ax] = slice(0, -1)
                dst[ax] = slice(1, None)
        shifted[tuple(dst)] = opaque_vox[tuple(src)]
        vis_f = (vis_vox & ~shifted).transpose(axis, u_ax, v_ax)
        ids_f = ids3.transpose(axis, u_ax, v_ax)
        plane_off = 1.0 if f >= 3 else 0.0
        for w in range(r):
            plane = vis_f[w]
            if not plane.any():
                continue
            verts2, tris2, tri_ids = triangulate_plane(plane, ids_f[w])
            if len(tris2) == 0:
                continue
            pos = np.zeros((len(verts2), 3), np.float32)
            pos[:, axis] = (w + plane_off) * inv_r
            pos[:, u_ax] = verts2[:, 0] * inv_r
            pos[:, v_ax] = verts2[:, 1] * inv_r
            if f >= 3:
                tris2 = tris2[:, ::-1].copy()
            cols = uniq[tri_ids].astype(np.float32)
            vcol = np.zeros((len(verts2), 4), np.float32)
            vcol[tris2.reshape(-1)] = np.repeat(cols, 3, axis=0)
            all_pos.append(pos)
            all_col.append(vcol)
            opaque_sel = cols[:, 3] >= 1.0
            for opq in (True, False):
                sel = opaque_sel == opq
                if sel.any():
                    idx_by_alpha[opq].append(
                        (tris2[sel].reshape(-1) + v_base).astype(np.uint32)
                    )
            v_base += len(verts2)

    indices, ranges, cursor = [], {}, 0
    for opq in (True, False):
        start = cursor
        for ix in idx_by_alpha[opq]:
            indices.append(ix)
            cursor += len(ix)
        ranges[opq] = (start, cursor)
    return SpaceMesh(
        positions=np.concatenate(all_pos) if all_pos else np.zeros((0, 3), np.float32),
        colors=np.concatenate(all_col) if all_col else np.zeros((0, 4), np.float32),
        indices=np.concatenate(indices) if indices else np.zeros((0,), np.uint32),
        opaque_range=ranges[True],
        transparent_range=ranges[False],
    )


def mesh_space_voxel_detail(space: Space, style: str = "no_t_junction") -> SpaceMesh:
    """mesh_space + voxel-detail instances for recursive blocks
    (dynamic/instance.rs role, inlined for export): atoms mesh at block
    granularity; every placement of a resolution-R block gets its
    block_mesh translated into position."""
    detail_ids = [
        i for i in range(space.palette_len()) if space.evaluated(i).resolution > 1
    ]
    vis = visible_faces(space)
    # Suppress block-granular faces of voxel blocks; they are instanced.
    for i in detail_ids:
        vis &= space.contents[None, ...] != i
    ev_face_colors = np.stack(
        [space.evaluated(i).face_colors for i in range(space.palette_len())]
    )
    lower = np.asarray(space.bounds.lower, np.float32)
    if style == "no_t_junction":
        base = _mesh_arrays_triangulated(space.contents, vis, ev_face_colors, lower)
    else:
        base = _mesh_arrays(space.contents, vis, ev_face_colors, lower, style == "greedy")

    pieces = [base]
    for i in detail_ids:
        bm = block_mesh(space.evaluated(i))
        if bm.is_empty():
            continue
        for rel in np.argwhere(space.contents == i):
            world = rel.astype(np.float32) + lower
            pieces.append(
                SpaceMesh(
                    positions=bm.positions + world,
                    colors=bm.colors,
                    indices=bm.indices.copy(),
                    opaque_range=bm.opaque_range,
                    transparent_range=bm.transparent_range,
                )
            )
    # Concatenate with opaque-first ordering.
    positions = np.concatenate([p.positions for p in pieces])
    colors = np.concatenate([p.colors for p in pieces])
    offs = np.cumsum([0] + [len(p.positions) for p in pieces[:-1]])
    indices, ranges, cursor = [], {}, 0
    for opq in (True, False):
        start = cursor
        for p, off in zip(pieces, offs):
            lo, hi = p.opaque_range if opq else p.transparent_range
            if hi > lo:
                indices.append(p.indices[lo:hi] + np.uint32(off))
                cursor += hi - lo
        ranges[opq] = (start, cursor)
    return SpaceMesh(
        positions=positions,
        colors=colors,
        indices=(
            np.concatenate(indices).astype(np.uint32)
            if indices
            else np.zeros((0,), np.uint32)
        ),
        opaque_range=ranges[True],
        transparent_range=ranges[False],
    ).shrink_indices()


def mesh_space_textured(space: Space, style: str = "no_t_junction") -> SpaceMesh:
    """mesh_space_voxel_detail with the texture-atlas path for recursive
    blocks (texture.rs:38 role; see mesh/atlas.py).

    Atoms mesh at block granularity with vertex colors (their UVs point
    at the atlas's white texel); every resolution-R block is meshed once
    via `block_mesh_textured` (merged rects + texel planes) and instanced
    per placement. Returns a SpaceMesh carrying `uvs` and `texture`.
    """
    from .atlas import PlaneAtlas, block_mesh_textured, resolve_uvs, white_uv

    atlas = PlaneAtlas()
    detail_ids = [
        i for i in range(space.palette_len()) if space.evaluated(i).resolution > 1
    ]
    vis = visible_faces(space)
    for i in detail_ids:
        vis &= space.contents[None, ...] != i
    ev_face_colors = np.stack(
        [space.evaluated(i).face_colors for i in range(space.palette_len())]
    )
    lower = np.asarray(space.bounds.lower, np.float32)
    if style == "no_t_junction":
        base = _mesh_arrays_triangulated(space.contents, vis, ev_face_colors, lower)
    else:
        base = _mesh_arrays(space.contents, vis, ev_face_colors, lower, style == "greedy")

    tex_blocks = {i: block_mesh_textured(space.evaluated(i), atlas) for i in detail_ids}

    # Assemble: base (white UVs) + textured instances, opaque-first.
    pieces = []  # (positions, colors, uv_texels|None, plane_ids|None, indices, oR, tR)
    pieces.append(
        (base.positions, base.colors, None, None, base.indices,
         base.opaque_range, base.transparent_range)
    )
    for i in detail_ids:
        pos, col, uv, idx, pid, o_r, t_r = tex_blocks[i]
        if len(idx) == 0:
            continue
        for rel in np.argwhere(space.contents == i):
            world = rel.astype(np.float32) + lower
            pieces.append((pos + world, col, uv, pid, idx, o_r, t_r))

    image, origins, _white = atlas.pack()
    wuv = white_uv(image.shape)

    positions = np.concatenate([p[0] for p in pieces])
    colors = np.concatenate([p[1] for p in pieces])
    uvs = np.concatenate(
        [
            np.broadcast_to(wuv, (len(p[0]), 2)).astype(np.float32)
            if p[2] is None
            else resolve_uvs(p[2], p[3], origins, image.shape)
            for p in pieces
        ]
    )
    offs = np.cumsum([0] + [len(p[0]) for p in pieces[:-1]])
    indices, ranges, cursor = [], {}, 0
    for opq in (True, False):
        start = cursor
        for p, off in zip(pieces, offs):
            lo, hi = p[5] if opq else p[6]
            if hi > lo:
                indices.append(p[4][lo:hi] + np.uint32(off))
                cursor += hi - lo
        ranges[opq] = (start, cursor)
    return SpaceMesh(
        positions=positions,
        colors=colors,
        indices=(
            np.concatenate(indices).astype(np.uint32)
            if indices
            else np.zeros((0,), np.uint32)
        ),
        opaque_range=ranges[True],
        transparent_range=ranges[False],
        uvs=uvs,
        texture=image,
    ).shrink_indices()
