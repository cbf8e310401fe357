"""Texture-atlas mesh path: 2D plane atlas + textured block meshes.

Port of `aic_tpu/mesh/atlas.py` (host numpy, unchanged); `aic_tpu`'s
notes follow.

Role of the reference's texture abstraction for meshes
(all-is-cubes-mesh/src/texture.rs:38 `Allocator`/`Tile`/`Plane`) and the
glTF texture atlas (all-is-cubes-port/src/gltf/texture.rs:95
`GltfTextureAllocator` + `UvMap`): voxel-detail blocks emit *merged* face
rectangles whose texel detail lives in an atlas texture, instead of one
colored quad per voxel face. This collapses an R³ block's face from up to
R² quads to a handful, and lets animated blocks re-texture without
re-meshing (block_mesh/compute.rs:47-50 chooses textures for exactly
those cases).

Design deviations (documented):
- The reference's GPU path uses a 3D texture with octree allocation
  (gpu/src/common/octree_alloc.rs:32); its glTF path flattens per-face
  2D planes into a shelf-packed 2D atlas. We implement the 2D plane
  atlas only — it serves both our export fidelity goal and any client
  renderer, and at our scales a shelf packer replaces the octree.
- Planes are deduplicated by content hash, so a space with many
  instances of one block costs one set of planes (the reference dedups
  at the block-mesh level; same effect).
- A reserved opaque-white texel at (0,0) lets untextured (vertex-colored)
  geometry share the same mesh/material: its UVs point at the white
  texel and glTF multiplies COLOR_0 × texture (gltf/texture.rs:36-40,
  the same trick).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..math import faces


@dataclass
class PlaneAtlas:
    """Shelf-packing 2D RGBA texel atlas (gltf/texture.rs UvMap role)."""

    planes: list = field(default_factory=list)  # [(h, w, texels u8[h,w,4])]
    _dedup: dict = field(default_factory=dict)

    def add_plane(self, texels: np.ndarray) -> int:
        """Register an RGBA texel plane (u8[h,w,4]); returns a plane id.
        Identical planes share one id."""
        texels = np.ascontiguousarray(texels, np.uint8)
        key = (texels.shape, texels.tobytes())
        pid = self._dedup.get(key)
        if pid is None:
            pid = len(self.planes)
            self.planes.append(texels)
            self._dedup[key] = pid
        return pid

    def pack(self):
        """Pack all planes into one image. Returns (image u8[H,W,4],
        origins i32[N,2] (row, col) per plane, white (row, col)).

        Shelf packing in registration order, 1-texel white block reserved
        at the origin; power-of-two-rounded image size (GPU-friendly).
        """
        order = sorted(
            range(len(self.planes)),
            key=lambda i: -self.planes[i].shape[0],
        )
        total_area = 1 + sum(int(p.shape[0] * p.shape[1]) for p in self.planes)
        width = 1
        while width * width < total_area * 2:
            width *= 2
        max_w = max([2] + [p.shape[1] for p in self.planes])
        width = max(width, 1 << int(np.ceil(np.log2(max_w))))

        origins = np.zeros((len(self.planes), 2), np.int32)
        row, col, shelf_h = 0, 0, 1
        # The white texel occupies (0,0); start packing after it.
        col = 1
        for i in order:
            h, w = self.planes[i].shape[:2]
            if col + w > width:
                row += shelf_h
                col, shelf_h = 0, h
            shelf_h = max(shelf_h, h)
            origins[i] = (row, col)
            col += w
        height_used = row + shelf_h
        height = 1
        while height < height_used:
            height *= 2

        image = np.zeros((height, width, 4), np.uint8)
        image[0, 0] = (255, 255, 255, 255)
        for i, p in enumerate(self.planes):
            r, c = origins[i]
            image[r : r + p.shape[0], c : c + p.shape[1]] = p
        return image, origins, (0, 0)


def srgb8_from_linear(rgba: np.ndarray) -> np.ndarray:
    """Linear float RGBA → sRGB8 texels (alpha linear)."""
    from ..math.color import np_linear_to_srgb8

    rgb = np_linear_to_srgb8(np.clip(rgba[..., :3], 0.0, 1.0))
    a = np.clip(np.round(rgba[..., 3:] * 255.0), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, a], axis=-1)


def block_mesh_textured(ev, atlas: PlaneAtlas):
    """Voxel-detail mesh of one evaluated block with UV-mapped faces.

    Counterpart of :func:`~aic_tpu_torch.mesh.mesher.block_mesh` on the texture
    path (block_mesh/compute.rs:102-118 QuadColoring::Texture): per face
    layer, visible voxel faces are greedily merged IGNORING color (the
    texel plane carries the detail), each merged rect becomes one quad
    with texel-space UVs into an atlas plane sliced from the block's
    voxels. Opaque and transparent faces merge separately so the
    opaque/transparent index split stays exact.

    Returns (positions f32[V,3] in [0,1]³, colors f32[V,4] (all white),
    uvs f32[V,2] texel coords tagged with plane id in a side list,
    indices u32, per-vertex plane ids i32[V], opaque_range,
    transparent_range).
    """
    from .mesher import _greedy_rects

    vox = ev.voxels
    r = vox.resolution
    alpha = vox.color[..., 3]
    vis_vox = alpha > 0.0
    opaque_vox = alpha >= 1.0

    all_pos, all_uv, all_pid = [], [], []
    idx_by_alpha = {True: [], False: []}
    v_base = 0
    inv_r = 1.0 / r
    for f in range(6):
        axis = f % 3
        u_ax, v_ax = (axis + 1) % 3, (axis + 2) % 3
        n = faces.FACE_NORMALS[f]
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
        opq_f = opaque_vox.transpose(axis, u_ax, v_ax)
        col_f = vox.color.transpose(axis, u_ax, v_ax, 3)
        plane_off = 1.0 if f >= 3 else 0.0
        for w in range(r):
            layer = vis_f[w]
            if not layer.any():
                continue
            plane_texels = srgb8_from_linear(col_f[w])
            # Invisible texels are zeroed so bilinear sampling at rect
            # edges doesn't pull arbitrary hidden-voxel colors.
            plane_texels = np.where(layer[..., None], plane_texels, 0)
            pid = atlas.add_plane(plane_texels)
            for opq in (True, False):
                mask = layer & (opq_f[w] == opq)
                if not mask.any():
                    continue
                ids = np.zeros_like(mask, np.uint16)
                for u0, v0, hh, ww, _ in _greedy_rects(mask, ids):
                    # Quad corners in (u,v) texel space.
                    uv = np.array(
                        [
                            [u0, v0],
                            [u0 + hh, v0],
                            [u0 + hh, v0 + ww],
                            [u0, v0 + ww],
                        ],
                        np.float32,
                    )
                    pos = np.zeros((4, 3), np.float32)
                    pos[:, axis] = (w + plane_off) * inv_r
                    pos[:, u_ax] = uv[:, 0] * inv_r
                    pos[:, v_ax] = uv[:, 1] * inv_r
                    tri = np.array([0, 1, 2, 0, 2, 3], np.uint32)
                    if f >= 3:
                        tri = tri[::-1].copy()
                    all_pos.append(pos)
                    all_uv.append(uv)
                    all_pid.append(np.full(4, pid, np.int32))
                    idx_by_alpha[opq].append(tri + np.uint32(v_base))
                    v_base += 4

    indices, ranges, cursor = [], {}, 0
    for opq in (True, False):
        start = cursor
        for ix in idx_by_alpha[opq]:
            indices.append(ix)
            cursor += len(ix)
        ranges[opq] = (start, cursor)
    nv = v_base
    return (
        np.concatenate(all_pos) if all_pos else np.zeros((0, 3), np.float32),
        np.ones((nv, 4), np.float32),
        np.concatenate(all_uv) if all_uv else np.zeros((0, 2), np.float32),
        np.concatenate(indices) if indices else np.zeros((0,), np.uint32),
        np.concatenate(all_pid) if all_pid else np.zeros((0,), np.int32),
        ranges[True],
        ranges[False],
    )


def resolve_uvs(uv_texels: np.ndarray, plane_ids: np.ndarray, origins, image_shape):
    """Texel-space UVs + plane ids → normalized atlas UVs (f32[V,2], glTF
    convention: u right, v down, range 0-1)."""
    h, w = image_shape[:2]
    if len(uv_texels) == 0:
        return np.zeros((0, 2), np.float32)
    org = origins[plane_ids]  # [V,2] (row, col)
    v = (org[:, 0] + uv_texels[:, 0]) / h
    u = (org[:, 1] + uv_texels[:, 1]) / w
    return np.stack([u, v], axis=-1).astype(np.float32)


def white_uv(image_shape) -> np.ndarray:
    """UV of the center of the reserved white texel."""
    h, w = image_shape[:2]
    return np.array([0.5 / w, 0.5 / h], np.float32)
