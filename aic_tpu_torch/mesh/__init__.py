"""Layer 2b: meshing (reference: all-is-cubes-mesh); port of `aic_tpu/mesh`."""

from .dynamic import CHUNK_SIZE, ChunkedSpaceMesh, CsmUpdateInfo
from .atlas import PlaneAtlas, block_mesh_textured
from .mesher import (
    SpaceMesh,
    block_mesh,
    mesh_space,
    mesh_space_textured,
    mesh_space_voxel_detail,
    visible_faces,
)

__all__ = [
    "CHUNK_SIZE",
    "ChunkedSpaceMesh",
    "CsmUpdateInfo",
    "SpaceMesh",
    "block_mesh",
    "mesh_space_voxel_detail",
    "mesh_space_textured",
    "PlaneAtlas",
    "block_mesh_textured",
    "mesh_space",
    "visible_faces",
]
