"""Mesh export: glTF 2.0 (vertex colors, textures, animation) and binary STL.

Port of `aic_tpu/io/export.py`. Two changes, neither in what a reader
of the files sees: the glTF atlas is encoded by the port's
`raytrace/render.py::encode_png` (no imaging library), so only the
embedded PNG's bytes differ; the STL's triangles are written as one
numpy structured array per block of triangles, not a `struct.pack` per
triangle, and equal `aic_tpu`'s bytes after the 80-byte header.

Equivalent of all-is-cubes-port's exporters (port/src/gltf/ — mesh.rs,
texture.rs, animation.rs — and port/src/stl.rs): meshes come from
`aic_tpu_torch.mesh`; glTF uses one embedded buffer per file. The texture path
embeds the mesh's packed atlas as a PNG with TEXCOORD_0 + a
baseColorTexture material (COLOR_0 multiplies the texture, so vertex-
colored geometry shares the material via the atlas's white texel —
gltf/texture.rs:36-40). Animation follows the reference's scheme
(gltf/animation.rs:12-23): per-frame mesh nodes whose visibility is
animated by scale-0/1 keyframes (glTF has no visibility channel; zero
scale is the spec-sanctioned alternative), plus an optional camera
translation track.
"""

from __future__ import annotations

import base64
import json

import numpy as np

from ..mesh.mesher import SpaceMesh


def _data_uri(data: bytes, mime: str = "application/octet-stream") -> str:
    return f"data:{mime};base64," + base64.b64encode(data).decode()


def _png_bytes(image: np.ndarray) -> bytes:
    from ..raytrace.render import encode_png

    return encode_png(image)


class _GltfBuilder:
    """Accumulates buffer views / accessors over one embedded buffer."""

    def __init__(self):
        self.root = {
            "asset": {"version": "2.0", "generator": "aic_tpu"},
            "scene": 0,
            "scenes": [{"nodes": []}],
            "nodes": [],
            "meshes": [],
            "buffers": [],
            "bufferViews": [],
            "accessors": [],
        }
        self._chunks = []
        self._length = 0

    def buffer_view(self, data: bytes, target=None) -> int:
        pad = (-self._length) % 4
        if pad:
            self._chunks.append(b"\0" * pad)
            self._length += pad
        view = {"buffer": 0, "byteOffset": self._length, "byteLength": len(data)}
        if target:
            view["target"] = target
        self.root["bufferViews"].append(view)
        self._chunks.append(data)
        self._length += len(data)
        return len(self.root["bufferViews"]) - 1

    def accessor(self, array: np.ndarray, type_: str, component: int,
                 target=None, minmax=False) -> int:
        view = self.buffer_view(array.tobytes(), target)
        acc = {
            "bufferView": view,
            "componentType": component,
            "count": len(array),
            "type": type_,
        }
        if minmax and len(array):
            acc["min"] = np.asarray(array).min(axis=0).reshape(-1).tolist()
            acc["max"] = np.asarray(array).max(axis=0).reshape(-1).tolist()
        self.root["accessors"].append(acc)
        return len(self.root["accessors"]) - 1

    def add_mesh(self, mesh: SpaceMesh, material: int | None = None) -> int:
        attrs = {
            "POSITION": self.accessor(
                mesh.positions.astype("<f4"), "VEC3", 5126, 34962, minmax=True
            ),
            "COLOR_0": self.accessor(
                mesh.colors.astype("<f4"), "VEC4", 5126, 34962
            ),
        }
        if mesh.uvs is not None:
            attrs["TEXCOORD_0"] = self.accessor(
                mesh.uvs.astype("<f4"), "VEC2", 5126, 34962
            )
        prim = {
            "attributes": attrs,
            "indices": (
                self.accessor(mesh.indices.astype("<u2"), "SCALAR", 5123, 34963)
                if mesh.indices.dtype == np.uint16
                else self.accessor(mesh.indices.astype("<u4"), "SCALAR", 5125, 34963)
            ),
            "mode": 4,
        }
        if material is not None:
            prim["material"] = material
        self.root["meshes"].append({"primitives": [prim]})
        return len(self.root["meshes"]) - 1

    def add_texture_material(self, image: np.ndarray) -> int:
        self.root.setdefault("images", []).append(
            {"uri": _data_uri(_png_bytes(image), "image/png")}
        )
        self.root.setdefault("samplers", []).append(
            {"magFilter": 9728, "minFilter": 9728, "wrapS": 33071, "wrapT": 33071}
        )
        self.root.setdefault("textures", []).append(
            {
                "source": len(self.root["images"]) - 1,
                "sampler": len(self.root["samplers"]) - 1,
            }
        )
        self.root.setdefault("materials", []).append(
            {
                "pbrMetallicRoughness": {
                    "baseColorTexture": {
                        "index": len(self.root["textures"]) - 1,
                        "texCoord": 0,
                    },
                    "metallicFactor": 0.0,
                    "roughnessFactor": 1.0,
                },
                "alphaMode": "BLEND",
            }
        )
        return len(self.root["materials"]) - 1

    def finish(self, path: str):
        buffer = b"".join(self._chunks)
        self.root["buffers"] = [
            {"byteLength": len(buffer), "uri": _data_uri(buffer)}
        ]
        with open(path, "w") as f:
            json.dump(self.root, f)


def export_gltf(mesh: SpaceMesh, path: str, name: str = "space"):
    """Export one mesh. With a textured mesh (mesh.texture not None) the
    atlas is embedded and TEXCOORD_0/material emitted."""
    b = _GltfBuilder()
    material = b.add_texture_material(mesh.texture) if mesh.texture is not None else None
    mi = b.add_mesh(mesh, material)
    b.root["nodes"].append({"mesh": mi, "name": name})
    b.root["scenes"][0]["nodes"].append(0)
    b.finish(path)


def export_gltf_animation(
    frames: list[SpaceMesh],
    path: str,
    frame_pace: float = 1.0 / 16.0,
    camera_positions=None,
    name: str = "space",
):
    """Export a frame sequence as one animated glTF (gltf/animation.rs).

    Each frame's mesh becomes a node; a step animation toggles node scale
    between 1 (its frame) and 0 (other frames). `camera_positions`
    (optional f64[N,3]) adds a camera node with a translation track.
    """
    b = _GltfBuilder()
    n = len(frames)
    times = np.arange(n, dtype="<f4") * np.float32(frame_pace)
    time_acc = b.accessor(times.reshape(-1, 1), "SCALAR", 5126, minmax=True)

    channels, samplers = [], []
    for i, mesh in enumerate(frames):
        material = (
            b.add_texture_material(mesh.texture) if mesh.texture is not None else None
        )
        mi = b.add_mesh(mesh, material)
        b.root["nodes"].append({"mesh": mi, "name": f"{name}.frame{i}"})
        node = len(b.root["nodes"]) - 1
        b.root["scenes"][0]["nodes"].append(node)
        scales = np.zeros((n, 3), "<f4")
        scales[i] = 1.0
        acc = b.accessor(scales, "VEC3", 5126)
        samplers.append(
            {"input": time_acc, "interpolation": "STEP", "output": acc}
        )
        channels.append(
            {
                "sampler": len(samplers) - 1,
                "target": {"node": node, "path": "scale"},
            }
        )

    if camera_positions is not None:
        cam_pos = np.asarray(camera_positions, "<f4")
        b.root.setdefault("cameras", []).append(
            {"type": "perspective", "perspective": {"yfov": 1.0, "znear": 0.01}}
        )
        b.root["nodes"].append(
            {"camera": 0, "name": "camera", "translation": cam_pos[0].tolist()}
        )
        cam_node = len(b.root["nodes"]) - 1
        b.root["scenes"][0]["nodes"].append(cam_node)
        acc = b.accessor(cam_pos, "VEC3", 5126)
        samplers.append(
            {"input": time_acc, "interpolation": "LINEAR", "output": acc}
        )
        channels.append(
            {
                "sampler": len(samplers) - 1,
                "target": {"node": cam_node, "path": "translation"},
            }
        )

    b.root["animations"] = [
        {"name": "frames", "channels": channels, "samplers": samplers}
    ]
    b.finish(path)


#: One binary STL triangle record: normal, three vertices, attribute 0.
STL_RECORD = np.dtype([("normal", "<f4", 3), ("vertices", "<f4", (3, 3)), ("attribute", "<u2")])

def export_stl(mesh: SpaceMesh, path: str):
    """Binary STL of the mesh's triangles, with unit normals (zero for a
    degenerate triangle), written as one `STL_RECORD` array."""
    v = mesh.positions[mesh.indices.reshape(-1, 3)]  # [T,3,3]
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    lens = np.linalg.norm(n, axis=-1, keepdims=True)
    rec = np.zeros(len(v), STL_RECORD)
    rec["normal"] = np.where(lens > 0, n / np.maximum(lens, 1e-12), 0.0)
    rec["vertices"] = v
    with open(path, "wb") as f:
        f.write(b"aic_tpu_torch binary STL".ljust(80, b"\0"))
        f.write(np.uint32(len(v)).astype("<u4").tobytes())
        rec.tofile(f)
