"""MagicaVoxel .vox import/export (reference: all-is-cubes-port/src/mv/).

Copied unchanged from `aic_tpu/io/vox.py` (host numpy over the port's
`Space`): both packages write the same bytes for the same space.

Implements the core VOX chunk format: SIZE/XYZI models + RGBA palette.
Import maps each model to a Space (coordinate convention: VOX is
Z-up/right-handed; all-is-cubes is Y-up — mv/import.rs swaps (x, z, y),
mirroring z, which we match); export writes one model from a Space.
"""

from __future__ import annotations

import struct

import numpy as np

from ..block import from_color
from ..math.color import np_srgb8_to_linear
from ..math.grid import GridAab
from ..space import Space

_DEFAULT_PALETTE = None


def _default_palette() -> np.ndarray:
    """MagicaVoxel's built-in default palette (generated formulaically)."""
    global _DEFAULT_PALETTE
    if _DEFAULT_PALETTE is None:
        # The canonical default palette: 255 colors.
        vals = [255, 204, 153, 102, 51, 0]
        colors = []
        for r in vals:
            for g in vals:
                for b in vals:
                    colors.append((r, g, b, 255))
        # pad/trim to 256 slots (slot 0 unused)
        grays = [(i, i, i, 255) for i in (238, 221, 187, 170, 136, 119, 85, 68, 34, 17)]
        colors = colors[:216] + grays + [(0, 0, 0, 255)] * 30
        _DEFAULT_PALETTE = np.array([(0, 0, 0, 0)] + colors[:255], np.uint8)
    return _DEFAULT_PALETTE


def _read_chunks(data: bytes, offset: int, end: int):
    """Iterate chunks, validating lengths: a .vox file is untrusted input
    (fuzz_import.rs contract), so negative or out-of-range chunk lengths
    must raise ValueError, not loop forever or index garbage."""
    while offset < end:
        if offset + 12 > len(data):
            raise ValueError("VOX: truncated chunk header")
        try:
            cid = data[offset : offset + 4].decode("ascii")
        except UnicodeDecodeError:
            raise ValueError("VOX: non-ASCII chunk id") from None
        content_len, children_len = struct.unpack_from("<ii", data, offset + 4)
        if content_len < 0 or children_len < 0:
            raise ValueError("VOX: negative chunk length")
        child_start = offset + 12 + content_len
        chunk_end = child_start + children_len
        if chunk_end > len(data):
            raise ValueError("VOX: chunk overruns file")
        content = data[offset + 12 : child_start]
        yield cid, content, child_start, chunk_end
        offset = chunk_end


def import_vox(path: str) -> list[Space]:
    """Read a .vox file; returns one Space per model (mv/import.rs)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"VOX ":
        raise ValueError("not a VOX file")

    sizes = []
    voxel_sets = []
    palette = _default_palette()

    _MAX_DIM = 2048  # > MagicaVoxel's own 256 model limit, still sane

    def walk(offset, end, depth=0):
        nonlocal palette
        if depth > 8:
            raise ValueError("VOX: chunk nesting too deep")
        for cid, content, cs, ce in _read_chunks(data, offset, end):
            if cid == "SIZE":
                if len(content) < 12:
                    raise ValueError("VOX: short SIZE chunk")
                dims = struct.unpack("<iii", content[:12])
                if any(d < 0 or d > _MAX_DIM for d in dims):
                    raise ValueError(f"VOX: unreasonable model size {dims}")
                sizes.append(dims)
            elif cid == "XYZI":
                if len(content) < 4:
                    raise ValueError("VOX: short XYZI chunk")
                (n,) = struct.unpack_from("<i", content, 0)
                if n < 0 or 4 + 4 * n > len(content):
                    raise ValueError(f"VOX: XYZI claims {n} voxels beyond chunk")
                vox = np.frombuffer(content[4 : 4 + 4 * n], np.uint8).reshape(n, 4)
                voxel_sets.append(vox)
            elif cid == "RGBA":
                if len(content) < 1024:
                    raise ValueError("VOX: short RGBA chunk")
                pal = np.frombuffer(content[:1024], np.uint8).reshape(256, 4)
                # VOX palette is 1-indexed: color i applies to index i+1.
                palette = np.concatenate([[(0, 0, 0, 0)], pal[:255]]).astype(np.uint8)
            walk(cs, ce, depth + 1)

    # MAIN chunk
    for cid, content, cs, ce in _read_chunks(data, 8, len(data)):
        if cid == "MAIN":
            walk(cs, ce)

    spaces = []
    for (sx, sy, sz), vox in zip(sizes, voxel_sets):
        if sx * sy * sz > 1 << 26:
            raise ValueError(f"VOX: model volume {sx*sy*sz} exceeds import cap")
        # VOX (x, y, z) Z-up → ours (x, z_mirrored, y) Y-up.
        sp = Space(GridAab.from_lower_size((0, 0, 0), (sx, sz, sy)))
        blocks = {}
        for x, y, z, ci in vox:
            if x >= sx or y >= sy or z >= sz:
                raise ValueError(
                    f"VOX: voxel ({x},{y},{z}) outside model size ({sx},{sy},{sz})"
                )
            rgba = palette[ci]
            if ci not in blocks:
                lin = np_srgb8_to_linear(rgba[:3])
                blocks[ci] = from_color(
                    (float(lin[0]), float(lin[1]), float(lin[2]), float(rgba[3]) / 255.0),
                    display_name=f"vox{ci}",
                )
            sp.set((int(x), int(z), sy - 1 - int(y)), blocks[ci])
        spaces.append(sp)
    return spaces


def export_vox(space: Space, path: str):
    """Write a Space as a single-model .vox (mv/export)."""
    sx, sy, sz = space.bounds.size
    if max(sx, sy, sz) > 256:
        raise ValueError("VOX models are limited to 256³")

    # Build palette: up to 255 distinct block colors.
    from ..math.color import np_linear_to_srgb8

    pal_rgba = np.zeros((256, 4), np.uint8)
    index_map = {}
    next_slot = 1
    voxels = []
    for (x, y, z) in space.bounds.interior_iter():
        idx = space.index_at((x, y, z))
        if idx == 0:
            continue
        if idx not in index_map:
            if next_slot > 255:
                raise ValueError("too many distinct blocks for VOX palette")
            ev = space.evaluated(idx)
            srgb = np_linear_to_srgb8(ev.color[:3])
            pal_rgba[next_slot] = (*srgb, min(int(round(ev.color[3] * 255)), 255))
            index_map[idx] = next_slot
            next_slot += 1
        rel = space._rel((x, y, z))
        # ours (x, y_up, z) → VOX (x, z_mirrored, y)
        voxels.append((rel[0], sz - 1 - rel[2], rel[1], index_map[idx]))

    xyzi = struct.pack("<i", len(voxels)) + b"".join(
        struct.pack("<4B", *v) for v in voxels
    )
    size = struct.pack("<iii", sx, sz, sy)
    rgba = pal_rgba[1:].tobytes() + bytes(4)  # 256 entries, rotated 1-index

    def chunk(cid: bytes, content: bytes, children: bytes = b"") -> bytes:
        return cid + struct.pack("<ii", len(content), len(children)) + content + children

    main_children = chunk(b"SIZE", size) + chunk(b"XYZI", xyzi) + chunk(b"RGBA", rgba)
    doc = b"VOX " + struct.pack("<i", 150) + chunk(b"MAIN", b"", main_children)
    with open(path, "wb") as f:
        f.write(doc)
