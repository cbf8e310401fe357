"""Host-authoritative Space container + palette (layer 1).

Port of `aic_tpu/space/space.py`. The host side (palette dedup, block
evaluation, `set`/`fill`, the fast light seed, and what transactions
and the step loop read: `palette_len`, `block_at`, `index_at`, the
palette `epoch`, `reevaluate_palette`, `distinct_blocks`, `extract`)
and the edit journal (`drain_edits`, read by the chunked mesher) is
copied unchanged; `snapshot(device=...)` builds the same numpy tables
and packed cells and hands them over with `torch.as_tensor`, and
`absorb` copies a state's tensors back.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Optional

import numpy as np
import torch

from ..block import AIR, AIR_EVALUATED, Block, EvaluatedBlock, evaluate
from ..math import lightpack
from ..math.grid import GridAab
from .sky import Sky
from .state import BlockTables, SpaceState

#: Collision solid-mask resolution cap (see BlockTables.collision_res).
_COLLISION_MAX_RES = 32

#: space.rs:77 `BlockIndex = u16`.
MAX_PALETTE = 65536


@dataclass
class SpacePhysics:
    """space/physics.rs:27: gravity, sky, light physics."""

    gravity: tuple[float, float, float] = (0.0, -20.0, 0.0)
    sky: Sky = dc_field(default_factory=Sky.default)
    light_enabled: bool = True
    light_max_distance: int = 30  # physics.rs:103 LightPhysics::Rays default

    @staticmethod
    def default_for_light_test() -> "SpacePhysics":
        return SpacePhysics()


class Space:
    def __init__(
        self,
        bounds: GridAab,
        physics: Optional[SpacePhysics] = None,
        fill: Optional[Block] = None,
    ):
        self.bounds = bounds
        self.physics = physics or SpacePhysics()
        self._palette: list[Block] = [AIR]
        self._evaluated: list[EvaluatedBlock] = [AIR_EVALUATED]
        self._block_to_index: dict = {AIR: 0}
        #: Recycled palette slots; slot 0 stays AIR forever.
        self._free_slots: list[int] = []
        self.contents = np.zeros(bounds.size, np.uint16)
        self.light = np.zeros(bounds.size + (4,), np.uint8)
        self.light_dirty = np.zeros(bounds.size, np.uint8)
        self.spawn_position: Optional[tuple] = None
        #: Bumped on palette changes (a new or recycled entry, GC,
        #: re-evaluation): the step loop's tick-closure cache keys on it.
        self.epoch = 0
        #: Edit journal for incremental consumers (`mesh.ChunkedSpaceMesh`):
        #: relative cubes edited since the last drain, or "all" after a
        #: bulk edit. The device tick's palette remap writes no entry.
        self._edit_log: object = set()
        if fill is not None and fill is not AIR:
            self.fill(bounds, fill)

    # -- palette ------------------------------------------------------------

    @property
    def palette(self) -> list[Block]:
        return list(self._palette)

    def palette_len(self) -> int:
        return len(self._palette)

    def ensure_block(self, block: Block) -> int:
        """Dedup-intern a block, evaluating it (space/palette.rs)."""
        idx = self._block_to_index.get(block)
        if idx is not None:
            return idx
        if not self._free_slots and len(self._palette) >= MAX_PALETTE:
            self._collect_garbage()
        if self._free_slots:
            idx = self._free_slots.pop()
            self._palette[idx] = block
            self._evaluated[idx] = evaluate(block)
        else:
            if len(self._palette) >= MAX_PALETTE:
                raise ValueError("palette full (65536 blocks in use)")
            self._palette.append(block)
            self._evaluated.append(evaluate(block))
            idx = len(self._palette) - 1
        self._block_to_index[block] = idx
        self.epoch += 1
        return idx

    def _collect_garbage(self) -> int:
        """Free palette slots for blocks no longer present in contents."""
        counts = np.bincount(self.contents.ravel(), minlength=len(self._palette))
        freed = 0
        for idx in range(1, len(self._palette)):
            if counts[idx] == 0 and self._palette[idx] is not AIR:
                blk = self._palette[idx]
                if self._block_to_index.get(blk) == idx:
                    del self._block_to_index[blk]
                self._palette[idx] = AIR
                self._evaluated[idx] = AIR_EVALUATED
                self._free_slots.append(idx)
                freed += 1
        if freed:
            self.epoch += 1
        return freed

    def distinct_blocks(self) -> list[Block]:
        """Blocks currently present in the space, in palette-index order
        (space.rs distinct_blocks)."""
        counts = np.bincount(self.contents.ravel(), minlength=len(self._palette))
        return [b for i, b in enumerate(self._palette) if counts[i] > 0]

    def reevaluate_palette(self):
        """Re-run evaluation for all palette entries (the step loop's
        `Synchronize` phase for changed BlockDefs)."""
        self._evaluated = [evaluate(b) for b in self._palette]
        self.epoch += 1

    def evaluated(self, index: int) -> EvaluatedBlock:
        return self._evaluated[index]

    def evaluated_block_at(self, cube) -> EvaluatedBlock:
        return self._evaluated[int(self.contents[self._rel(cube)])]

    def block_at(self, cube) -> Block:
        return self._palette[int(self.contents[self._rel(cube)])]

    def index_at(self, cube) -> int:
        return int(self.contents[self._rel(cube)])

    # -- mutation (host-side content construction) ---------------------------

    def _rel(self, cube):
        return tuple(int(c - l) for c, l in zip(cube, self.bounds.lower))

    def set(self, cube, block: Block) -> bool:
        """space.rs:1344 Mutation::set (host path)."""
        if not self.bounds.contains_cube(cube):
            raise IndexError(f"cube {cube} outside bounds {self.bounds}")
        idx = self.ensure_block(block)
        rel = self._rel(cube)
        if self.contents[rel] == idx:
            return False
        self.contents[rel] = idx
        self._mark_light_dirty_around(rel)
        self._log_edit(rel)
        return True

    def _log_edit(self, rel):
        if isinstance(self._edit_log, set):
            self._edit_log.add(rel)
            if len(self._edit_log) > 4096:
                self._edit_log = "all"

    def drain_edits(self):
        """Take the set of edited cubes (relative coordinates) or "all"
        (the SpaceChange listener's drain)."""
        out = self._edit_log
        self._edit_log = set()
        return out

    def fill(self, region: GridAab, block_or_fn, clip: bool = True) -> None:
        """space.rs:1390 fill/fill_uniform (host path); `clip` intersects
        the region with the bounds, `clip=False` raises outside them."""
        if not clip and region.intersection(self.bounds).volume() != region.volume():
            raise IndexError(
                f"fill region {region} is outside of the Space bounds {self.bounds}"
            )
        region = region.intersection(self.bounds)
        sl = region.to_slices(self.bounds)
        if isinstance(block_or_fn, Block):
            self.contents[sl] = self.ensure_block(block_or_fn)
        else:
            for cube in region.interior_iter():
                b = block_or_fn(cube)
                if b is not None:
                    self.contents[self._rel(cube)] = self.ensure_block(b)
        self.light_dirty[sl] = 255
        self._edit_log = "all"  # bulk edit: everything is dirty
        # Also dirty the one-cube border around the region.
        border = region.expand(1).intersection(self.bounds)
        self.light_dirty[border.to_slices(self.bounds)] = 255

    def extract(self, region: GridAab) -> "Space":
        """Copy a sub-region into a new Space (space.rs extract, returning
        a Space); raises when the region is not inside the bounds."""
        if region.intersection(self.bounds).volume() != region.volume():
            raise IndexError(
                f"extract region {region} is outside of the Space bounds {self.bounds}"
            )
        out = Space(region, physics=self.physics)
        sl = region.to_slices(self.bounds)
        src = self.contents[sl]
        if src.size:
            remap = {}
            for idx in np.unique(src):
                remap[int(idx)] = out.ensure_block(self._palette[int(idx)])
            out.contents = np.vectorize(remap.get, otypes=[np.uint16])(src)
        out.light = self.light[sl].copy()
        out.light_dirty = self.light_dirty[sl].copy()
        return out

    def _mark_light_dirty_around(self, rel):
        x, y, z = rel
        sx, sy, sz = self.contents.shape
        for dx, dy, dz in (
            (0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0),
            (0, 1, 0), (0, 0, -1), (0, 0, 1),
        ):
            nx, ny, nz = x + dx, y + dy, z + dz
            if 0 <= nx < sx and 0 <= ny < sy and 0 <= nz < sz:
                self.light_dirty[nx, ny, nz] = 255

    # -- fast initial lighting ------------------------------------------------

    def fast_evaluate_light(self):
        """Seed light per the reference's per-cube rules (updater.rs:531
        `fast_evaluate_light`); a no-op clear with light physics off."""
        from ..math.faces import PY

        if not self.physics.light_enabled:
            self.light[...] = 0
            self.light_dirty[...] = 0
            return

        opaque_all = np.array([ev.opaque.all() for ev in self._evaluated], bool)
        vis = np.array([ev.visible_or_animated() for ev in self._evaluated], bool)
        grid_opaque = opaque_all[self.contents]
        grid_vis = vis[self.contents]
        # Cube-or-neighbor visibility (6-connected dilation).
        near_vis = grid_vis.copy()
        for axis in range(3):
            shp = [slice(None)] * 3
            shn = [slice(None)] * 3
            shp[axis] = slice(1, None)
            shn[axis] = slice(None, -1)
            near_vis[tuple(shp)] |= grid_vis[tuple(shn)]
            near_vis[tuple(shn)] |= grid_vis[tuple(shp)]
        # "covered": any opaque cube strictly above in the column.
        above = np.zeros_like(grid_opaque)
        above[:, :-1, :] = (
            np.cumsum(grid_opaque[:, ::-1, :], axis=1)[:, ::-1, :][:, 1:, :] > 0
        )
        sky_py = self.physics.sky.block_sky_faces()[PY]
        sky_texel = np.zeros(4, np.uint8)
        sky_texel[:3] = lightpack.np_encode_scalar(sky_py)
        sky_texel[3] = lightpack.STATUS_VISIBLE
        self.light[...] = np.array([0, 0, 0, lightpack.STATUS_NO_RAYS], np.uint8)
        guess = ~grid_opaque & near_vis
        self.light[guess & ~above] = sky_texel
        self.light[guess & above] = np.array(
            [0, 0, 0, lightpack.STATUS_UNINITIALIZED], np.uint8
        )
        self.light[grid_opaque] = np.array([0, 0, 0, lightpack.STATUS_OPAQUE], np.uint8)
        self.light_dirty[...] = 0
        self.light_dirty[guess] = 255

    # -- device snapshot -------------------------------------------------------

    def snapshot(self, pad_palette_to: int = 8, device="cuda") -> SpaceState:
        """Build the tensor SpaceState on `device` (content → device
        handoff). The default is the card; `device="cpu"` asks for the
        CPU."""
        from ..raytrace import accel

        evs = self._evaluated
        p_live = len(evs)
        p = max(pad_palette_to, _round_up(p_live, 8))

        resolution = np.ones(p, np.int32)
        visible = np.zeros(p, bool)
        opaque_faces = np.zeros((p, 6), bool)
        face_colors = np.zeros((p, 7, 4), np.float32)
        light_emission = np.zeros((p, 3), np.float32)
        collision_uniform = np.zeros(p, np.int32)
        voxel_index = np.full(p, -1, np.int32)
        res_log2 = np.zeros(p, np.int32)
        palette_rows = np.zeros((p, 8), np.float32)

        vox_entries = [i for i, ev in enumerate(evs) if ev.resolution > 1]
        max_r = max([evs[i].resolution for i in vox_entries], default=1)
        v = max(1, len(vox_entries))
        vox_rows = np.zeros((v, max_r, max_r, max_r, 8), np.float32)
        # Collision solids are capped at 1/32-cube granularity; finer
        # blocks pool conservatively (solid if ANY fine voxel is).
        col_max = min(max_r, _COLLISION_MAX_RES)
        collision_res = np.ones(p, np.int32)
        vox_solid = np.zeros((v, col_max, col_max, col_max), bool)
        vox_cells = np.zeros((v, max_r, max_r, max_r), np.int32)

        for vi, bi in enumerate(vox_entries):
            ev = evs[bi]
            r = ev.resolution
            voxel_index[bi] = vi
            vox_rows[vi, :r, :r, :r, 0:4] = ev.voxels.color
            vox_rows[vi, :r, :r, :r, 4:7] = ev.voxels.emission
            solid = ev.voxels.collision > 0
            cr = min(r, _COLLISION_MAX_RES)
            if r > cr:
                f = r // cr  # resolutions are powers of two (res_log2)
                solid = solid.reshape(cr, f, cr, f, cr, f).any(axis=(1, 3, 5))
            collision_res[bi] = cr
            vox_solid[vi, :cr, :cr, :cr] = solid
            vvis = (ev.voxels.color[..., 3] > 0) | (ev.voxels.emission != 0).any(-1)
            vskip = accel.np_skip_distance_field(vvis)
            vox_cells[vi, :r, :r, :r] = (
                vvis.astype(np.int32) * accel.VISIBLE_BIT
                | (vskip & accel.SKIP_MASK) << accel.SKIP_SHIFT
            )

        for i, ev in enumerate(evs):
            resolution[i] = ev.resolution
            visible[i] = ev.visible_or_animated()
            opaque_faces[i] = ev.opaque
            face_colors[i, :6] = ev.face_colors
            face_colors[i, 6] = ev.color
            light_emission[i] = ev.light_emission
            collision_uniform[i] = -1 if ev.uniform_collision is None else ev.uniform_collision
            res_log2[i] = int(np.log2(ev.resolution))
            palette_rows[i, 0:4] = ev.voxels.color[0, 0, 0]
            palette_rows[i, 4:7] = ev.voxels.emission[0, 0, 0]

        light_face_rows = np.zeros((p * 6, 8), np.float32)
        for i in range(p_live):
            for f in range(6):
                light_face_rows[i * 6 + f, 0:4] = face_colors[i, f]
                light_face_rows[i * 6 + f, 4] = float(opaque_faces[i, f]) + 2.0 * float(
                    visible[i]
                )
                light_face_rows[i * 6 + f, 5:8] = light_emission[i]

        space_cells = accel.build_trace_cells(
            self.contents.astype(np.int32),
            visible,
            voxel_index >= 0,
            res_log2,
            payload=accel.cell_payload(voxel_index),
        )
        # Brick rows: the space's bricks first, then each voxel entry's.
        cells = np.concatenate(
            [accel.to_bricks(space_cells)] + [accel.to_bricks(vox_cells[vi]) for vi in range(v)],
            axis=0,
        )

        def t(a, dtype=None):
            out = torch.as_tensor(a, device=device)
            return out if dtype is None else out.to(dtype)

        tables = BlockTables(
            resolution=t(resolution),
            visible=t(visible),
            opaque_faces=t(opaque_faces),
            face_colors=t(face_colors),
            light_emission=t(light_emission),
            collision_uniform=t(collision_uniform),
            collision_res=t(collision_res),
            voxel_index=t(voxel_index),
            res_log2=t(res_log2),
            light_face_rows=t(light_face_rows),
            palette_rows=t(palette_rows),
            vox_rows=t(vox_rows),
            vox_solid=t(vox_solid),
        )
        sky = self.physics.sky
        return SpaceState(
            contents=t(self.contents.astype(np.int32)),
            light=t(self.light.copy()),
            light_dirty=t(self.light_dirty.copy()),
            cells=t(cells),
            tables=tables,
            sky_faces=t(sky.block_sky_faces()),
            sky_octants=t(np.asarray(sky.octants, np.float32)),
            sky_mean=t(sky.mean_quantized()),
            lower=tuple(int(v) for v in self.bounds.lower),
            light_max_distance=self.physics.light_max_distance,
            light_enabled=self.physics.light_enabled,
        )

    def absorb(self, state: SpaceState):
        """Copy a state's contents and light back into the host mirror
        (read-back after simulation, for save/load and content edits)."""
        self.contents = state.contents.cpu().numpy().astype(self.contents.dtype)
        self.light = state.light.cpu().numpy().copy()
        self.light_dirty = state.light_dirty.cpu().numpy().copy()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
