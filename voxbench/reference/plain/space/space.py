"""Host Space container and palette: what decoding a saved world needs.

Copied from the port's `space/space.py`, cut to the bounds, physics,
cube grid and palette (dedup and block evaluation) that loading a world
fills in; the reference computes its light itself
(`voxbench/reference/light.py`).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Optional

import numpy as np

from ..block import AIR, AIR_EVALUATED, Block, EvaluatedBlock, evaluate
from ..math.grid import GridAab
from .sky import Sky

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
    def __init__(self, bounds: GridAab, physics: Optional[SpacePhysics] = None):
        self.bounds = bounds
        self.physics = physics or SpacePhysics()
        self._palette: list[Block] = [AIR]
        self._evaluated: list[EvaluatedBlock] = [AIR_EVALUATED]
        self._block_to_index: dict = {AIR: 0}
        self.contents = np.zeros(bounds.size, np.uint16)

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
        if len(self._palette) >= MAX_PALETTE:
            raise ValueError("palette full (65536 blocks in use)")
        self._palette.append(block)
        self._evaluated.append(evaluate(block))
        idx = len(self._palette) - 1
        self._block_to_index[block] = idx
        return idx

    def evaluated(self, index: int) -> EvaluatedBlock:
        return self._evaluated[index]
