"""Layer 1b: Space — the world voxel array (port of `aic_tpu/space`)."""

from .sky import DAY_SKY_COLOR, Sky
from .space import Space, SpacePhysics
from .state import (
    BlockTables,
    SpaceState,
    lookup_contents,
    lookup_light,
    scatter_set_cubes,
    state_from_numpy,
    state_to_numpy,
)

__all__ = [
    "DAY_SKY_COLOR",
    "Sky",
    "Space",
    "SpacePhysics",
    "BlockTables",
    "SpaceState",
    "lookup_contents",
    "lookup_light",
    "scatter_set_cubes",
    "state_from_numpy",
    "state_to_numpy",
]
