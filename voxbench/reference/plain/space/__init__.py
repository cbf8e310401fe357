"""The host Space and its sky (copied, cut to decoding)."""

from .sky import DAY_SKY_COLOR, Sky
from .space import Space, SpacePhysics

__all__ = ["DAY_SKY_COLOR", "Sky", "Space", "SpacePhysics"]
