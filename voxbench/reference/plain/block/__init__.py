"""Layer 1a: block data model + host evaluation (reference: all-is-cubes/src/block).

Copied unchanged from `aic_tpu/block/__init__.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.
"""

from .eval import AIR_EVALUATED, EvaluatedBlock, Evoxels, evaluate
from .model import (
    AIR,
    AirPrimitive,
    Atom,
    Block,
    BlockAttributes,
    BlockDef,
    COLLISION_HARD,
    COLLISION_NONE,
    Composite,
    IconRow,
    Indirect,
    InvInBlock,
    InventoryModifier,
    Move,
    Quote,
    Recur,
    Rotate,
    SetAttributes,
    Tag,
    TextPrimitive,
    Zoom,
    from_color,
)

__all__ = [
    "AIR",
    "AirPrimitive",
    "AIR_EVALUATED",
    "Atom",
    "Block",
    "BlockAttributes",
    "BlockDef",
    "COLLISION_HARD",
    "COLLISION_NONE",
    "Composite",
    "IconRow",
    "InvInBlock",
    "InventoryModifier",
    "EvaluatedBlock",
    "Evoxels",
    "Indirect",
    "Move",
    "Quote",
    "Recur",
    "Rotate",
    "SetAttributes",
    "Tag",
    "TextPrimitive",
    "Zoom",
    "evaluate",
    "from_color",
]
