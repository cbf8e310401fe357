"""Layer 1e: Universe container, transactions, operations, behaviors and
the step loop (port of `aic_tpu/universe`; the cursor tools and sound
members come later, ROADMAP A7)."""

from .op import (
    AddModifiers,
    Alt,
    Become,
    DestroyTo,
    MoveInwards,
    Neighbors,
    Operation,
    OperationFailed,
    StartMove,
    TakeInventory,
)
from .transaction import (
    CubeEdit,
    Fluff,
    PreconditionFailed,
    SpaceTransaction,
    TransactionConflict,
    UniverseTransaction,
)
from .universe import Behavior, Character, Clock, Tick, Universe, UniverseStepInfo

__all__ = [
    "AddModifiers", "Alt", "Become", "DestroyTo", "MoveInwards",
    "Neighbors", "Operation", "StartMove", "TakeInventory",
    "OperationFailed", "CubeEdit", "Fluff", "PreconditionFailed", "SpaceTransaction",
    "TransactionConflict", "UniverseTransaction", "Behavior", "Character",
    "Clock", "Tick", "Universe", "UniverseStepInfo",
]
