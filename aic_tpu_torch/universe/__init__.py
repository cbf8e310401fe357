"""Layer 1e: Universe container, transactions, operations, behaviors, the
step loop and the cursor tools (port of `aic_tpu/universe`; the sound
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
from .cursor import (
    Activate,
    CopyFromSpace,
    Cursor,
    CustomTool,
    Inventory,
    InventoryConflict,
    InventoryTransaction,
    PlaceBlock,
    RemoveBlock,
    Stack,
    Tool,
    click,
    cursor_raycast,
    free_editing_inventory,
    stack_limit,
)

__all__ = [
    "AddModifiers", "Alt", "Become", "DestroyTo", "MoveInwards",
    "Neighbors", "Operation", "StartMove", "TakeInventory",
    "OperationFailed", "CubeEdit", "Fluff", "PreconditionFailed", "SpaceTransaction",
    "TransactionConflict", "UniverseTransaction", "Behavior", "Character",
    "Clock", "Tick", "Universe", "UniverseStepInfo",
    "Activate", "CopyFromSpace", "Cursor", "CustomTool", "Inventory",
    "InventoryConflict", "InventoryTransaction", "PlaceBlock",
    "RemoveBlock", "Stack", "Tool", "click", "cursor_raycast",
    "free_editing_inventory", "stack_limit",
]
