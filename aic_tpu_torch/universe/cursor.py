"""Cursor raycast + tools/inventory: player interaction with the world.

Copied from `aic_tpu/universe/cursor.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX. Only the Jetpack
toggle changes, from a JAX `.at[].set` to a tensor copy.

Reference: all-is-cubes/src/character/cursor.rs:109 `Cursor`,
character.rs:307 `Character::click`, inv/tool.rs:31 `Tool`,
inv/inventory.rs:31 `Inventory`.

Clicks are rare host-side events (a few per second at most), so cursor
picking walks the host mirror with the host raycaster; the resulting edits
compile to the same device scatters as any transaction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..block import AIR, Block
from ..math import faces, raycast
from .op import Operation, OperationFailed
from .transaction import SpaceTransaction


@dataclass
class Cursor:
    """cursor.rs:109: the cube the player is pointing at."""

    cube: tuple[int, int, int]
    face: int  # face of `cube` that was hit (entry face, face_entered)
    t_distance: float
    block: Block
    #: World point where the ray entered the cube (cursor.rs point_entered);
    #: None for cursors produced by legacy callers.
    point_entered: Optional[np.ndarray] = None
    #: Distance from the ray origin to point_entered (== t_distance when
    #: the direction was normalized).
    distance_to_point: float = 0.0
    #: The evaluated block at the hit cube (for voxels_bounds etc.).
    evaluated: object = None

    @property
    def preceding_cube(self) -> tuple[int, int, int]:
        """The empty cube in front of the hit face (placement target)."""
        n = faces.FACE_NORMALS[self.face] if self.face < 6 else np.zeros(3, int)
        return tuple(int(c + d) for c, d in zip(self.cube, n))


def cursor_raycast(space, origin, direction, max_distance: float = 10.0) -> Optional[Cursor]:
    """First selectable block along the ray (character.rs cursor logic).

    origin/direction in world coordinates; t limited so reach is
    `max_distance` cubes (direction is normalized internally).
    """
    direction = np.asarray(direction, np.float64)
    n = np.linalg.norm(direction)
    if n == 0:
        return None
    direction = direction / n
    for step in raycast.raycast(origin, direction, bounds=space.bounds, t_max=max_distance):
        ev = space.evaluated_block_at(step.cube)
        if ev.visible and ev.attributes.selectable:
            point = np.asarray(origin, np.float64) + direction * step.t_distance
            return Cursor(
                cube=step.cube,
                face=step.face,
                t_distance=step.t_distance,
                block=space.block_at(step.cube),
                point_entered=point,
                distance_to_point=float(step.t_distance),
                evaluated=ev,
            )
    return None


# -- Tools (inv/tool.rs:31) ---------------------------------------------------


class Tool:
    """Base: use(universe, space_name, cursor) -> SpaceTransaction."""

    def use(self, universe, space_name: str, cursor: Cursor) -> SpaceTransaction:
        raise OperationFailed("tool has no effect")


@dataclass(frozen=True)
class Activate(Tool):
    """Tool::Activate: run the block's activation_action."""

    def use(self, universe, space_name, cursor):
        # Evaluated attributes, not raw: modifiers (Composite) compose
        # activation actions during evaluation (composite.rs:303).
        space = universe.spaces[space_name]
        action = space.evaluated_block_at(cursor.cube).attributes.activation_action
        if action is None:
            raise OperationFailed("block has no activation action")
        return action.apply(space, cursor.cube)


@dataclass(frozen=True)
class RemoveBlock(Tool):
    """Tool::RemoveBlock: delete the targeted block (optionally keeping
    it — inventory pickup lands with stacking support)."""

    keep: bool = True

    def use(self, universe, space_name, cursor):
        return SpaceTransaction.set_cube(cursor.cube, old=cursor.block, new=AIR)


@dataclass(frozen=True)
class PlaceBlock(Tool):
    """Tool::Block / Tool::InfiniteBlocks: place into the empty cube in
    front of the hit face."""

    block: Block
    infinite: bool = True

    def use(self, universe, space_name, cursor):
        space = universe.spaces[space_name]
        target = cursor.preceding_cube
        if not space.bounds.contains_cube(target):
            raise OperationFailed("placement outside bounds")
        return SpaceTransaction.set_cube(target, old=AIR, new=self.block)


@dataclass(frozen=True)
class CopyFromSpace(Tool):
    """Tool::CopyFromSpace: pick the targeted block into the inventory."""

    def use(self, universe, space_name, cursor):
        raise OperationFailed("copy is handled by Inventory.click")


@dataclass(frozen=True)
class CustomTool(Tool):
    """Tool::Custom(Operation)."""

    operation: Operation

    def use(self, universe, space_name, cursor):
        return self.operation.apply(universe.spaces[space_name], cursor.cube)


@dataclass(frozen=True)
class Jetpack(Tool):
    """Tool::Jetpack: toggles the character's flying state (the reference
    attaches a jetpack Behavior; ours flips the Body flag directly —
    applied by `click`, not through a space transaction)."""

    def use(self, universe, space_name, cursor):
        raise OperationFailed("jetpack is handled by click (body state)")


@dataclass(frozen=True)
class PushPull(Tool):
    """Tool::PushPull: move the targeted block one cube away from (push)
    or toward (pull with button 1 → handled by click) the player."""

    pull: bool = False

    def use(self, universe, space_name, cursor):
        space = universe.spaces[space_name]
        away = tuple(
            c - n for c, n in zip(cursor.cube, _face_normal(cursor.face))
        )
        toward = cursor.preceding_cube
        target = toward if self.pull else away
        if not space.bounds.contains_cube(target):
            raise OperationFailed("push target outside bounds")
        if space.block_at(target) is not AIR:
            raise OperationFailed("push target occupied")
        t = SpaceTransaction.set_cube(cursor.cube, old=cursor.block, new=AIR)
        return t.merge(SpaceTransaction.set_cube(target, old=AIR, new=cursor.block))


@dataclass(frozen=True)
class EditBlock(Tool):
    """Tool::EditBlock: swap the targeted block for a modified version
    (here: rotate by the modifier provided — a minimal in-world editor)."""

    modifier: object = None  # a block Modifier to append

    def use(self, universe, space_name, cursor):
        if self.modifier is None:
            raise OperationFailed("no edit configured")
        b = cursor.block
        edited = Block(b.primitive, b.attributes, b.modifiers + (self.modifier,))
        return SpaceTransaction.set_cube(cursor.cube, old=b, new=edited)


def _face_normal(face: int):
    from ..math import faces as _f

    return _f.FACE_NORMALS[face] if face < 6 else (0, 0, 0)


#: StackLimit::Standard (inventory.rs:383); One-limit tools never stack.
STANDARD_STACK_LIMIT = 100


def stack_limit(tool: Tool) -> int:
    """tool.rs:319 stack_limit: only finite placeable blocks stack to
    the standard limit; every other tool is one-per-slot."""
    if isinstance(tool, PlaceBlock) and not tool.infinite:
        return STANDARD_STACK_LIMIT
    return 1


@dataclass
class Stack:
    """inv/inventory.rs Slot::Stack: a tool with a count. Non-infinite
    stacks deplete on use; count 0 empties the slot."""

    tool: Tool
    count: int = 1


def _slot_tool(slot):
    return slot.tool if isinstance(slot, Stack) else slot


def _slot_count(slot):
    if slot is None:
        return 0
    return slot.count if isinstance(slot, Stack) else 1


@dataclass
class Inventory:
    """inv/inventory.rs:31: slots (Tool, Stack, or None=Empty) +
    selection. `fixed` inventories never grow (the reference's slot
    arrays are always fixed-size; growable is our convenience mode for
    the free-editing session)."""

    slots: list = field(default_factory=list)
    selected: int = 0
    fixed: bool = False

    def selected_tool(self) -> Optional[Tool]:
        if 0 <= self.selected < len(self.slots):
            slot = self.slots[self.selected]
            if isinstance(slot, Stack):
                return slot.tool if slot.count > 0 else None
            return slot
        return None

    def consume_selected(self):
        """Deplete one use from the selected slot if it is a finite stack
        (inventory.rs stack decrement)."""
        if 0 <= self.selected < len(self.slots):
            slot = self.slots[self.selected]
            if isinstance(slot, Stack):
                slot.count -= 1
                if slot.count <= 0:
                    self.slots[self.selected] = None

    def count_of(self, tool: Tool) -> int:
        """Total count of `tool` across all slots (inventory.rs
        count_of)."""
        return sum(
            _slot_count(s) for s in self.slots if s is not None and _slot_tool(s) == tool
        )

    def add(self, tool: Tool, count: int = 1) -> bool:
        """Add with reference stacking rules (inventory.rs unload_to):
        fill existing matching stacks up to the tool's stack limit, then
        the first empty slot; growable inventories append. Returns False
        (nothing placed) when a fixed inventory is full."""
        limit = stack_limit(tool)
        remaining = count
        for slot in self.slots:
            if remaining == 0:
                return True
            if isinstance(slot, Stack) and slot.tool == tool and slot.count < limit:
                moved = min(remaining, limit - slot.count)
                slot.count += moved
                remaining -= moved
        for i, slot in enumerate(self.slots):
            if remaining == 0:
                return True
            if slot is None:
                moved = min(remaining, limit)
                self.slots[i] = Stack(tool, moved)
                remaining -= moved
        if remaining and not self.fixed:
            while remaining:
                moved = min(remaining, limit)
                self.slots.append(Stack(tool, moved))
                remaining -= moved
        return remaining == 0


class InventoryConflict(Exception):
    """inventory.rs InventoryMismatch: Full / OutOfBounds /
    UnexpectedSlot."""


@dataclass(frozen=True)
class InventoryTransaction:
    """inventory.rs:403 InventoryTransaction: atomic insert + per-slot
    replace with check-then-commit. `check` builds the whole would-be
    slot list (the reference's "simplest bulletproof algorithm"),
    `execute` commits it and returns the changed slot indices
    (InventoryChange)."""

    insert: tuple = ()
    replace: tuple = ()  # of (index, old_slot, new_slot)

    @staticmethod
    def insert_items(items) -> "InventoryTransaction":
        """insert() constructor: empty items are dropped."""
        norm = []
        for it in items:
            if it is None:
                continue
            st = it if isinstance(it, Stack) else Stack(it, 1)
            if st.count > 0:
                norm.append(st)
        return InventoryTransaction(insert=tuple(norm))

    @staticmethod
    def replace_slot(index: int, old, new) -> "InventoryTransaction":
        return InventoryTransaction(replace=((index, old, new),))

    def is_empty(self) -> bool:
        return not self.insert and not self.replace

    def merge(self, other: "InventoryTransaction") -> "InventoryTransaction":
        """Merge (transaction.rs Merge): replaces of the same slot
        conflict; inserts concatenate."""
        mine = {i for i, _, _ in self.replace}
        for i, _, _ in other.replace:
            if i in mine:
                raise InventoryConflict(f"both transactions replace slot {i}")
        return InventoryTransaction(
            insert=self.insert + other.insert,
            replace=self.replace + other.replace,
        )

    def check(self, inventory: Inventory):
        """Returns (new_slots, changed_indices) or raises
        InventoryConflict."""
        slots = list(inventory.slots)
        changed = []
        for index, old, new in self.replace:
            if not (0 <= index < len(slots)):
                raise InventoryConflict("out of bounds")
            if not _slots_equal(slots[index], old):
                raise InventoryConflict(f"unexpected slot {index}")
            slots[index] = new
            changed.append(index)
        for stack in self.insert:
            remaining = stack.count
            limit = stack_limit(stack.tool)
            for i, slot in enumerate(slots):
                if remaining == 0:
                    break
                if slot is None:
                    moved = min(remaining, limit)
                    slots[i] = Stack(stack.tool, moved)
                    remaining -= moved
                    changed.append(i)
                elif (
                    isinstance(slot, Stack)
                    and slot.tool == stack.tool
                    and slot.count < limit
                ):
                    moved = min(remaining, limit - slot.count)
                    slots[i] = Stack(slot.tool, slot.count + moved)
                    remaining -= moved
                    changed.append(i)
            if remaining:
                raise InventoryConflict("inventory full")
        return slots, changed

    def execute(self, inventory: Inventory):
        """check + commit; returns the changed slot indices."""
        slots, changed = self.check(inventory)
        inventory.slots[:] = slots
        return changed


def _slots_equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    return (_slot_tool(a) == _slot_tool(b)) and (_slot_count(a) == _slot_count(b))


def free_editing_inventory() -> Inventory:
    """content free_editing_starter_inventory analog: activate, delete,
    copy, plus nothing else until block catalogs are linked in."""
    return Inventory(slots=[Activate(), RemoveBlock(), CopyFromSpace()])


def click(universe, character, cursor: Optional[Cursor], button: int = 0) -> bool:
    """character.rs:307 Character::click: dispatch the selected tool (or
    Activate for button 1) at the cursor; commits on success. Returns
    whether an edit happened."""
    if cursor is None:
        return False
    inv = getattr(character, "inventory_obj", None)
    if inv is None:
        inv = free_editing_inventory()
        character.inventory_obj = inv
    tool = Activate() if button == 1 else inv.selected_tool()
    if tool is None:
        return False
    space_name = character.space_name
    if isinstance(tool, Jetpack):
        # Body-state tool: toggle flying (inv/tool.rs Jetpack behavior).
        i = character.body_index
        flying = universe.bodies.flying.clone()
        flying[i] = ~flying[i]
        universe.bodies = __import__("dataclasses").replace(universe.bodies, flying=flying)
        return True
    if isinstance(tool, CopyFromSpace):
        inv.add(PlaceBlock(cursor.block, infinite=True))
        inv.selected = len(inv.slots) - 1
        return True
    try:
        txn = tool.use(universe, space_name, cursor)
    except OperationFailed:
        return False
    try:
        txn.check(universe.spaces[space_name])
    except Exception:
        return False
    new_state = txn.commit(universe.spaces[space_name], universe.states.get(space_name))
    if new_state is None:
        universe.resnapshot(space_name)
    else:
        universe.states[space_name] = new_state
    # Standard interaction fluff (fluff.rs BlockPlaced/BlockDestroyed).
    from .transaction import Fluff

    universe._emit_fluff(txn.fluff)
    # TakeInventory-style operations deposit slots into the actor
    # (op.rs's InventoryTransaction leg).
    for slot in getattr(txn, "inventory_insert", ()):
        if slot is None:
            continue
        if isinstance(slot, Stack):
            inv.add(slot.tool, slot.count)
        else:
            inv.add(slot)
    if isinstance(tool, PlaceBlock):
        universe._emit_fluff([Fluff("Place", cursor.preceding_cube)])
        if not tool.infinite:
            inv.consume_selected()
    elif isinstance(tool, RemoveBlock):
        universe._emit_fluff([Fluff("Destroy", cursor.cube)])
        if tool.keep:
            inv.add(PlaceBlock(cursor.block, infinite=False))
    elif isinstance(tool, Activate) or button == 1:
        universe._emit_fluff([Fluff("Activate", cursor.cube)])
    return True


def tool_icon(tool) -> "Block | None":
    """Icon block of a tool slot (inv/tool.rs icon()): PlaceBlock shows
    its block; other tools have no intrinsic block icon (the reference's
    icon_only_if_intrinsic, inv_in_block usage at modifier/mod.rs:766)."""
    if isinstance(tool, Stack):
        return tool_icon(tool.tool) if tool.count > 0 else None
    if isinstance(tool, PlaceBlock):
        return tool.block
    return None


def inventory_modifier(inventory: "Inventory"):
    """Build the block Modifier rendering `inventory` inside a block
    (Modifier::Inventory, block/modifier/mod.rs:106): slots map to their
    tools' icon blocks."""
    from ..block import InventoryModifier

    return InventoryModifier(icons=tuple(tool_icon(s) for s in inventory.slots))
