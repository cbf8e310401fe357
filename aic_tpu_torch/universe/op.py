"""Operations: declarative world-edit templates.

Port of `aic_tpu/universe/op.py`, copied (the reference's
`Operation`, all-is-cubes/src/op.rs:39-120): relative-coordinate edit
recipes used by block tick actions, activation actions and tools. An
operation applied at a cube yields a SpaceTransaction (or raises
OperationFailed).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..block import AIR
from .transaction import SpaceTransaction


class OperationFailed(Exception):
    pass


class Operation:
    def apply(self, space, cube) -> SpaceTransaction:
        raise NotImplementedError


@dataclass(frozen=True)
class Become(Operation):
    """op.rs Operation::Become: replace this cube with `block`
    (preconditioned on the current block, making it a CAS)."""

    block: object

    def apply(self, space, cube):
        current = space.block_at(cube)
        if current == self.block:
            raise OperationFailed("already that block")
        return SpaceTransaction.set_cube(cube, old=current, new=self.block)


@dataclass(frozen=True)
class DestroyTo(Operation):
    """op.rs Operation::DestroyTo: like Become but without precondition
    (used by destruction tools)."""

    block: object = AIR

    def apply(self, space, cube):
        # Destruction is non-conserved (op.rs destroy_to_txn): two
        # destroys of one cube may merge.
        return SpaceTransaction.set_cube(cube, new=self.block, conserved=False)


@dataclass(frozen=True)
class Alt(Operation):
    """op.rs Operation::Alt: first applicable alternative wins."""

    ops: tuple

    def apply(self, space, cube):
        for op in self.ops:
            try:
                return op.apply(space, cube)
            except OperationFailed:
                continue
        raise OperationFailed("no alternative applicable")


@dataclass(frozen=True)
class Neighbors(Operation):
    """op.rs Operation::Neighbors: apply sub-operations at relative
    offsets; all must succeed and merge conflict-free."""

    ops: tuple  # of (offset (3,), Operation)

    def apply(self, space, cube):
        txn = SpaceTransaction()
        for offset, op in self.ops:
            target = tuple(c + o for c, o in zip(cube, offset))
            if not space.bounds.contains_cube(target):
                raise OperationFailed(f"neighbor {target} out of bounds")
            txn = txn.merge(op.apply(space, target))
        return txn


@dataclass(frozen=True)
class StartMove(Operation):
    """op.rs:97/:251 Operation::StartMove: begin a Move animation. The
    targeted cube's block gains the Move modifier; the adjacent air cube
    it moves into gains the complement (move.rs:58 into_paired), so the
    two halves animate as one block crossing the boundary."""

    move: object  # block.Move modifier

    def apply(self, space, cube):
        from ..block import Move
        from ..math import faces

        n = faces.FACE_NORMALS[self.move.face]
        adjacent = tuple(int(c + d) for c, d in zip(cube, n))
        if not space.bounds.contains_cube(adjacent):
            raise OperationFailed("move destination out of bounds")
        if space.block_at(adjacent) != AIR:
            raise OperationFailed("move destination occupied")
        target_block = space.block_at(cube)
        complement = Move(
            face=int(faces.OPPOSITE[self.move.face]),
            distance=256 - self.move.distance,
            velocity=-self.move.velocity,
        )
        out = SpaceTransaction.set_cube(
            cube, old=target_block, new=target_block.with_modifier(self.move)
        )
        return out.merge(
            SpaceTransaction.set_cube(
                adjacent, old=AIR, new=target_block.with_modifier(complement)
            )
        )


@dataclass(frozen=True)
class AddModifiers(Operation):
    """op.rs Operation::AddModifiers: append modifiers to the targeted
    block. Rotate uses Block.rotate (so rotationally symmetric blocks —
    e.g. AIR — are left untouched and the transaction is empty)."""

    modifiers: tuple

    def apply(self, space, cube):
        from ..block import Rotate

        current = space.block_at(cube)
        new = current
        for m in self.modifiers:
            if isinstance(m, Rotate):
                new = new.rotate(m.rotation)
            else:
                new = new.with_modifier(m)
        if new == current:
            return SpaceTransaction()
        return SpaceTransaction.set_cube(cube, old=current, new=new)


@dataclass(frozen=True)
class TakeInventory(Operation):
    """op.rs Operation::TakeInventory: move the targeted block's attached
    inventory (InventoryModifier slots) into the actor's inventory via
    the transaction's `inventory_insert` channel. With `destroy_if_empty`
    the emptied block becomes AIR; otherwise it keeps an empty
    inventory modifier."""

    destroy_if_empty: bool = True

    def apply(self, space, cube):
        from ..block import InventoryModifier
        from dataclasses import replace as dc_replace

        current = space.block_at(cube)
        inv_mods = [
            (i, m)
            for i, m in enumerate(current.modifiers)
            if isinstance(m, InventoryModifier)
        ]
        if not inv_mods:
            raise OperationFailed("block has no inventory")
        idx, mod = inv_mods[0]
        slots = [s for s in mod.slots if s is not None]
        if not slots:
            raise OperationFailed("block inventory is empty")
        if self.destroy_if_empty:
            new = AIR
        else:
            emptied = InventoryModifier(icons=(), slots=(None,) * len(mod.slots))
            mods = list(current.modifiers)
            mods[idx] = emptied
            new = dc_replace(current, modifiers=tuple(mods))
        txn = SpaceTransaction.set_cube(cube, old=current, new=new)
        txn.inventory_insert.extend(slots)
        return txn


@dataclass(frozen=True)
class MoveInwards(Operation):
    """op.rs Operation::MoveInwards: start this block moving (round 1:
    moves the block one cube along `face`, preserving the source as AIR —
    the sub-cube Move-modifier animation lands with animated blocks)."""

    face: int

    def apply(self, space, cube):
        from ..math import faces

        n = faces.FACE_NORMALS[self.face]
        target = tuple(c + int(d) for c, d in zip(cube, n))
        if not space.bounds.contains_cube(target):
            raise OperationFailed("move target out of bounds")
        if space.block_at(target) != AIR:
            raise OperationFailed("move target occupied")
        block = space.block_at(cube)
        return SpaceTransaction.set_cube(cube, old=block, new=AIR).merge(
            SpaceTransaction.set_cube(target, old=AIR, new=block)
        )
