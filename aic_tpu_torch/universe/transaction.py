"""Transactions: atomic check-then-commit world mutations.

Port of `aic_tpu/universe/transaction.py` (the reference's
transaction.rs:45 `Transaction`, :167 `Merge`; space/space_txn.rs:34
`SpaceTransaction`, :562 `CubeTransaction`): conflict-free batching of
edits, so that game mechanics cannot depend on update order. The host
code is copied unchanged; a commit's device half is one batched scatter
onto the state's device (`space.state.scatter_set_cubes`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class TransactionConflict(Exception):
    pass


class PreconditionFailed(Exception):
    pass


@dataclass
class CubeEdit:
    """CubeTransaction (space_txn.rs:562): optional old-block precondition
    + optional new block.

    `conserved` mirrors CubeTransaction::conserved (space_txn.rs default
    true): a conserved write represents a block *moved into* the cube, so
    two conserved writes may not merge even if they write the same block —
    merging would destroy one of the moved blocks. Non-conserved writes
    (e.g. paint/fill effects) merge when equal."""

    old: Optional[object] = None  # Block or None = don't care
    new: Optional[object] = None  # Block or None = no change
    conserved: bool = True


@dataclass(frozen=True)
class Fluff:
    """Momentary sound/particle effect broadcast (fluff.rs:35)."""

    name: str
    position: tuple = (0, 0, 0)


@dataclass
class SpaceTransaction:
    """Per-cube CAS edits on one Space (space_txn.rs:34), plus fluff
    emission (CubeTransaction::fluff)."""

    cubes: dict = field(default_factory=dict)  # (x,y,z) -> CubeEdit
    fluff: list = field(default_factory=list)  # [Fluff]
    #: Slots to insert into the acting character's inventory on commit
    #: (op.rs TakeInventory's InventoryTransaction leg).
    inventory_insert: list = field(default_factory=list)

    @staticmethod
    def set_cube(cube, old=None, new=None, conserved=True) -> "SpaceTransaction":
        t = SpaceTransaction()
        t.cubes[tuple(int(c) for c in cube)] = CubeEdit(
            old=old, new=new, conserved=conserved
        )
        return t

    @staticmethod
    def emitting_fluff(cube, name: str) -> "SpaceTransaction":
        """A transaction that only broadcasts fluff (space_txn fluff)."""
        t = SpaceTransaction()
        t.fluff.append(Fluff(name=name, position=tuple(int(c) for c in cube)))
        return t

    @staticmethod
    def filling(region, block) -> "SpaceTransaction":
        t = SpaceTransaction()
        for cube in region.interior_iter():
            t.cubes[cube] = CubeEdit(new=block)
        return t

    def merge(self, other: "SpaceTransaction") -> "SpaceTransaction":
        """Merge (transaction.rs:167 Merge; space_txn.rs:680 CubeTransaction
        check_merge): two edits of the same cube conflict when their `old`
        preconditions differ, or when both write `new` unless both writes
        are non-conserved and equal (the conserved rule protects block
        conservation: two moves into one cube must not collapse into one)."""
        out = SpaceTransaction(
            cubes=dict(self.cubes),
            fluff=self.fluff + other.fluff,
            inventory_insert=self.inventory_insert + other.inventory_insert,
        )
        for cube, edit in other.cubes.items():
            if cube in out.cubes:
                mine = out.cubes[cube]
                if (
                    edit.old is not None
                    and mine.old is not None
                    and edit.old != mine.old
                ):
                    raise TransactionConflict(
                        f"conflicting old preconditions at {cube}"
                    )
                if edit.new is not None and mine.new is not None:
                    if (
                        edit.new != mine.new
                        or mine.conserved
                        or edit.conserved
                    ):
                        raise TransactionConflict(f"conflicting writes at {cube}")
                merged = CubeEdit(
                    old=mine.old if mine.old is not None else edit.old,
                    new=mine.new if mine.new is not None else edit.new,
                    conserved=(
                        mine.conserved if mine.new is not None else edit.conserved
                    ),
                )
                out.cubes[cube] = merged
            else:
                out.cubes[cube] = edit
        return out

    def check(self, space) -> None:
        """Check preconditions against the host mirror (space_txn commit
        protocol: check → CommitCheck → commit)."""
        for cube, edit in self.cubes.items():
            if not space.bounds.contains_cube(cube):
                # space_txn.rs:801-838: an out-of-bounds *conserved* set
                # or any out-of-bounds compare fails; a non-conserved
                # write out of bounds is allowed and silently skipped.
                if edit.old is not None:
                    raise PreconditionFailed(f"cube {cube} outside bounds")
                if edit.new is not None and edit.conserved:
                    raise PreconditionFailed(f"cube {cube} outside bounds")
                continue
            if edit.old is not None and space.block_at(cube) != edit.old:
                raise PreconditionFailed(f"cube {cube} changed")

    def commit(self, space, state=None):
        """Apply to the host Space and, if given, the device state.

        Returns the updated device state (or None). Palette growth happens
        here on host (content-time); if the palette's device tables are
        stale (new entries beyond the padded size), the caller must
        re-snapshot — signaled by returning None for `state`.
        """
        if not self.cubes:
            return state
        positions = []
        new_idx = []
        pal_before = space.palette_len()
        for cube, edit in self.cubes.items():
            if edit.new is None:
                continue
            if not space.bounds.contains_cube(cube):
                continue  # allowed only for non-conserved writes (check)
            idx = space.ensure_block(edit.new)
            rel = space._rel(cube)
            space.contents[rel] = idx
            space._mark_light_dirty_around(rel)
            positions.append(rel)
            new_idx.append(idx)
        if state is None:
            return None
        if space.palette_len() != pal_before:
            # ANY palette growth invalidates the device tables — entries
            # interned above have air rows in `state.tables`, so a
            # scatter against the old tables would render/relight the new
            # blocks as air. The caller must resnapshot (content-time).
            return None
        if not positions:
            return state
        import torch

        from ..space.state import scatter_set_cubes

        dev = state.contents.device
        return scatter_set_cubes(
            state,
            torch.as_tensor(np.array(positions, np.int64), device=dev),
            torch.as_tensor(np.array(new_idx, np.int32), device=dev),
        )

    def execute(self, space, state=None):
        self.check(space)
        return self.commit(space, state)


@dataclass
class UniverseTransaction:
    """Atomic multi-member mutation (universe/universe_txn.rs:333):
    per-space transactions plus member insertions, checked together and
    committed together (check → commit protocol, transaction.rs:45)."""

    spaces: dict = field(default_factory=dict)  # space name -> SpaceTransaction
    inserts: dict = field(default_factory=dict)  # member name -> Space

    @staticmethod
    def inserting(name: str, space) -> "UniverseTransaction":
        """universe_txn insert: add a named Space member on commit."""
        return UniverseTransaction(inserts={name: space})

    def merge(self, other: "UniverseTransaction") -> "UniverseTransaction":
        out = UniverseTransaction(spaces=dict(self.spaces), inserts=dict(self.inserts))
        for name, txn in other.spaces.items():
            out.spaces[name] = out.spaces[name].merge(txn) if name in out.spaces else txn
        for name, sp in other.inserts.items():
            if name in out.inserts and out.inserts[name] is not sp:
                raise TransactionConflict(f"conflicting member insert {name!r}")
            out.inserts[name] = sp
        return out

    def check(self, universe) -> None:
        for name in self.inserts:
            if name in universe.spaces:
                raise PreconditionFailed(f"member {name!r} already exists")
        for name, txn in self.spaces.items():
            if name not in universe.spaces and name not in self.inserts:
                raise PreconditionFailed(f"no member {name!r}")
            if name in universe.spaces:
                txn.check(universe.spaces[name])

    def execute(self, universe) -> int:
        """Check everything, then commit everything (all-or-nothing at
        the check stage, like the reference's two-phase protocol)."""
        self.check(universe)
        edits = 0
        for name, sp in self.inserts.items():
            universe.insert_space(name, sp)
        for name, txn in self.spaces.items():
            edits += universe._commit(name, txn)
        return edits
