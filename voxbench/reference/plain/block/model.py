"""Block data model (layer 1, host side).

Copied unchanged from `aic_tpu/block/model.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

Equivalent of the reference's `Block = Primitive + Vec<Modifier>`
(all-is-cubes/src/block.rs:94,118-185; block/modifier/mod.rs:71-108).

Blocks are *content-time* objects: they are defined on the host, evaluated
(eval.py) into dense voxel arrays, and only those arrays ever reach the TPU.
This mirrors the reference's split where `Block::evaluate` runs rarely (on
content changes) while the per-frame loops consume only `EvaluatedBlock`
data.

Primitives: AIR, Atom, Recur, Indirect (via BlockDef), Text (stub for now).
Modifiers: Rotate, Composite, Zoom, Move, Quote, SetAttributes, Inventory
(the last is a stub in round 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Optional

import numpy as np

from ..math import grid

# Collision classes (reference block::BlockCollision)
COLLISION_NONE = 0
COLLISION_HARD = 1


@dataclass(frozen=True)
class BlockAttributes:
    """Subset of reference `BlockAttributes` (block/attributes.rs).

    `tick_action`/`activation_action` hold `Operation`s (universe/op.py)
    plus a schedule period in ticks.
    """

    display_name: str = "<unnamed>"
    selectable: bool = True
    # Operation to perform on a schedule (reference `tick_action`).
    tick_action: Optional[Any] = None
    tick_period: int = 1
    # Operation performed when the block is activated by a tool.
    activation_action: Optional[Any] = None
    # Whether renderers should expect this block to change appearance
    # without palette changes (reference AnimationHint::might_become_visible
    # feeds visible_or_animated, evaluated.rs:252).
    animated: bool = False
    rotation_rule: str = "never"  # "never" | "attach"
    #: Tags attached via the Tag modifier (tag.rs) — matched by Operations.
    tags: tuple = ()
    #: How an attached Inventory modifier renders inside the block
    #: (inv/inv_in_block.rs InvInBlock); EMPTY → inventory invisible.
    inventory: "InvInBlock" = None  # default set after InvInBlock defined
    #: Ambient sound spectrum: 20 per-band noise gains
    #: (sound/ambient.rs Band::COUNT; schema AmbientSoundV1.noise_bands),
    #: or None for silence.
    ambient_sound: tuple = None


DEFAULT_ATTRIBUTES = BlockAttributes()


class Primitive:
    """Marker base class for block primitives (block.rs:118)."""


@dataclass(frozen=True)
class AirPrimitive(Primitive):
    """The ubiquitous empty block (block.rs Primitive::Air)."""


@dataclass(frozen=True)
class Atom(Primitive):
    """A uniform unit cube of material (block.rs Primitive::Atom).

    color: linear RGBA (straight alpha); emission: linear RGB luminance
    emitted by a unit-thickness layer (block::Atom::emission semantics).
    """

    color: tuple[float, float, float, float]
    emission: tuple[float, float, float] = (0.0, 0.0, 0.0)
    collision: int = COLLISION_HARD


@dataclass(frozen=True)
class Recur(Primitive):
    """Block defined by voxels drawn from a region of a Space
    (block.rs Primitive::Recur {space, offset, resolution})."""

    space: Any  # aic_tpu.space.Space (kept loose to avoid layer cycle)
    resolution: int = 16
    offset: tuple[int, int, int] = (0, 0, 0)

    def __hash__(self):
        return hash((id(self.space), self.resolution, self.offset))


@dataclass(frozen=True)
class Indirect(Primitive):
    """Reference to a named BlockDef (block.rs Primitive::Indirect)."""

    block_def: "BlockDef"

    def __hash__(self):
        return hash(id(self.block_def))


@dataclass(frozen=True)
class TextPrimitive(Primitive):
    """Voxel text (block/text.rs Primitive::Text).

    Two rendering paths:
    - font="pil" (legacy deviation): the string is rasterized in PIL's
      default font, as `aic_tpu` draws it, composed glyph by glyph from
      the port's vendored glyph table (text/font.py; no PIL at run time),
      and `tile` selects the resolution² window — kept for existing
      content and saves.
    - font in {"system16", "body-text"}: full-fidelity layout through
      text/layout.py — the reference's own glyph atlases, Positioning
      (x, line_y, z per positioning.rs), voxel-scale layout bounds, and
      optional 8-neighborhood outline (font.rs brush). `tile`+`tile_z`
      are the Primitive::Text multiblock offset.
    """

    text: str
    resolution: int = 16
    color: tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    tile: tuple[int, int] = (0, 0)
    depth: int = 1  # voxel thickness of the glyph slab (pil path)
    font: str = "pil"
    positioning: Optional[tuple] = None  # (x, line_y, z) variant names
    layout_lower: Optional[tuple] = None
    layout_size: Optional[tuple] = None
    outline_color: Optional[tuple] = None
    tile_z: int = 0


@dataclass(frozen=True)
class IconRow:
    """Positioning of one row of inventory icons (inv_in_block.rs:59)."""

    first_slot: int
    count: int
    origin: tuple[int, int, int]
    stride: tuple[int, int, int]


@dataclass(frozen=True)
class InvInBlock:
    """Configuration for rendering a block's inventory inside the block
    (inv/inv_in_block.rs:37): slot count, icon scale-down factor, the
    resolution icon positions are expressed in, and the icon rows."""

    inventory_size: int = 0
    icon_scale: int = 1
    render_resolution: int = 1
    icon_rows: tuple[IconRow, ...] = ()

    def icon_size_in_resolution(self) -> int:
        return max(self.render_resolution // self.icon_scale, 1)

    def icon_positions(self, inventory_size: int):
        """Yield (slot_index, lower_bounds (3,)) for visible icons
        (inv_in_block.rs:176-219); bounds outside the block are skipped."""
        size = self.icon_size_in_resolution()
        rr = self.render_resolution
        for row in self.icon_rows:
            for sub in range(row.count):
                slot = row.first_slot + sub
                if slot >= inventory_size:
                    break
                lower = tuple(
                    row.origin[a] + row.stride[a] * sub for a in range(3)
                )
                if all(lower[a] + size > 0 and lower[a] < rr for a in range(3)):
                    yield slot, lower

    @staticmethod
    def default_for_size(inventory_size: int) -> "InvInBlock":
        """A row of up to 4 quarter-scale icons along the block's front
        bottom edge (the reference demo configuration's shape)."""
        return InvInBlock(
            inventory_size=inventory_size,
            icon_scale=4,
            render_resolution=16,
            icon_rows=(
                IconRow(first_slot=0, count=4, origin=(0, 0, 12), stride=(4, 0, 0)),
            ),
        )


INV_IN_BLOCK_EMPTY = InvInBlock()


class Modifier:
    """Marker base class for block modifiers (block/modifier/mod.rs:71)."""


@dataclass(frozen=True)
class InventoryModifier(Modifier):
    """Attach an inventory to a block (block/modifier/mod.rs:106
    Modifier::Inventory). `icons` holds the icon Block of each occupied
    slot (None = empty slot); rendering follows the block's
    `attributes.inventory` InvInBlock configuration. `slots` carries the
    actual slot contents (inv/inventory.rs slots) so operations like
    TakeInventory can move them."""

    icons: tuple = ()
    slots: tuple = ()

    def __hash__(self):
        return hash((tuple(id(i) for i in self.icons), tuple(id(s) for s in self.slots)))


@dataclass(frozen=True)
class Rotate(Modifier):
    """Rotate the block by one of the 48 grid rotations
    (block/modifier: Modifier::Rotate)."""

    rotation: int  # index into math.grid.ROTATION_MATRICES


@dataclass(frozen=True)
class Composite(Modifier):
    """Combine with another block voxel-by-voxel
    (block/modifier/composite.rs). `operator` ∈ {'over', 'in', 'out',
    'atop'} — the reference's CompositeOperator set (Porter–Duff)."""

    source: "Block"
    operator: str = "over"
    reverse: bool = False

    def __hash__(self):
        return hash((id(self.source), self.operator, self.reverse))


@dataclass(frozen=True)
class Zoom(Modifier):
    """Magnify 1/scale portion of the block (block/modifier/zoom.rs).
    `offset` selects the sub-cube: each component in [0, scale)
    (zoom.rs construction_out_of_range_* tests)."""

    scale: int
    offset: tuple[int, int, int]

    def __post_init__(self):
        for o in self.offset:
            if not 0 <= o < self.scale:
                raise ValueError(
                    f"Zoom offset {tuple(self.offset)} out of bounds for {self.scale}"
                )


@dataclass(frozen=True)
class Move(Modifier):
    """Displace block contents with cropping (block/modifier/move.rs).

    distance is in 1/256ths of a cube along `face`.
    """

    face: int
    distance: int
    velocity: int = 0


@dataclass(frozen=True)
class Quote(Modifier):
    """Suppress all behaviors (block/modifier/quote.rs); used by tools to
    carry blocks inertly. Evaluation strips tick/activation actions."""

    suppress_ambient: bool = False


@dataclass(frozen=True)
class Tag(Modifier):
    """Attach a tag for Operation/tool matching (tag.rs + block Tag
    modifier). Purely semantic: no effect on voxels."""

    name: str


@dataclass(frozen=True)
class SetAttributes(Modifier):
    attributes: BlockAttributes


@dataclass(frozen=True)
class Block:
    """A placeable block: primitive + modifier stack (block.rs:94)."""

    primitive: Primitive
    attributes: BlockAttributes = DEFAULT_ATTRIBUTES
    modifiers: tuple[Modifier, ...] = ()

    def with_modifier(self, m: Modifier) -> "Block":
        return replace(self, modifiers=self.modifiers + (m,))

    def rotationally_symmetric(self) -> bool:
        """block.rs:403: Atom/Air primitives with only symmetry-
        preserving modifiers never look different rotated."""
        prim_ok = isinstance(self.primitive, (Atom, AirPrimitive))
        mods_ok = all(
            isinstance(m, (Quote, Tag, InventoryModifier)) for m in self.modifiers
        )
        return prim_ok and mods_ok

    def rotate(self, rotation: int) -> "Block":
        """block.rs:449 Block::rotate: identity and symmetric blocks are
        unchanged; a trailing Rotate modifier is composed rather than
        chained."""
        if rotation == 0:
            return self
        if self.rotationally_symmetric():
            return self
        if self.modifiers and isinstance(self.modifiers[-1], Rotate):
            from ..math.grid import compose_rotations

            combined = compose_rotations(rotation, self.modifiers[-1].rotation)
            return replace(
                self, modifiers=self.modifiers[:-1] + (Rotate(combined),)
            )
        return self.with_modifier(Rotate(rotation))

    def with_attributes(self, **kw) -> "Block":
        return replace(self, attributes=replace(self.attributes, **kw))

    def __hash__(self):
        return hash((self.primitive, self.attributes, self.modifiers))


class BlockDef:
    """A named, cached block definition, the target of `Indirect`
    (block/block_def.rs). Cache is invalidated by `touch()` — the listener
    plumbing of the reference becomes explicit invalidation since all
    mutation flows through our transaction commit points."""

    def __init__(self, block: Block, name: str = "<anonymous>"):
        self.block = block
        self.name = name
        self._cache = None
        self._cache_epoch = -1
        self.epoch = 0

    def touch(self):
        self.epoch += 1

    def redefine(self, block: Block):
        self.block = block
        self.touch()


AIR = Block(AirPrimitive(), BlockAttributes(display_name="<air>", selectable=False))


def from_color(color, display_name=DEFAULT_ATTRIBUTES.display_name, emission=(0.0, 0.0, 0.0), **attr_kw) -> Block:
    """Convenience: solid-color atom block (block/builder.rs path)."""
    color = tuple(float(c) for c in color)
    if len(color) == 3:
        color = color + (1.0,)
    return Block(
        Atom(color=color, emission=tuple(float(e) for e in emission)),
        BlockAttributes(display_name=display_name, **attr_kw),
    )
