"""Exhibit helpers (the part of `aic_tpu/content/exhibits.py` that the
step loop's content needs; the exhibits themselves come with demo-city,
ROADMAP A7)."""

from __future__ import annotations

from ..block import AIR, Block
from ..universe.op import Become


def _become_cycle(frames: list[Block], period: int) -> list[Block]:
    """Close a list of frames into a tick-action Become cycle
    (exhibits.py:198-216).

    Immutable blocks cannot reference each other cyclically by value, so
    the cycle runs through BlockDef handles: frame i's definition holds a
    tick action Becoming the Indirect of frame i+1."""
    from ..block import BlockDef, Indirect

    defs = [BlockDef(AIR) for _ in frames]
    handles = [Block(Indirect(d)) for d in defs]
    n = len(frames)
    for i in range(n):
        defs[i].block = frames[i].with_attributes(
            tick_action=Become(handles[(i + 1) % n]), tick_period=period
        )
    return handles
