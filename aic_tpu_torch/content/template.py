"""Template parameters and whole universes built from a template.

Port of `TemplateParameters` and `build_universe` of
`aic_tpu/content/template.py` (the reference's template.rs
`UniverseTemplate::build`), over the port's templates
(`build_template_space`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..universe import Universe


@dataclass(frozen=True)
class TemplateParameters:
    """template.rs TemplateParameters: seed + requested size."""

    seed: int = 0
    size: Optional[int] = None


def build_universe(name: str, params: TemplateParameters = TemplateParameters(), device="cuda") -> Universe:
    """A Universe holding the template's space as "world", snapshotted on
    `device` (the card unless the caller asks for the CPU), and a player
    character at its spawn point (or the centre of its bounds)."""
    from . import build_template_space

    u = Universe(device=device)
    space = build_template_space(name, seed=params.seed, size=params.size)
    u.insert_space("world", space)
    spawn = (
        tuple(float(c) for c in space.spawn_position)
        if space.spawn_position is not None
        else tuple(lo + s / 2 for lo, s in zip(space.bounds.lower, space.bounds.size))
    )
    u.insert_character("player", "world", spawn)
    return u
