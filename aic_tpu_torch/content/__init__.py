"""Layer 4: procedural content templates (port of `aic_tpu/content`).

Two templates so far: `atrium` (the north-star scene, recursive R16
blocks + emissive lighting) and `cornell-box` (atoms only, the page-less
traversal branch). `build_template_space` follows
`aic_tpu/content/template.py` for those two names.
"""

from __future__ import annotations

from .atrium import atrium
from .cornell import cornell_box
from .landscape import voxel_block

TEMPLATE_NAMES = ["atrium", "cornell-box"]


def build_template_space(name: str, seed: int = 0, size: int | None = None):
    """Build the world Space for a named template."""
    if name == "atrium":
        return atrium(seed)
    if name == "cornell-box":
        return cornell_box(size or 32)
    raise KeyError(f"unknown template {name!r}; available: {', '.join(TEMPLATE_NAMES)}")


__all__ = ["TEMPLATE_NAMES", "atrium", "build_template_space", "cornell_box", "voxel_block"]
