"""Layer 4: procedural content templates (port of `aic_tpu/content`).

Templates so far: `atrium` (the north-star scene, recursive R16 blocks +
emissive lighting), `cornell-box` (atoms only, the page-less traversal
branch) and `plaza640` (a 640×8×640 courtyard of the atrium's blocks,
whose megakernel tables exceed their budget: the v1 trace path). The
first two follow `aic_tpu/content/template.py`; `plaza640` is the port's
own. `build_universe` (template.py) makes a whole universe of one.
"""

from __future__ import annotations

from .atrium import atrium
from .cornell import cornell_box
from .landscape import voxel_block
from .plaza import plaza

TEMPLATE_NAMES = ["atrium", "cornell-box", "plaza640"]


def build_template_space(name: str, seed: int = 0, size: int | None = None):
    """Build the world Space for a named template."""
    if name == "atrium":
        return atrium(seed)
    if name == "cornell-box":
        return cornell_box(size or 32)
    if name == "plaza640":
        return plaza(size or 640)
    raise KeyError(f"unknown template {name!r}; available: {', '.join(TEMPLATE_NAMES)}")


from .template import TemplateParameters, build_universe  # noqa: E402 (uses build_template_space)

__all__ = [
    "TEMPLATE_NAMES", "TemplateParameters", "atrium", "build_template_space", "build_universe",
    "cornell_box", "plaza", "voxel_block",
]
