"""Layer 4: procedural content templates (port of `aic_tpu/content`).

Every template of `aic_tpu/content/template.py` but `menu` (which waits
for the voxel-UI pages, ROADMAP A9), and the port's own `plaza640`: a
640×8×640 courtyard of the atrium's blocks whose megakernel tables
exceed their budget, so it takes the v1 trace path. `build_universe`
makes a whole universe of one.
"""

from .atrium import atrium
from .city import demo_city
from .cornell import cornell_box
from .fractal import menger_sponge
from .landscape import demo_blocks, voxel_block
from .plaza import plaza
from .template import (
    TEMPLATE_NAMES,
    TemplateParameters,
    build_template_space,
    build_universe,
)
from .testing import light_bench_space

__all__ = [
    "TEMPLATE_NAMES",
    "TemplateParameters",
    "atrium",
    "build_template_space",
    "build_universe",
    "cornell_box",
    "demo_blocks",
    "demo_city",
    "light_bench_space",
    "menger_sponge",
    "plaza",
    "voxel_block",
]
