"""`plaza640`: a courtyard of the atrium's blocks, 640×8×640 cubes.

The floor is the atrium's R16 `floor` block at y = 0, with an R16
`column` at (i, 1, 7i mod 640) for every 37th i, under a uniform sky.
The light starts from the fast seed, as the atrium's does. The spawn
point stands 120 cubes from the centre at 6 cubes' height, so that the
frontend's camera (`main.default_camera`, which looks at the centre)
sees the floor and columns within the default 200-cube view distance.
Its
megakernel tables come to 13.3 MiB (1600 narrow classify pages),
over the 10 MiB that `trace_kernel.megakernel_fits` allows, so it is a
world that `aic_tpu` traces with its v1 kernel; the 512×512 version
(8.5 MiB) still fits. No stock template reaches v1 at its default size.
"""

from __future__ import annotations

import numpy as np

from ..math.grid import GridAab
from ..space import Sky, Space, SpacePhysics
from .atrium import _atrium_blocks

HEIGHT = 8
COLUMN_EVERY = 37


def plaza(size: int = 640) -> Space:
    """The courtyard at `size`×8×`size` cubes (640: `plaza640`)."""
    blocks = _atrium_blocks(16)
    space = Space(
        GridAab.from_lower_size((0, 0, 0), (size, HEIGHT, size)),
        physics=SpacePhysics(sky=Sky.uniform((0.6, 0.7, 0.9))),
    )
    space.fill(GridAab.from_lower_size((0, 0, 0), (size, 1, size)), blocks["floor"])
    for i in range(0, size, COLUMN_EVERY):
        space.set((i, 1, (7 * i) % size), blocks["column"])
    space.spawn_position = np.array([size / 2, 6.0, size / 2 + 120])
    space.fast_evaluate_light()
    return space
