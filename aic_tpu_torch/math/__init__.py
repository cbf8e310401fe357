"""Layer 0: math substrate (port of `aic_tpu/math`)."""

from . import color, faces, grid, lightpack, raycast
from .faces import NX, NY, NZ, PX, PY, PZ, WITHIN
from .grid import GridAab

__all__ = [
    "color",
    "faces",
    "grid",
    "lightpack",
    "raycast",
    "GridAab",
    "NX",
    "NY",
    "NZ",
    "PX",
    "PY",
    "PZ",
    "WITHIN",
]
