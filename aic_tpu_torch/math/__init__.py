"""Layer 0: math substrate (port of `aic_tpu/math`)."""

from . import chunking, color, faces, grid, lightpack, raycast
from .faces import NX, NY, NZ, PX, PY, PZ, WITHIN
from .grid import GridAab

__all__ = [
    "chunking",
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
