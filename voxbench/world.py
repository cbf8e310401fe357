"""The world files: read, checked against the configuration, and the free
cubes a traffic generator draws from.

A world is an input: the upstream template's port, written once into
`voxbench/worlds/` in the native save format (`aic-tpu-universe`
JSON). Both the program and the reference load the same file; the
generators here read its cube grid directly (base64 of gzip of u16).
"""

from __future__ import annotations

import base64
import gzip
import hashlib
import json
from pathlib import Path

import numpy as np


def sha256(path: Path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def verify(path: Path, world_cfg: dict) -> None:
    """Raise unless the file is the one the configuration names."""
    digest = sha256(path)
    if world_cfg.get("sha256") and digest != world_cfg["sha256"]:
        raise ValueError(f"{path}: sha256 {digest}, the configuration says {world_cfg['sha256']}")


def cube_grid(path: Path, space: str = "world"):
    """(lower i32[3], contents u16[X,Y,Z], air bool[P]) of a space."""
    with open(path) as f:
        doc = json.load(f)
    d = doc["spaces"][space]
    size = tuple(d["bounds"]["size"])
    raw = gzip.decompress(base64.b64decode(d["contents"]))
    contents = np.frombuffer(raw, "<u2").reshape(size)
    air = np.array([b["primitive"]["type"] == "air" and not b.get("modifiers") for b in d["palette"]])
    return np.asarray(d["bounds"]["lower"], np.int64), contents, air


def free_cubes(path: Path, clearance: int = 1, space: str = "world") -> np.ndarray:
    """Cubes (world coordinates, i64[N,3]) whose neighbourhood of
    `clearance` cubes on every side is air and inside the bounds: where
    a viewer's eye can be."""
    lower, contents, air = cube_grid(path, space)
    is_air = air[contents]
    c = clearance
    ok = np.ones_like(is_air)
    X, Y, Z = is_air.shape
    ok[:c] = ok[X - c:] = False
    ok[:, :c] = ok[:, Y - c:] = False
    ok[:, :, :c] = ok[:, :, Z - c:] = False
    for dx in range(-c, c + 1):
        for dy in range(-c, c + 1):
            for dz in range(-c, c + 1):
                ok &= np.roll(is_air, (-dx, -dy, -dz), axis=(0, 1, 2))
    return np.argwhere(ok) + lower
