"""Decoding the native save format (versioned JSON, gzip-compressed
volumes): one space of a saved world and the blocks of its palette.

Copied from the port's `io/save.py`, cut to loading a space: block and
space schemas as the format defines them. Operations (tick and
activation actions) and text blocks are not decoded: no configured world
holds them, and a world that does is refused.
"""

from __future__ import annotations

import base64
import gzip
import json

import numpy as np

from .. import block as blockmod
from ..math.grid import GridAab
from ..space import Sky, Space, SpacePhysics

FORMAT_NAME = "aic-tpu-universe"
FORMAT_VERSION = 1


def _unpack_array(s: str, dtype, shape) -> np.ndarray:
    raw = gzip.decompress(base64.b64decode(s))
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def op_from_schema(d: dict, spaces: dict, defs: dict | None = None):
    raise ValueError(f"a block with a {d.get('type')!r} action: operations are not decoded here")


# -- block schema -------------------------------------------------------------

def block_from_schema(d: dict, spaces: dict, defs: dict | None = None) -> blockmod.Block:
    p = d["primitive"]
    t = p["type"]
    if t == "air":
        return blockmod.AIR
    if t == "indirect":
        if defs is None or p["def"] not in defs:
            raise ValueError(f"save references unknown block def {p['def']!r}")
        prim = blockmod.Indirect(defs[p["def"]])
    elif t == "atom":
        prim = blockmod.Atom(
            color=tuple(p["color"]), emission=tuple(p["emission"]),
            collision=p.get("collision", 1),
        )
    elif t == "recur":
        prim = blockmod.Recur(
            space=spaces[p["space"]], resolution=p["resolution"],
            offset=tuple(p["offset"]),
        )
    elif t == "text":
        raise ValueError("a text block: text is not decoded here")
    else:
        raise ValueError(f"unknown primitive type {t}")

    mods = []
    for m in d.get("modifiers", []):
        mt = m["type"]
        if mt == "rotate":
            mods.append(blockmod.Rotate(m["rotation"]))
        elif mt == "quote":
            mods.append(blockmod.Quote())
        elif mt == "zoom":
            mods.append(blockmod.Zoom(m["scale"], tuple(m["offset"])))
        elif mt == "move":
            mods.append(blockmod.Move(m["face"], m["distance"], m.get("velocity", 0)))
        elif mt == "composite":
            mods.append(
                blockmod.Composite(source=block_from_schema(m["source"], spaces, defs),
                                   operator=m.get("operator", "over"),
                                   reverse=m.get("reverse", False))
            )
        else:
            raise ValueError(f"unknown modifier type {mt}")

    a = d.get("attributes", {})
    return blockmod.Block(
        primitive=prim,
        attributes=blockmod.BlockAttributes(
            display_name=a.get("display_name", "<unnamed>"),
            selectable=a.get("selectable", True),
            animated=a.get("animated", False),
            tick_action=(
                None
                if a.get("tick_action") is None
                else op_from_schema(a["tick_action"], spaces, defs)
            ),
            tick_period=a.get("tick_period", 1),
            activation_action=(
                None
                if a.get("activation_action") is None
                else op_from_schema(a["activation_action"], spaces, defs)
            ),
            rotation_rule=a.get("rotation_rule", "never"),
            tags=tuple(a.get("tags", ())),
        ),
        modifiers=tuple(mods),
    )


# -- space schema --------------------------------------------------------------

def _space_shell(d: dict) -> Space:
    """Phase 1: construct the Space with bounds/physics only, so cyclic
    Recur references (a palette block whose voxel space is this very
    space — legal to build and save) can resolve to the in-progress
    object instead of recursing forever."""
    bounds = GridAab.from_lower_size(d["bounds"]["lower"], d["bounds"]["size"])
    ph = d["physics"]
    return Space(
        bounds,
        physics=SpacePhysics(
            gravity=tuple(ph["gravity"]),
            sky=Sky.from_octants(np.asarray(ph["sky_octants"], np.float32)),
            light_enabled=ph["light_enabled"],
            light_max_distance=ph["light_max_distance"],
        ),
    )


def _space_fill(sp: Space, d: dict, spaces: dict, defs: dict | None = None) -> Space:
    """Phase 2: deserialize the palette and contents into the shell."""
    palette_blocks = [block_from_schema(b, spaces, defs) for b in d["palette"]]
    # Intern palette and REMAP stored indices: ensure_block dedups equal
    # blocks and recycles free slots, so the interned index need not
    # equal the saved position (two saved entries that deserialize equal
    # collapse to one slot — without the remap, contents would carry
    # dangling indices past the palette).
    remap = np.zeros(max(len(palette_blocks), 1), np.uint16)
    for i, b in enumerate(palette_blocks):
        remap[i] = sp.ensure_block(b)
    raw = _unpack_array(d["contents"], "<u2", sp.bounds.size)
    if raw.size and int(raw.max()) >= len(palette_blocks):
        raise ValueError(
            f"save contents index {int(raw.max())} out of palette range "
            f"{len(palette_blocks)}"
        )
    sp.contents = remap[raw]
    return sp



def load_space(path: str, name: str = "world") -> Space:
    """The space `name` of a saved world, its palette evaluated, with the
    spaces and block definitions its blocks refer to."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") != FORMAT_NAME:
        raise ValueError(f"not a {FORMAT_NAME} file")
    if doc.get("version", 0) > FORMAT_VERSION:
        raise ValueError(f"unsupported version {doc['version']}")
    built: dict[str, Space] = {}
    defs = {n: blockmod.BlockDef(blockmod.AIR, n) for n in doc.get("block_defs", {})}

    def get_space(key):
        sp = built.get(key)
        if sp is None:
            if key not in doc["spaces"]:
                raise KeyError(f"save references unknown space {key!r}")
            d = doc["spaces"][key]
            sp = _space_shell(d)
            built[key] = sp  # before its palette: a block may refer to its own space
            _space_fill(sp, d, _proxy, defs)
        return sp

    class _Proxy(dict):
        def __getitem__(self, key):
            return get_space(key)

    _proxy = _Proxy()
    for n, bd in defs.items():
        bd.block = block_from_schema(doc["block_defs"][n], _proxy, defs)
    return get_space(name)
