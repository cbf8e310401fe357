"""Import the reference's native save format (`.alliscubesjson`).

Deserializer for the upstream serialization schema
(all-is-cubes/src/save/schema.rs; format dispatch
all-is-cubes-port/src/import.rs:144 Format::AicJson): a `UniverseV1`
document whose members are Blocks, Spaces, Characters, Sounds and Tags.
Space contents/light arrays are gzip+base64 `GzSerde` payloads of
little-endian u16 palette indices / `LightSerV1` texels in the Vol's
x-major (C) order (save/compress.rs, schema.rs:467-500).

Covered: Air/Atom/Recur/Indirect/Text primitives; Quote, Rotate,
Composite, Zoom, Move, Tag, BlockInventory modifiers; the attribute
modifiers (DisplayName, Selectable, InvInBlock, RotationRule,
TickAction [Become], ActivationAction [Become], AnimationHint); uniform
and octant skies; Rays/None light physics with the stored light field;
characters with body state. Unknown modifiers/operations degrade to
no-ops with a warning list returned alongside the universe (the
reference hard-fails instead; we prefer partial import for inspection).

Port of `aic_tpu/io/import_ref.py`, schema for schema, so a file written
by either package loads in the other. The module is host code; the only
device data it touches are a loaded space's stored light (copied onto
its state once) and the characters' bodies (read from the device once
when saving, `body_to_numpy`). A loaded universe's states and bodies land
on the device `load_alliscubesjson` is given (the card unless the caller
asks for the CPU).

Where the port goes further than `aic_tpu`, in the reference's direction
(its universe holds every space and block definition as a member, named
by handle): it writes Indirect blocks and the spaces voxel blocks draw
from that are not members, giving them anonymous member names
(`_MemberNames`), where `aic_tpu` refuses to write them; and it reads
Block members as `BlockDef`s named by Indirect blocks, where `aic_tpu`
puts the definition's block in place of each Indirect one, which never
ends on definitions that name each other (demo-city's).
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import gzip
import json
import struct
import zlib

from types import SimpleNamespace

import numpy as np
import torch

from .. import block as blockmod
from ..block.model import DEFAULT_ATTRIBUTES as _DEFAULT_ATTRS
from ..block import (
    AIR,
    Atom,
    Block,
    BlockAttributes,
    BlockDef,
    Composite,
    IconRow,
    Indirect,
    InvInBlock,
    InventoryModifier,
    Move,
    Quote,
    Recur,
    Rotate,
    Tag,
    TextPrimitive,
    Zoom,
)
from ..math import faces
from ..math.grid import GridAab, rotation_from_name
from ..space import Sky, Space, SpacePhysics
from ..universe.op import Become

_FACE_NAMES = {
    "NX": faces.NX, "NY": faces.NY, "NZ": faces.NZ,
    "PX": faces.PX, "PY": faces.PY, "PZ": faces.PZ,
}

#: LightStatusSerV1 (schema.rs:496-502) → our packed status byte.
_LIGHT_STATUS = {
    0: 0,  # Uninitialized
    1: 1,  # NoRays  (lightpack.STATUS_NO_RAYS)
    2: 128,  # Opaque (lightpack.STATUS_OPAQUE)
    3: 255,  # Visible (lightpack.STATUS_VISIBLE)
}


def _gunzip(entry) -> bytes:
    """GzSerde payload: {"Base64Gzip": str} or {"Gzip": [bytes]}
    (compress.rs:107)."""
    if "Base64Gzip" in entry:
        return gzip.decompress(base64.b64decode(entry["Base64Gzip"]))
    if "Gzip" in entry:
        return gzip.decompress(bytes(entry["Gzip"]))
    raise ValueError(f"unknown GzSerde variant {list(entry)!r}")


def _handle_name(h) -> str:
    """HandleV1 {"Specific": name} / {"Anonym": n} (universe names)."""
    if isinstance(h, dict):
        inner = {k: v for k, v in h.items() if k != "type"}
        if "Specific" in inner:
            return str(inner["Specific"])
        if "Anonym" in inner:
            return f"[anonymous #{inner['Anonym']}]"
    raise ValueError(f"unsupported handle {h!r}")


class _Importer:
    def __init__(self, doc: dict, device="cuda"):
        if doc.get("type") != "UniverseV1":
            raise ValueError(f"not an all-is-cubes universe: {doc.get('type')!r}")
        self.doc = doc
        self.device = device
        self.warnings: list[str] = []
        self.space_schemas: dict[str, dict] = {}
        self.block_defs: dict[str, dict] = {}
        self.defs: dict[str, BlockDef] = {}
        self.spaces: dict[str, Space] = {}
        self.lights: dict[str, np.ndarray] = {}
        self.characters: list[tuple[str, str, dict]] = []
        self.sounds: dict[str, object] = {}
        self.tags: list[str] = []

    def run(self):
        # Imported here: the universe module imports this package (whence).
        from ..universe import Universe

        for member in self.doc.get("members", []):
            name = _handle_name(member["name"]) if isinstance(
                member["name"], dict
            ) else str(member["name"])
            kind = member["member_type"]
            if kind == "Space":
                self.space_schemas[name] = member["value"]
            elif kind == "Block":
                self.block_defs[name] = member["value"]
            elif kind == "Character":
                self.characters.append((name, "", member["value"]))
            elif kind == "Sound":
                self.sounds[name] = member["value"]
            elif kind == "Tag":
                self.tags.append(name)
            else:
                self.warnings.append(f"skipped member type {kind!r} ({name})")

        u = Universe(device=self.device)
        for name in self.space_schemas:
            self._space(name)
        for name in self.block_defs:
            d = self._block_def(name)
            if Universe.is_anonymous(name):
                u.block_defs[name] = d
            else:
                u.insert_block_def(name, d)
        for name, sp in self.spaces.items():
            if Universe.is_anonymous(name):
                # Anonymous members (Name::Anonym) re-enter through the
                # anonymous path, preserving their gc semantics.
                u.insert_space(name, sp, _anonymous=True)
            else:
                u.insert_space(name, sp)
        for name, light in self.lights.items():
            # Imported stored light: apply onto the snapshot.
            st = u.get_state(name)
            u.states[name] = dataclasses.replace(st, light=torch.as_tensor(light, device=st.device))
        for name, _, cs in self.characters:
            self._character(u, name, cs)
        for name, sd in self.sounds.items():
            u.sounds[name] = self._sound(name, sd)
        for t in self.tags:
            u.tags.setdefault(t, None)
        return u

    def _block_def(self, name: str) -> BlockDef:
        """The definition of Block member `name`, made once: an Indirect
        block names it by handle, and a definition's block may name itself
        again (a tick action's Become back to it), so the definition is
        registered before its block is read."""
        d = self.defs.get(name)
        if d is None:
            d = self.defs[name] = BlockDef(AIR, name)
            d.block = self._block(self.block_defs[name])
        return d

    def _sound(self, name: str, d: dict):
        """SoundDefSer::SynthesizedSoundV1 (schema.rs:437-443) → our
        SoundDef (sine synthesis with matching duration/frequency/
        amplitude; our envelope decay defaults apply)."""
        from ..universe.sound import SoundDef

        if d.get("type") != "SynthesizedSoundV1":
            self.warnings.append(f"unknown sound schema {d.get('type')!r} ({name})")
            return SoundDef()
        return SoundDef(
            waveform="sine",
            frequency=float(d["frequency"]),
            duration=float(d["duration"]),
            amplitude=float(d["amplitude"]),
        )

    # -- members ---------------------------------------------------------

    def _space(self, name: str) -> Space:
        if name in self.spaces:
            return self.spaces[name]
        if name not in self.space_schemas:
            raise ValueError(f"save references unknown space {name!r}")
        d = self.space_schemas[name]
        if d.get("type") != "SpaceV1":
            raise ValueError(f"unsupported space schema {d.get('type')!r}")
        bounds = GridAab.from_lower_upper(d["bounds"]["lower"], d["bounds"]["upper"])
        if bounds.volume() > _IMPORT_MAX_VOLUME:
            # Bounds are attacker-controlled allocation sizes in an
            # untrusted save (fuzz_import.rs contract).
            raise ValueError(
                f"space {name!r} volume {bounds.volume()} exceeds import cap"
            )
        phys = d["physics"]
        sky_d = phys["sky"]
        if sky_d["type"] == "UniformV1":
            sky = Sky.uniform(sky_d["color"])
        elif sky_d["type"] == "OctantsV1":
            sky = Sky.from_octants(sky_d["colors"])
        else:
            raise ValueError(f"unknown sky {sky_d['type']!r}")
        light_d = phys["light"]
        if light_d["type"] == "RaysV1":
            physics = SpacePhysics(
                sky=sky,
                gravity=tuple(float(g) for g in phys["gravity"]),
                light_max_distance=int(light_d["maximum_distance"]),
            )
        else:  # NoneV1
            physics = SpacePhysics(
                sky=sky,
                gravity=tuple(float(g) for g in phys["gravity"]),
                light_enabled=False,
            )
        sp = Space(bounds, physics=physics)
        # Two-phase: register the shell before resolving palette blocks so
        # Recur cycles terminate (io/save.py load_universe uses the same
        # pattern).
        self.spaces[name] = sp

        palette = [self._block(b) for b in d["blocks"]]
        size = bounds.size
        contents = np.frombuffer(_gunzip(d["contents"]), dtype="<u2").reshape(size)
        lower = bounds.lower
        # Palette slot 0 is NOT guaranteed to be AIR: the reference's
        # Palette::new seeds slot 0 with the SpaceBuilder fill block
        # (space/builder.rs filled_with), so a save of a filled space can
        # use index 0 for a solid block. Fill those cells too (but skip
        # the overwhelmingly common all-air slot 0 for speed).
        start_idx = 1
        if palette and palette[0] != AIR:
            start_idx = 0
        for idx in range(start_idx, len(palette)):
            cells = np.argwhere(contents == idx)
            blk = palette[idx]
            for rel in cells:
                sp.set(tuple(int(v) + l for v, l in zip(rel, lower)), blk)

        if d.get("light") is not None:
            raw = np.frombuffer(_gunzip(d["light"]), dtype=np.uint8).reshape(
                size + (4,)
            )
            light = raw.copy()
            status = raw[..., 3]
            light[..., 3] = np.vectorize(lambda s: _LIGHT_STATUS.get(int(s), 0))(
                status
            ).astype(np.uint8)
            self.lights[name] = light

        spawn = d.get("spawn", {})
        eye = spawn.get("eye_position")
        if eye:
            sp.spawn_position = np.asarray(eye, np.float64)
        return sp

    def _character(self, u, name: str, d: dict):
        if d.get("type") != "CharacterV1":
            self.warnings.append(f"skipped character {name} ({d.get('type')!r})")
            return
        space_name = _handle_name(d["space"])
        body = d["body"]
        if space_name not in self.spaces:
            self.warnings.append(
                f"character {name} references missing space {space_name!r}"
            )
            return
        ch = u.insert_character(name, space_name, tuple(body["position"]))
        # The body's row, rewritten on the host and copied to the device once.
        from ..physics.body import BODY_DTYPES, body_to_numpy

        i = ch.body_index
        cols = {k: v.copy() for k, v in body_to_numpy(u.bodies).items()}
        cols["velocity"][i] = body["velocity"]
        cols["flying"][i] = bool(body["flying"])
        cols["noclip"][i] = bool(body["noclip"])
        cols["yaw"][i] = float(body["yaw"])
        cols["pitch"][i] = float(body["pitch"])
        dev = u.bodies.position.device
        u.bodies = dataclasses.replace(u.bodies, **{
            k: torch.as_tensor(cols[k], device=dev).to(BODY_DTYPES[k])
            for k in ("velocity", "flying", "noclip", "yaw", "pitch")
        })

    # -- blocks ----------------------------------------------------------

    def _block(self, d: dict) -> Block:
        if d.get("type") != "BlockV1":
            raise ValueError(f"unsupported block schema {d.get('type')!r}")
        p = d["primitive"]
        t = p["type"]
        if t == "AirV1":
            base = AIR
        elif t == "AtomV1":
            base = Block(
                Atom(
                    color=tuple(float(c) for c in p["color"]),
                    emission=tuple(float(c) for c in p.get("light_emission", (0, 0, 0))),
                    collision=(
                        blockmod.COLLISION_NONE
                        if p.get("collision") == "NoneV1"
                        else blockmod.COLLISION_HARD
                    ),
                )
            )
        elif t == "RecurV1":
            space_name = _handle_name(p["space"])
            vox_space = self._space(space_name)
            base = Block(
                Recur(
                    space=vox_space,
                    resolution=int(p["resolution"]),
                    offset=tuple(p.get("offset", (0, 0, 0))),
                )
            )
        elif t == "IndirectV1":
            def_name = _handle_name(p["definition"])
            if def_name in self.block_defs:
                base = Block(Indirect(self._block_def(def_name)))
            else:
                self.warnings.append(f"missing block def {def_name!r} → AIR")
                base = AIR
        elif t == "TextPrimitiveV1":
            text_d = p["text"]

            def _atom_color(blk_d, default):
                if blk_d and blk_d["primitive"]["type"] == "AtomV1":
                    return tuple(float(c) for c in blk_d["primitive"]["color"])
                return default

            color = _atom_color(text_d.get("foreground"), (1.0, 1.0, 1.0, 1.0))
            outline_d = text_d.get("outline")
            outline = (
                _atom_color(outline_d, (0.0, 0.0, 0.0, 1.0))
                if outline_d is not None
                else None
            )
            font_handle = text_d.get("font", {})
            font_name = str(font_handle.get("Builtin", ""))
            font = {
                "all-is-cubes/font/system-16": "system16",
                "all-is-cubes/font/body-text": "body-text",
            }.get(font_name, "system16")
            lbd = text_d.get("layout_bounds")
            lb = (
                GridAab.from_lower_upper(lbd["lower"], lbd["upper"])
                if lbd
                else None
            )
            posd = text_d.get("positioning")
            positioning = None
            if posd:
                # PositioningSerV1 variant names → our variant strings.
                strip = lambda v: str(v).removesuffix("V1")
                xmap = {"Left": "left", "Center": "center", "Right": "right"}
                ymap = {
                    "BodyTop": "body-top",
                    "BodyMiddle": "body-middle",
                    "Baseline": "baseline",
                    "BodyBottom": "body-bottom",
                }
                zmap = {"Back": "back", "Front": "front"}
                positioning = (
                    xmap.get(strip(posd["x"]), "center"),
                    ymap.get(strip(posd["line_y"]), "body-middle"),
                    zmap.get(strip(posd["z"]), "back"),
                )
            off = p.get("offset", [0, 0, 0])
            base = Block(
                TextPrimitive(
                    text=str(text_d.get("string", "")),
                    resolution=int(text_d.get("resolution", 16)),
                    color=color,
                    tile=(int(off[0]), int(off[1])),
                    tile_z=int(off[2]),
                    font=font,
                    positioning=positioning,
                    layout_lower=None if lb is None else lb.lower,
                    layout_size=None if lb is None else lb.size,
                    outline_color=outline,
                )
            )
        else:
            self.warnings.append(f"unknown primitive {t!r} → AIR")
            base = AIR

        for m in d.get("modifiers", ()):
            base = self._apply_modifier(base, m)
        return base

    def _apply_modifier(self, blk: Block, m: dict) -> Block:
        t = m["type"]
        if t == "DisplayNameV1":
            return blk.with_attributes(display_name=str(m["display_name"]))
        if t == "SelectableV1":
            return blk.with_attributes(selectable=bool(m["selectable"]))
        if t == "QuoteV1":
            return blk.with_modifier(Quote(suppress_ambient=bool(m["suppress_ambient"])))
        if t == "RotateV1":
            return blk.with_modifier(Rotate(rotation_from_name("R" + m["rotation"].lstrip("R"))))
        if t == "CompositeV1":
            return blk.with_modifier(
                Composite(
                    source=self._block(m["source"]),
                    operator=str(m["operator"]).removesuffix("V1").lower(),
                    reverse=bool(m.get("reverse", False)),
                )
            )
        if t == "ZoomV1":
            return blk.with_modifier(
                Zoom(scale=int(m["scale"]), offset=tuple(m["offset"]))
            )
        if t == "Move":
            mv = m
            # Reference distance is in 1/resolution cube units
            # (move.rs:33); ours is 1/256ths — convert.
            res = int(mv.get("resolution", 16))
            return blk.with_modifier(
                Move(
                    face=_FACE_NAMES[mv["direction"]],
                    distance=int(round(int(mv["distance"]) * 256 / res)),
                    velocity=int(mv.get("velocity", 0)),
                )
            )
        if t == "TagV1":
            tag_d = m["tag"]
            if isinstance(tag_d, dict) and tag_d.get("type") == "TagHandleV1":
                return blk.with_modifier(Tag(_handle_name(tag_d["handle"])))
            return blk.with_modifier(Tag(str(tag_d)))
        if t == "BlockInventoryV1":
            inv = m["inventory"]
            icons = []
            for slot in inv.get("slots", ()):
                if slot is None:
                    icons.append(None)
                    continue
                item = slot.get("item", {})
                if item.get("type") in ("BlockV1", "InfiniteBlocksV1"):
                    icons.append(self._block(item["block"]))
                else:
                    icons.append(None)
            return blk.with_modifier(InventoryModifier(icons=tuple(icons)))
        if t == "InvInBlockV1":
            return blk.with_attributes(
                inventory=InvInBlock(
                    inventory_size=int(m["size"]),
                    icon_scale=int(m["icon_scale"]),
                    render_resolution=int(m["icon_resolution"]),
                    icon_rows=tuple(
                        IconRow(
                            first_slot=int(r["first_slot"]),
                            count=int(r["count"]),
                            origin=tuple(r["origin"]),
                            stride=tuple(r["stride"]),
                        )
                        for r in m.get("icon_rows", ())
                    ),
                )
            )
        if t == "AmbientSoundV1":
            bands = tuple(float(v) for v in m.get("noise_bands", ()))
            if any(bands):
                return blk.with_attributes(ambient_sound=bands)
            return blk
        if t == "RotationRuleV1":
            rule = m["rotation_rule"]
            return blk.with_attributes(
                rotation_rule="attach" if rule.get("type") == "AttachV1" else "never"
            )
        if t == "TickActionV1":
            ta = m.get("tick_action")
            if ta is None:
                return blk
            op = self._operation(ta.get("operation"))
            if op is None:
                return blk
            sched = ta.get("schedule", {})
            period = sched.get("period", 1)
            return blk.with_attributes(tick_action=op, tick_period=int(period))
        if t == "ActivationActionV1":
            op = self._operation(m.get("activation_action"))
            return blk if op is None else blk.with_attributes(activation_action=op)
        if t == "AnimationHintV1":
            hinted = m.get("redefinition", "None") != "None" or m.get(
                "replacement", "None"
            ) != "None"
            return blk.with_attributes(animated=hinted) if hinted else blk
        self.warnings.append(f"unknown modifier {t!r} ignored")
        return blk

    def _operation(self, op_d):
        if not op_d:
            return None
        t = op_d.get("type")
        from ..universe.op import Alt, DestroyTo, Neighbors

        if t == "BecomeV1":
            return Become(self._block(op_d["block"]))
        if t == "DestroyToV1":
            return DestroyTo(self._block(op_d["block"]))
        if t == "AltV1":
            ops = tuple(
                o for o in (self._operation(x) for x in op_d.get("ops", ())) if o
            )
            return Alt(ops=ops) if ops else None
        if t == "NeighborsV1":
            pairs = []
            for off, sub in op_d.get("neighbors", ()):
                sub_op = self._operation(sub)
                if sub_op is not None:
                    pairs.append((tuple(int(v) for v in off), sub_op))
            return Neighbors(ops=tuple(pairs)) if pairs else None
        self.warnings.append(f"unsupported operation {t!r} ignored")
        return None


#: Exceptions the schema walk can hit on malformed-but-well-formed-JSON
#: input; converted to ValueError so callers see one typed error
#: (port/src/import.rs returns ImportError for every malformed input).
_MALFORMED = (
    KeyError,
    TypeError,
    IndexError,
    AttributeError,
    OverflowError,
    UnicodeDecodeError,
    binascii.Error,
    gzip.BadGzipFile,
    zlib.error,
    struct.error,
)

#: Volume cap for imported spaces: a save is untrusted input, and bounds
#: are attacker-controlled allocation sizes (fuzz_import.rs contract).
_IMPORT_MAX_VOLUME = 1 << 28


def load_alliscubesjson(path: str, device="cuda"):
    """Import a `.alliscubesjson` save onto `device` (the card unless the
    caller asks for the CPU). Returns (Universe, warnings).

    Malformed input of any shape raises ValueError — never a raw
    KeyError/struct.error/RecursionError (the reference importer returns
    a typed ImportError for arbitrary bytes, fuzz_import.rs)."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        doc = json.loads(raw)
    except RecursionError:
        raise ValueError("malformed save: JSON nesting too deep") from None
    except UnicodeDecodeError as e:
        raise ValueError(f"malformed save: not UTF-8 ({e})") from None
    try:
        imp = _Importer(doc, device=device)
        u = imp.run()
    except ValueError:
        raise
    except RecursionError:
        raise ValueError("malformed save: unbounded recursion in members") from None
    except _MALFORMED as e:
        raise ValueError(f"malformed save: {type(e).__name__}: {e}") from None
    return u, imp.warnings


# ---------------------------------------------------------------------------
# Export (the write direction of port/src/export.rs Format::AicJson).


def _gz_b64(data: bytes) -> dict:
    return {"Base64Gzip": base64.b64encode(gzip.compress(data, 1)).decode()}


def _name_to_schema(name: str) -> dict:
    """Inverse of _handle_name's name mapping: anonymous members
    serialize as Name::Anonym (schema.rs NameSer), not Specific."""
    if name.startswith("[anonymous #") and name.endswith("]"):
        return {"Anonym": int(name[len("[anonymous #") : -1])}
    return {"Specific": name}


_LIGHT_STATUS_INV = {v: k for k, v in _LIGHT_STATUS.items()}


def _operation_to_schema(op, space_names: dict):
    """Inverse of _Importer._operation for the operation kinds we model.
    Returns None (caller records a dropped-attribute warning) for kinds
    with no schema mapping."""
    from ..universe.op import Alt, Become, DestroyTo, Neighbors

    if isinstance(op, Become):
        return {"type": "BecomeV1", "block": _block_to_schema(op.block, space_names)}
    if isinstance(op, DestroyTo):
        return {
            "type": "DestroyToV1",
            "block": _block_to_schema(op.block, space_names),
        }
    if isinstance(op, Alt):
        subs = [_operation_to_schema(o, space_names) for o in op.ops]
        if any(s is None for s in subs):
            return None
        return {"type": "AltV1", "ops": subs}
    if isinstance(op, Neighbors):
        pairs = []
        for off, sub in op.ops:
            sub_s = _operation_to_schema(sub, space_names)
            if sub_s is None:
                return None
            pairs.append([list(int(v) for v in off), sub_s])
        return {"type": "NeighborsV1", "neighbors": pairs}
    return None


def _block_to_schema(blk: Block, space_names: dict) -> dict:
    p = blk.primitive
    if isinstance(p, blockmod.AirPrimitive) or blk == AIR:
        prim = {"type": "AirV1"}
    elif isinstance(p, Atom):
        prim = {"type": "AtomV1", "color": [float(c) for c in p.color]}
        if any(p.emission):
            prim["light_emission"] = [float(c) for c in p.emission]
        if p.collision == blockmod.COLLISION_NONE:
            prim["collision"] = "NoneV1"
    elif isinstance(p, Recur):
        name = space_names.name(p.space)
        prim = {
            "type": "RecurV1",
            "space": {"type": "HandleV1", **_name_to_schema(name)},
            "resolution": int(p.resolution),
        }
        if any(p.offset):
            prim["offset"] = list(p.offset)
    elif isinstance(p, blockmod.Indirect):
        prim = {
            "type": "IndirectV1",
            "definition": {"type": "HandleV1", **_name_to_schema(space_names.name(p.block_def))},
        }
    elif isinstance(p, TextPrimitive):
        font_name = {
            "system16": "all-is-cubes/font/system-16",
            "body-text": "all-is-cubes/font/body-text",
        }.get(p.font, "all-is-cubes/font/system-16")
        if p.layout_lower is not None:
            lb = {
                "lower": [int(c) for c in p.layout_lower],
                "upper": [
                    int(l + s) for l, s in zip(p.layout_lower, p.layout_size)
                ],
            }
        else:
            lb = {"lower": [0, 0, 0], "upper": [int(p.resolution)] * 3}
        if p.positioning is not None:
            xmap = {"left": "LeftV1", "center": "CenterV1", "right": "RightV1"}
            ymap = {
                "body-top": "BodyTopV1",
                "body-middle": "BodyMiddleV1",
                "baseline": "BaselineV1",
                "body-bottom": "BodyBottomV1",
            }
            zmap = {"back": "BackV1", "front": "FrontV1"}
            positioning = {
                "x": xmap[p.positioning[0]],
                "line_y": ymap[p.positioning[1]],
                "z": zmap[p.positioning[2]],
            }
        elif p.font == "pil":
            # Legacy PIL tiles lay out Left/BodyTop/Front.
            positioning = {"x": "LeftV1", "line_y": "BodyTopV1", "z": "FrontV1"}
        else:
            # TextBuilder::default positioning (text.rs:707-711).
            positioning = {"x": "CenterV1", "line_y": "BodyMiddleV1", "z": "BackV1"}
        text_schema = {
            "type": "TextV1",
            "string": p.text,
            "font": {"type": "HandleV1", "Builtin": font_name},
            "foreground": {
                "type": "BlockV1",
                "primitive": {"type": "AtomV1", "color": [float(c) for c in p.color]},
            },
            "resolution": int(p.resolution),
            "layout_bounds": lb,
            "positioning": positioning,
        }
        if p.outline_color is not None:
            text_schema["outline"] = {
                "type": "BlockV1",
                "primitive": {
                    "type": "AtomV1",
                    "color": [float(c) for c in p.outline_color],
                },
            }
        prim = {
            "type": "TextPrimitiveV1",
            "text": text_schema,
            "offset": [int(p.tile[0]), int(p.tile[1]), int(p.tile_z)],
        }
    else:
        raise ValueError(f"unsupported primitive for export: {type(p).__name__}")

    out = {"type": "BlockV1", "primitive": prim}
    mods = []
    a = blk.attributes
    if a.display_name != _DEFAULT_ATTRS.display_name:
        mods.append({"type": "DisplayNameV1", "display_name": a.display_name})
    if not a.selectable:
        mods.append({"type": "SelectableV1", "selectable": False})
    if a.rotation_rule == "attach":
        mods.append(
            {
                "type": "RotationRuleV1",
                "rotation_rule": {"type": "AttachV1", "by": "PY"},
            }
        )
    if a.ambient_sound is not None and any(a.ambient_sound):
        mods.append(
            {"type": "AmbientSoundV1", "noise_bands": [float(v) for v in a.ambient_sound]}
        )
    inv_cfg = a.inventory
    if inv_cfg is not None and inv_cfg.inventory_size:
        mods.append(
            {
                "type": "InvInBlockV1",
                "size": inv_cfg.inventory_size,
                "icon_scale": inv_cfg.icon_scale,
                "icon_resolution": inv_cfg.render_resolution,
                "icon_rows": [
                    {
                        "first_slot": r.first_slot,
                        "count": r.count,
                        "origin": list(r.origin),
                        "stride": list(r.stride),
                    }
                    for r in inv_cfg.icon_rows
                ],
            }
        )
    if a.tick_action is not None:
        op_s = _operation_to_schema(a.tick_action, space_names)
        if op_s is not None:
            mods.append(
                {
                    "type": "TickActionV1",
                    "tick_action": {
                        "operation": op_s,
                        "schedule": {
                            "type": "ScheduleV1",
                            "period": int(a.tick_period or 1),
                        },
                    },
                }
            )
    if a.activation_action is not None:
        op_s = _operation_to_schema(a.activation_action, space_names)
        if op_s is not None:
            mods.append(
                {"type": "ActivationActionV1", "activation_action": op_s}
            )
    if getattr(a, "animated", False):
        mods.append(
            {
                "type": "AnimationHintV1",
                "redefinition": "Shape",
                "replacement": "None",
            }
        )
    for m in blk.modifiers:
        if isinstance(m, Quote):
            mods.append({"type": "QuoteV1", "suppress_ambient": m.suppress_ambient})
        elif isinstance(m, Rotate):
            from ..math.grid import rotation_name

            mods.append({"type": "RotateV1", "rotation": rotation_name(m.rotation)})
        elif isinstance(m, Composite):
            mods.append(
                {
                    "type": "CompositeV1",
                    "source": _block_to_schema(m.source, space_names),
                    "operator": m.operator.capitalize(),
                    "reverse": m.reverse,
                    "disassemblable": False,
                }
            )
        elif isinstance(m, Zoom):
            mods.append(
                {"type": "ZoomV1", "scale": m.scale, "offset": list(m.offset)}
            )
        elif isinstance(m, Move):
            # Our distance is in 1/256ths; the schema wants units of
            # 1/resolution with resolution ≤ R128. Pick the coarsest
            # resolution representing the distance exactly; odd 1/256
            # values have none, so round explicitly at R128 (nearest)
            # rather than silently floor-dividing.
            for res in (1, 2, 4, 8, 16, 32, 64, 128):
                if m.distance * res % 256 == 0:
                    break
            sch_dist = (m.distance * res + 128) // 256
            if not 0 <= sch_dist <= 255:
                raise ValueError(
                    f"Move distance {m.distance}/256 exceeds the schema's "
                    f"u8 range at resolution {res} (got {sch_dist})"
                )
            mods.append(
                {
                    "type": "Move",
                    "direction": faces.FACE_NAMES[m.face],
                    "resolution": res,
                    "distance": sch_dist,
                    "velocity": m.velocity,
                    "schedule": {"type": "ScheduleV1", "period": 1},
                }
            )
        elif isinstance(m, Tag):
            mods.append(
                {
                    "type": "TagV1",
                    "tag": {
                        "type": "TagHandleV1",
                        "handle": {"type": "HandleV1", **_name_to_schema(m.name)},
                    },
                }
            )
        elif isinstance(m, InventoryModifier):
            mods.append(
                {
                    "type": "BlockInventoryV1",
                    "inventory": {
                        "type": "InventoryV1",
                        "slots": [
                            None
                            if icon is None
                            else {
                                "count": 1,
                                "item": {
                                    "type": "BlockV1",
                                    "block": _block_to_schema(icon, space_names),
                                },
                            }
                            for icon in m.icons
                        ],
                    },
                }
            )
    if mods:
        out["modifiers"] = mods
    return out


class _MemberNames:
    """The member name of each space a saved block's Recur draws from and
    of each definition an Indirect block names. In the reference both are
    members of the universe, so the schema names them by handle; one that
    is not a member here (content builders make voxel blocks over free
    spaces, as demo-city's exhibits are, and definitions outside the
    universe) is given an anonymous name (Name::Anonym) as it is met, and
    written as an anonymous member. `aic_tpu` refuses to write Indirect
    blocks and free spaces; its importer reads the file (an Indirect
    block as its definition's block)."""

    def __init__(self, universe):
        named = {**universe.spaces, **getattr(universe, "block_defs", {})}
        self.names = {id(m): name for name, m in named.items()}
        taken = [n for n in named if n.startswith("[anonymous #") and n.endswith("]")]
        self.next = max((int(n[len("[anonymous #"):-1]) + 1 for n in taken), default=0)
        self.extra: list = []  # (name, space or definition) of the members named here, in order

    def name(self, member) -> str:
        name = self.names.get(id(member))
        if name is None:
            name = f"[anonymous #{self.next}]"
            self.next += 1
            self.names[id(member)] = name
            self.extra.append((name, member))
        return name


def save_alliscubesjson(universe, path: str) -> None:
    """Write a Universe in the reference's native `.alliscubesjson`
    format (save/schema.rs UniverseV1). The spaces that voxel blocks draw
    from and that are not members are written as anonymous members
    and Indirect blocks as the definition they name (`_MemberNames`)."""
    space_names = _MemberNames(universe)
    members = []
    queue = [*universe.spaces.items(), *getattr(universe, "block_defs", {}).items()]
    while queue or space_names.extra:
        if not queue:  # then the members the blocks so far named
            queue, space_names.extra = space_names.extra, []
        name, sp = queue.pop(0)
        if isinstance(sp, blockmod.BlockDef):
            members.append({"name": _name_to_schema(name), "member_type": "Block",
                            "value": _block_to_schema(sp.block, space_names)})
            continue
        contents = np.ascontiguousarray(sp.contents, dtype="<u2")
        st = universe.states.get(name)
        light_entry = None
        if st is not None and getattr(st, "light", None) is not None:
            light = st.light.cpu().numpy().copy()
            light[..., 3] = np.vectorize(
                lambda s: _LIGHT_STATUS_INV.get(int(s), 0)
            )(light[..., 3]).astype(np.uint8)
            light_entry = _gz_b64(np.ascontiguousarray(light, np.uint8).tobytes())
        sky = sp.physics.sky
        octants = np.asarray(sky.octants)
        sky_d = (
            {"type": "UniformV1", "color": [float(c) for c in octants[0]]}
            if (octants == octants[0]).all()
            else {"type": "OctantsV1", "colors": octants.tolist()}
        )
        members.append(
            {
                "name": _name_to_schema(name),
                "member_type": "Space",
                "value": {
                    "type": "SpaceV1",
                    "bounds": {
                        "lower": [int(v) for v in sp.bounds.lower],
                        "upper": [int(v) for v in sp.bounds.upper],
                    },
                    "physics": {
                        "gravity": [float(g) for g in sp.physics.gravity],
                        "sky": sky_d,
                        "light": (
                            {
                                "type": "RaysV1",
                                "maximum_distance": int(sp.physics.light_max_distance),
                            }
                            if sp.physics.light_enabled
                            else {"type": "NoneV1"}
                        ),
                    },
                    "blocks": [
                        _block_to_schema(b, space_names) for b in sp.palette
                    ],
                    "contents": _gz_b64(contents.tobytes()),
                    "light": light_entry,
                    "spawn": {
                        "type": "SpawnV1",
                        "bounds": {
                            "lower": [int(v) for v in sp.bounds.lower],
                            "upper": [int(v) for v in sp.bounds.upper],
                        },
                        "eye_position": (
                            [float(v) for v in sp.spawn_position]
                            if sp.spawn_position is not None
                            else None
                        ),
                        "look_direction": [0.0, 0.0, -1.0],
                        "inventory": [],
                    },
                },
            }
        )
    for name, sd in getattr(universe, "sounds", {}).items():
        members.append(
            {
                "name": _name_to_schema(name),
                "member_type": "Sound",
                "value": {
                    "type": "SynthesizedSoundV1",
                    "duration": float(sd.duration),
                    "frequency": float(sd.frequency),
                    "amplitude": float(sd.amplitude),
                },
            }
        )
    b = None
    if getattr(universe, "characters", None):
        from ..physics.body import body_to_numpy

        b = SimpleNamespace(**body_to_numpy(universe.bodies))
    for name, ch in getattr(universe, "characters", {}).items():
        i = ch.body_index
        members.append(
            {
                "name": _name_to_schema(name),
                "member_type": "Character",
                "value": {
                    "type": "CharacterV1",
                    "space": {"type": "HandleV1", **_name_to_schema(ch.space_name)},
                    "body": {
                        "type": "BodyV1",
                        "position": [float(v) for v in np.asarray(b.position[i])],
                        "velocity": [float(v) for v in np.asarray(b.velocity[i])],
                        "collision_box": {
                            "lower": [float(v) for v in np.asarray(b.box_lo[i])],
                            "upper": [float(v) for v in np.asarray(b.box_hi[i])],
                        },
                        "occupying": {
                            "lower": [
                                float(v)
                                for v in np.asarray(b.position[i] + b.occ_lo[i])
                            ],
                            "upper": [
                                float(v)
                                for v in np.asarray(b.position[i] + b.occ_hi[i])
                            ],
                        },
                        "flying": bool(b.flying[i]),
                        "noclip": bool(b.noclip[i]),
                        "yaw": float(b.yaw[i]),
                        "pitch": float(b.pitch[i]),
                    },
                    "selected_slots": [0, 0, 0],
                    "inventory": {"type": "InventoryV1", "slots": []},
                },
            }
        )
    with open(path, "w") as f:
        json.dump({"type": "UniverseV1", "members": members}, f)
