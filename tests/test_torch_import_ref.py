"""The port's reference-schema IO (`aic_tpu_torch.io.import_ref`,
`.alliscubesjson`) against `aic_tpu`'s, on the CPU.

tests/test_import_ref.py's universe (a voxel block over a named space, an
emitter with a display name, a rotated and tagged block, a chest with an
inventory and its icons, a composite), with that file's other cases
added to it (a sound member, a block with tick and activation actions
and an animation hint, the composite of two inventory blocks, anonymous
spaces through the Recur garbage collection), is built in both packages
and relit by `aic_tpu`; the port's state takes the same light. Each
package writes the universe, and each file loads in both packages: the
warnings, the spaces (bounds, contents, palette evaluated entry by entry,
the snapshot's arrays: contents, light bit for bit, cells, the evaluated
face colours and every other table), the bodies and the sounds are the
same whichever package wrote or read the file. The hand-made document
whose palette slot 0 is not air loads the same in both.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import aic_tpu.io.import_ref as jref
import aic_tpu.universe as jU
import aic_tpu_torch.io.import_ref as tref
import aic_tpu_torch.main as tmain
import aic_tpu_torch.universe as tU
from aic_tpu.light import evaluate_light
from test_import_ref import _minimal_space_doc
from test_torch_content import assert_spaces_equal
from test_torch_state import PKGS, fresh_pallas_caches  # noqa: F401 (autouse)

PK = {"jax": (PKGS["jax"], jU, jref), "torch": (PKGS["torch"], tU, tref)}


def build_universe(pkg):
    p, U, _io = PK[pkg]
    b = p.block
    op = __import__(f"{U.__name__}.op", fromlist=["Become"])
    sound = __import__(f"{U.__name__}.sound", fromlist=["SoundDef"])
    u = U.Universe(device="cpu") if pkg == "torch" else U.Universe()
    vox = p.Space(p.GridAab.from_lower_size((0, 0, 0), (4, 4, 4)))
    for x in range(4):
        vox.set((x, 0, 0), b.from_color((1.0, 0.0, 0.0, 1.0)))
    u.insert_space("vox", vox)
    # Anonymous spaces: one a voxel block's source, one that the GC drops.
    anon = p.Space(p.GridAab.from_lower_size((0, 0, 0), (4, 4, 4)))
    anon.set((1, 1, 1), b.from_color((0.1, 0.8, 0.8, 1.0)))
    u.insert_anonymous(anon)
    u.insert_anonymous(p.Space(p.GridAab.from_lower_size((0, 0, 0), (2, 2, 2))))

    sp = p.Space(p.GridAab.from_lower_size((-2, 0, -2), (5, 4, 5)),
                 physics=p.SpacePhysics(sky=p.Sky.uniform((0.6, 0.7, 0.9))))
    sp.set((0, 0, 0), b.Block(b.Recur(space=vox, resolution=4)))
    sp.set((1, 0, 0), b.Block(b.Atom(color=(0.2, 0.9, 0.3, 1.0), emission=(1.0, 2.0, 0.5)))
           .with_attributes(display_name="emitter"))
    rot = __import__(f"{p.GridAab.__module__}", fromlist=["rotation_from_name"]).rotation_from_name
    sp.set((2, 0, 0), b.from_color((0.5, 0.5, 0.5, 1.0)).with_modifier(b.Rotate(rot("RXZy")))
           .with_modifier(b.Tag("marker")))
    sp.set((0, 1, 0), b.from_color((0.3, 0.2, 0.1, 1.0), "chest")
           .with_attributes(inventory=b.InvInBlock.default_for_size(2))
           .with_modifier(b.InventoryModifier(icons=(b.from_color((1, 1, 0, 1)), None))))
    sp.set((1, 1, 0), b.from_color((0.1, 0.1, 0.9, 0.5))
           .with_modifier(b.Composite(source=b.from_color((0.9, 0.1, 0.1, 1.0)), operator="atop")))
    target = b.from_color((0.0, 0.0, 1.0, 1.0), "target")
    sp.set((2, 1, 0), b.from_color((1.0, 0.5, 0.0, 1.0), "ticker")
           .with_attributes(tick_action=op.Become(target), tick_period=3)
           .with_attributes(activation_action=op.DestroyTo(target)).with_attributes(animated=True))
    row = lambda n, y: (b.IconRow(first_slot=0, count=n, origin=(0, y, 12), stride=(4, 0, 0)),)  # noqa: E731
    inv = lambda n, y: b.InvInBlock(inventory_size=n, icon_scale=4, render_resolution=16,  # noqa: E731
                                    icon_rows=row(n, y))
    sp.set((0, 2, 0), b.from_color((0.5, 0.5, 0.5, 1.0)).with_attributes(inventory=inv(2, 0)).with_modifier(
        b.Composite(source=b.from_color((0.2, 0.8, 0.2, 1.0)).with_attributes(inventory=inv(3, 4)),
                    operator="atop")))
    sp.set((1, 2, 0), b.Block(b.Recur(space=anon, resolution=4)))
    u.insert_space("world", sp)
    assert u.gc() == 1  # the orphan; the voxel block keeps its source
    u.insert_character("player", "world", (0.5, 2.0, 0.5))
    u.sounds["ding"] = sound.SoundDef(frequency=523.25, duration=0.12, amplitude=0.4)
    return u


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Each package's file of the universe, with `aic_tpu`'s light, and
    each file loaded by each package: {(writer, reader): (u, warnings)}."""
    ju, tu = build_universe("jax"), build_universe("torch")
    ju.states["world"], _ = evaluate_light(ju.get_state("world"))
    tu.states["world"] = dataclasses.replace(tu.states["world"],
                                             light=torch.as_tensor(np.array(ju.states["world"].light)))
    d = tmp_path_factory.mktemp("ref")
    paths = {"jax": str(d / "j.alliscubesjson"), "torch": str(d / "t.alliscubesjson")}
    jref.save_alliscubesjson(ju, paths["jax"])
    tref.save_alliscubesjson(tu, paths["torch"])
    loaded = {(w, "jax"): jref.load_alliscubesjson(paths[w]) for w in paths}
    loaded.update({(w, "torch"): tref.load_alliscubesjson(paths[w], device="cpu") for w in paths})
    return ju, paths, loaded


#: (writer of the file `aic_tpu` reads, writer of the file the port reads):
#: each file read by both packages, and `aic_tpu`'s file by `aic_tpu`
#: against the port's by the port.
PAIRS = [("jax", "jax"), ("torch", "torch"), ("jax", "torch")]


@pytest.mark.parametrize("jwriter,twriter", PAIRS)
def test_files_load_in_both_packages(files, jwriter, twriter):
    ju, _paths, loaded = files
    want, want_warn = loaded[jwriter, "jax"]
    got, got_warn = loaded[twriter, "torch"]
    assert got_warn == want_warn == []
    assert sorted(got.spaces) == sorted(want.spaces)
    for name in want.spaces:
        assert_spaces_equal(want.spaces[name], got.spaces[name], snapshot=True)
    assert sorted(got.states) == sorted(want.states)
    for name in want.states:
        np.testing.assert_array_equal(got.states[name].light.numpy(), np.asarray(want.states[name].light))
        np.testing.assert_array_equal(got.states[name].tables.face_colors.numpy(),
                                      np.asarray(want.states[name].tables.face_colors))
    np.testing.assert_array_equal(got.states["world"].light.numpy(), np.asarray(ju.states["world"].light))
    assert {n: c.space_name for n, c in got.characters.items()} == {"player": "world"}
    for k in ("position", "velocity", "flying", "noclip", "yaw", "pitch"):
        np.testing.assert_array_equal(getattr(got.bodies, k).numpy(), np.asarray(getattr(want.bodies, k)))
    sd, wd = got.sounds["ding"], want.sounds["ding"]
    assert (sd.waveform, sd.frequency, sd.duration, sd.amplitude) == (
        wd.waveform, wd.frequency, wd.duration, wd.amplitude)
    attrs = got.spaces["world"].block_at((2, 1, 0)).attributes
    assert type(attrs.tick_action).__name__ == "Become" and attrs.tick_period == 3
    assert type(attrs.activation_action).__name__ == "DestroyTo" and attrs.animated is True


def test_palette_zero_fill_loads_the_same(tmp_path):
    solid = {"type": "BlockV1", "primitive": {"type": "AtomV1", "color": [0.9, 0.1, 0.1, 1.0]}}
    air = {"type": "BlockV1", "primitive": {"type": "AirV1"}}
    contents = np.zeros((2, 2, 2), dtype=np.uint16)
    contents[1, 1, 1] = 1
    path = tmp_path / "fill.alliscubesjson"
    path.write_text(json.dumps(_minimal_space_doc([solid, air], contents)))
    ju, jw = jref.load_alliscubesjson(str(path))
    tu, tw = tref.load_alliscubesjson(str(path), device="cpu")
    assert tw == jw
    assert_spaces_equal(ju.spaces["world"], tu.spaces["world"], snapshot=True)
    assert type(tu.spaces["world"].block_at((0, 0, 0)).primitive).__name__ == "Atom"


def test_main_opens_a_reference_file(files, capsys):
    path = files[1]["torch"]
    tmain.main([path, "--graphics", "print", "--width", "16", "--height", "8", "--device", "cpu", "--no-relight"])
    out, err = capsys.readouterr()
    assert "[open] t.alliscubesjson" in err
    assert out.count("\n") == 4


def _indirect_universe(cyclic):
    """A world with an Indirect block and a voxel block over a space that
    is not a member; with `cyclic`, the definition's tick action becomes a
    second definition (not a member) whose tick action becomes the first."""
    p, U, _io = PK["torch"]
    b = p.block
    free = p.Space(p.GridAab.cube(4))
    free.set((1, 2, 3), b.from_color((0.2, 0.4, 0.9, 1.0)))
    lamp = b.BlockDef(b.from_color((1.0, 1.0, 0.9, 1.0), "lamp", emission=(2.0, 2.0, 1.5)), "lamp")
    if cyclic:
        off = b.BlockDef(b.AIR, "off")
        lamp.block = lamp.block.with_attributes(tick_action=U.Become(b.Block(b.Indirect(off))), tick_period=4)
        off.block = b.from_color((0.1, 0.1, 0.1, 1.0), "off").with_attributes(
            tick_action=U.Become(b.Block(b.Indirect(lamp))), tick_period=4)
    u = U.Universe(device="cpu")
    u.insert_block_def("lamp", lamp)
    sp = p.Space(p.GridAab.from_lower_size((0, 0, 0), (4, 3, 4)))
    sp.set((0, 0, 0), b.Block(b.Indirect(lamp)))
    sp.set((1, 0, 0), b.Block(b.Recur(space=free, resolution=4)))
    u.insert_space("world", sp)
    return u


def test_indirect_blocks_and_free_spaces_load_in_both(tmp_path):
    """What `aic_tpu` refuses to write, the port writes as the reference
    holds it: an Indirect block names its definition (a Block member), a
    voxel block's free space is an anonymous member. Both packages read
    the file alike: `aic_tpu` puts the definition's block in place of the
    Indirect one, the port an Indirect over the loaded definition."""
    u = _indirect_universe(cyclic=False)
    path = str(tmp_path / "ind.alliscubesjson")
    tref.save_alliscubesjson(u, path)
    ju, jw = jref.load_alliscubesjson(path)
    tu, tw = tref.load_alliscubesjson(path, device="cpu")
    assert tw == jw == []
    assert_spaces_equal(ju.spaces["world"], tu.spaces["world"], snapshot=True)
    np.testing.assert_array_equal(tu.spaces["world"].contents, u.spaces["world"].contents)
    assert tu.spaces["world"].block_at((0, 0, 0)).primitive.block_def is tu.block_defs["lamp"]


def test_definitions_that_name_each_other_load_in_the_port(tmp_path):
    u = _indirect_universe(cyclic=True)
    path = str(tmp_path / "cyc.alliscubesjson")
    tref.save_alliscubesjson(u, path)
    tu, tw = tref.load_alliscubesjson(path, device="cpu")
    assert tw == []
    lamp = tu.block_defs["lamp"]
    off = lamp.block.attributes.tick_action.block.primitive.block_def
    assert off.block.attributes.tick_action.block.primitive.block_def is lamp
    sp, got = u.spaces["world"], tu.spaces["world"]
    np.testing.assert_array_equal(got.contents, sp.contents)
    for i in range(sp.palette_len()):
        np.testing.assert_array_equal(got.evaluated(i).face_colors, sp.evaluated(i).face_colors)
