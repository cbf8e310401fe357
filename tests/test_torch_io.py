"""The port's save/load (aic_tpu_torch.io: save, vox, whence) against
`aic_tpu`'s, on the CPU.

The native format is the bridge between the packages, in both
directions: a universe saved by one loads in the other, and after the
load its spaces (bounds, contents, light, dirty marks, spawn, the palette
entry by entry evaluated the same), block definitions, behaviors,
characters and bodies equal the saved ones. Bodies are compared exactly:
both packages write them as JSON floats from f32 and read them back to
f32. `.vox` files are compared byte for byte.
"""

import numpy as np
import pytest
import torch

import aic_tpu.content as jc
import aic_tpu.io as jio
import aic_tpu.universe as jU
import aic_tpu_torch.content as tc
import aic_tpu_torch.io as tio
import aic_tpu_torch.universe as tU
from aic_tpu.io.whence import FileWhence as JFileWhence
from aic_tpu_torch.io.whence import FileWhence as TFileWhence
from aic_tpu_torch.physics.body import BODY_DTYPES, body_to_numpy
from test_torch_content import assert_evaluated_equal, assert_spaces_equal
from test_torch_state import PKGS

PK = {"jax": (PKGS["jax"], jU, jio, jc), "torch": (PKGS["torch"], tU, tio, tc)}


class JPulse(jU.Behavior):
    SCHEMA_TYPE = "test-io-pulse"

    def __init__(self, rate=1):
        self.rate = rate

    def to_schema(self):
        return {"rate": self.rate}

    @classmethod
    def from_schema(cls, d):
        return cls(d.get("rate", 1))


class TPulse(tU.Behavior):
    SCHEMA_TYPE = "test-io-pulse"

    def __init__(self, rate=1):
        self.rate = rate

    def to_schema(self):
        return {"rate": self.rate}

    @classmethod
    def from_schema(cls, d):
        return cls(d.get("rate", 1))


def rich_universe(pkg):
    """Voxel blocks (R4, through an anonymous space), a named BlockDef
    behind an Indirect block, a Become tick action, a behavior and a
    character whose body flies, looks and moves."""
    p, U, _io, _c = PK[pkg]
    b = p.block
    inner = p.Space(p.GridAab.cube(4))
    inner.fill(p.GridAab.from_lower_size((0, 0, 0), (4, 2, 4)), b.from_color((0.9, 0.8, 0.1, 1.0), "sand"))
    inner.set((1, 3, 1), b.from_color((0.2, 0.3, 0.9, 0.5), "glass"))
    sp = p.Space(p.GridAab.from_lower_size((-2, 0, -3), (8, 6, 7)),
                 physics=p.SpacePhysics(sky=p.Sky.uniform((0.3, 0.4, 0.5)), light_max_distance=10))
    sp.fill(p.GridAab.from_lower_size((-2, 0, -3), (8, 1, 7)), b.from_color((0.5, 0.5, 0.5, 1.0), "floor"))
    sp.set((0, 1, 0), b.Block(b.Recur(inner, resolution=4)))
    red, green = b.from_color((0.9, 0.1, 0.1, 1.0), "red"), b.from_color((0.1, 0.9, 0.1, 1.0), "green")
    U_op = __import__(f"{U.__name__}.op", fromlist=["Become"])
    sp.set((2, 1, 1), red.with_attributes(tick_action=U_op.Become(green), tick_period=3))
    lamp = b.BlockDef(b.from_color((1.0, 1.0, 0.9, 1.0), "lamp", emission=(2.0, 2.0, 1.5)), "lamp")
    sp.set((3, 3, -1), b.Block(b.Indirect(lamp)))
    sp.spawn_position = np.array([1.5, 2.0, 2.5])
    u = U.Universe(device="cpu") if pkg == "torch" else U.Universe()
    u.insert_block_def("lamp", lamp)
    u.insert_space("world", sp)
    u.insert_character("player", "world", (1.5, 2.0, 2.5))
    u.add_behavior("world", (TPulse if pkg == "torch" else JPulse)(rate=7))
    return u


def _set_body(u, pkg):
    """Fly, look and move the player (the same values in both)."""
    i = u.characters["player"].body_index
    if pkg == "torch":
        cols = body_to_numpy(u.bodies)
        cols["velocity"][i] = (0.5, -1.25, 3.0)
        cols["flying"][i], cols["yaw"][i], cols["pitch"][i] = True, 123.5, -17.25
        cols["box_lo"][i] = (-0.25, 0.0, -0.25)
        u.bodies = type(u.bodies)(**{k: torch.as_tensor(cols[k]).to(dt) for k, dt in BODY_DTYPES.items()})
    else:
        import dataclasses

        import jax.numpy as jnp

        b = u.bodies
        u.bodies = dataclasses.replace(
            b, velocity=b.velocity.at[i].set(jnp.asarray([0.5, -1.25, 3.0])), flying=b.flying.at[i].set(True),
            yaw=b.yaw.at[i].set(123.5), pitch=b.pitch.at[i].set(-17.25),
            box_lo=b.box_lo.at[i].set(jnp.asarray([-0.25, 0.0, -0.25])))


def assert_saved_space_equal(a, b):
    """`assert_spaces_equal` but for the dirty marks, which the format
    does not hold (a loaded space's are fresh, in both packages)."""
    dirty = b.light_dirty
    try:
        b.light_dirty = a.light_dirty
        assert_spaces_equal(a, b, snapshot=False)
    finally:
        b.light_dirty = dirty


def assert_universes_equal(a, b):
    """Every member of `b` (loaded) equals `a`'s (saved), across packages.
    A load also lists the anonymous spaces voxel blocks draw from
    (`__recur_*`); they are held through the palettes' evaluations."""
    assert sorted(n for n in b.spaces if not n.startswith("__recur_")) == sorted(a.spaces)
    for name in a.spaces:
        assert_saved_space_equal(a.spaces[name], b.spaces[name])
    assert sorted(b.block_defs) == sorted(a.block_defs)
    for name in a.block_defs:
        ea, eb = a.block_defs[name].block, b.block_defs[name].block
        assert type(eb.primitive).__name__ == type(ea.primitive).__name__
        assert_evaluated_equal(_evaluate(ea), _evaluate(eb), name)
    assert [(h, type(x).SCHEMA_TYPE, w, x.to_schema()) for h, x, w in b.behaviors] == [
        (h, type(x).SCHEMA_TYPE, w, x.to_schema()) for h, x, w in a.behaviors if getattr(x, "SCHEMA_TYPE", None)]
    assert {n: (c.space_name, c.body_index) for n, c in b.characters.items()} == {
        n: (c.space_name, c.body_index) for n, c in a.characters.items()}
    for k in BODY_DTYPES:
        if k in ("occ_lo", "occ_hi"):
            continue
        np.testing.assert_array_equal(np.asarray(getattr(b.bodies, k)), np.asarray(getattr(a.bodies, k)), err_msg=k)
    # The occupying box restarts as the collision box.
    np.testing.assert_array_equal(np.asarray(b.bodies.occ_lo), np.asarray(a.bodies.box_lo))


def _evaluate(block):
    mod = __import__(type(block).__module__.split(".")[0] + ".block", fromlist=["evaluate"])
    return mod.evaluate(block)


@pytest.mark.parametrize("direction", ["torch->jax", "jax->torch"])
@pytest.mark.parametrize("world", ["cornell-box", "rich"])
def test_save_loads_in_the_other_package(tmp_path, world, direction):
    src, dst = direction.split("->")
    if world == "rich":
        u = rich_universe(src)
        _set_body(u, src)
    else:
        p, U, _io, content = PK[src]
        params = content.TemplateParameters(size=8)
        u = content.build_universe("cornell-box", params, device="cpu") if src == "torch" else \
            content.build_universe("cornell-box", params)
    path = str(tmp_path / "u.json")
    PK[src][2].save_universe(u, path)
    loaded = PK[dst][2].load_universe(path, device="cpu") if dst == "torch" else PK[dst][2].load_universe(path)
    assert_universes_equal(u, loaded)
    if dst == "torch":
        assert loaded.states["world"].contents.device.type == "cpu"
        assert loaded.bodies.position.device.type == "cpu"


def _vox_space(pkg):
    p = PKGS[pkg]
    rng = np.random.default_rng(11)
    sp = p.Space(p.GridAab.from_lower_size((0, 0, 0), (6, 5, 4)))
    colors = rng.uniform(0, 1, (7, 3))
    for _ in range(40):
        c = rng.integers(0, 7)
        sp.set(tuple(int(v) for v in rng.integers(0, (6, 5, 4))),
               p.block.from_color(tuple(float(x) for x in colors[c]) + (1.0,), f"c{c}"))
    return sp


def test_vox_export_bytes_and_import_match_aic_tpu(tmp_path):
    jpath, tpath = str(tmp_path / "j.vox"), str(tmp_path / "t.vox")
    jio.export_vox(_vox_space("jax"), jpath)
    tio.export_vox(_vox_space("torch"), tpath)
    with open(jpath, "rb") as fj, open(tpath, "rb") as ft:
        assert ft.read() == fj.read()
    want, got = jio.import_vox(jpath), tio.import_vox(jpath)
    assert len(got) == len(want) == 1
    assert_spaces_equal(want[0], got[0], snapshot=False)


def test_file_whence_saves_back(tmp_path):
    """A universe opened from a file saves back to it: in the native
    format, in `.vox` and in the reference's `.alliscubesjson`, which the
    port reads back, and so does `aic_tpu`'s `FileWhence`: contents equal,
    the stored light bit for bit."""
    path = str(tmp_path / "doc.json")
    tio.save_universe(rich_universe("torch"), path)
    u = tio.load_universe_file(path, device="cpu")
    assert isinstance(u.whence, TFileWhence) and u.whence.document_name() == "doc.json"
    u.spaces["world"].set((4, 2, 2), PKGS["torch"].block.from_color((0.1, 0.2, 0.3, 1.0), "new"))
    u.whence.save(u)
    back = u.whence.load()
    assert_saved_space_equal(u.spaces["world"], back.spaces["world"])
    jback = JFileWhence(path).load()  # `aic_tpu` reads the saved-back file
    assert_saved_space_equal(u.spaces["world"], jback.spaces["world"])

    vox = str(tmp_path / "doc.vox")
    tio.export_vox(_vox_space("torch"), vox)
    uv = tio.load_universe_file(vox, device="cpu")
    uv.whence.save(uv)
    assert_saved_space_equal(tio.import_vox(vox)[0], uv.spaces["world"])

    ref = str(tmp_path / "doc.alliscubesjson")
    TFileWhence(ref, device="cpu").save(u)
    tref = tio.load_universe_file(ref, device="cpu")
    assert isinstance(tref.whence, TFileWhence) and tref.whence.document_name() == "doc.alliscubesjson"
    jref = JFileWhence(ref).load()
    for got in (tref, jref):
        np.testing.assert_array_equal(got.spaces["world"].contents, u.spaces["world"].contents)
        np.testing.assert_array_equal(np.asarray(got.states["world"].light), u.states["world"].light.numpy())
    with pytest.raises(ValueError):
        tU.Universe(device="cpu").whence.save(u)


# -- debug dumps, telemetry, sounds ------------------------------------------------


def test_debug_sheets_and_dump_match_aic_tpu(tmp_path):
    """`debug.py`'s light and skip-field sheets of a seeded cornell-box 8
    equal `aic_tpu`'s pixel for pixel, and `dump_state` writes the same
    diagnostics (its PNGs decode to those sheets)."""
    from aic_tpu import debug as jdebug
    from aic_tpu.light.refproc import fast_evaluate_seed as jseed
    from aic_tpu_torch import debug as tdebug
    from aic_tpu_torch.raytrace import decode_png
    from test_torch_state import to_port

    st, _ = jseed(PKGS["jax"].cornell_box(8).snapshot())
    tst = to_port(st)
    for name in ("light_slice_image", "skip_slice_image"):
        want = getattr(jdebug, name)(st)
        np.testing.assert_array_equal(getattr(tdebug, name)(tst), want, err_msg=name)
    paths = tdebug.dump_state(tst, str(tmp_path))
    np.testing.assert_array_equal(decode_png(open(paths["light_slices"], "rb").read()),
                                  jdebug._slice_sheet(jdebug.light_slice_image(st)))
    import json

    got = json.load(open(paths["state"]))
    assert got["size"] == list(np.asarray(st.contents).shape)
    assert got["light_status_counts"] == {
        k: int((np.asarray(st.light)[..., 3] == v).sum())
        for k, v in (("uninitialized", 0), ("no_rays", 1), ("opaque", 128), ("visible", 255))}


def test_telemetry_and_sounds_match_aic_tpu():
    """A universe with telemetry attached (a space and a behavior) writes
    one `universe_step` record a step with `aic_tpu`'s fields; the sound
    definitions synthesize the same PCM."""
    import io

    from aic_tpu import logging as jlog
    from aic_tpu.universe import sound as jsound
    from aic_tpu_torch import logging as tlog
    from aic_tpu_torch.universe import sound as tsound

    records = {}
    for pkg, log in (("jax", jlog), ("torch", tlog)):
        out = io.StringIO()
        p, U, _io, _c = PK[pkg]
        u = U.Universe(device="cpu") if pkg == "torch" else U.Universe()
        u.insert_space("world", p.Space(p.GridAab.from_lower_size((0, 0, 0), (4, 3, 4))))
        u.add_behavior("world", (TPulse if pkg == "torch" else JPulse)(rate=2))
        u.light_rounds_per_tick = 0
        log.Telemetry(stream=out).attach_to_universe(u)
        u.step()
        u.step()
        records[pkg] = [__import__("json").loads(ln) for ln in out.getvalue().splitlines()]
    assert [sorted(r) for r in records["torch"]] == [sorted(r) for r in records["jax"]]
    for k in ("tick", "space_edits", "light_updates", "behaviors"):
        assert [r[k] for r in records["torch"]] == [r[k] for r in records["jax"]], k
    assert len(records["torch"]) == 2 and records["torch"][0]["kind"] == "universe_step"
    for name, sd in jsound.DEFAULT_SOUNDS.items():
        np.testing.assert_array_equal(tsound.synthesize(tsound.DEFAULT_SOUNDS[name]), jsound.synthesize(sd))
    assert tsound.band_from_frequency(440.0) == jsound.band_from_frequency(440.0)
