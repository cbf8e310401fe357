"""The port's exports, camera script, record outputs, audio mixer and C++
reference relight (aic_tpu_torch.io.export, apps.record_script,
apps.audio, native.ref_relight_state, main --graphics record) against
`aic_tpu`, on the CPU.

glTF files are compared as JSON with each image's URI left out (the port
encodes the atlas with its own `encode_png`, `aic_tpu` with PIL), their
buffers byte for byte, and the atlas decoded; STL files byte for byte
from byte 80 on (the header names the writer). Animated PNGs are
compared as decoded frame sequences, each frame repeated by its
duration: PIL's writer merges identical frames and crops frames to what
changed, the port writes every frame whole. The record CLI runs both
packages' `main` in process on cornell-box 8 without the load relight
(the two relights may stop a pass apart), and once as a subprocess with
PIL and JAX blocked.
"""

import base64
import dataclasses
import functools
import io
import json
import os
import struct
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

import aic_tpu.apps.audio as jaudio
import aic_tpu.apps.record_script as jscript
import aic_tpu.io as jio
import aic_tpu.main as jmain
import aic_tpu.mesh as jmesh
import aic_tpu.native as jnative
import aic_tpu.raytrace as jraytrace
import aic_tpu_torch.apps.audio as taudio
import aic_tpu_torch.apps.record_script as tscript
import aic_tpu_torch.io as tio
import aic_tpu_torch.main as tmain
import aic_tpu_torch.mesh as tmesh
import aic_tpu_torch.native as tnative
import aic_tpu_torch.raytrace as traytrace
from aic_tpu.apps import Session as JSession
from aic_tpu.content import TemplateParameters as JParams
from aic_tpu.content import build_universe as j_build_universe
from aic_tpu.math import lightpack
from aic_tpu.raytrace import Camera as JCamera
from aic_tpu.raytrace import GraphicsOptions as JOptions
from aic_tpu.raytrace import Viewport as JViewport
from aic_tpu.universe.sound import SoundDef as JSound
from aic_tpu.universe.transaction import Fluff as JFluff
from aic_tpu_torch.apps import Session as TSession
from aic_tpu_torch.content import TemplateParameters as TParams
from aic_tpu_torch.content import build_universe as t_build_universe
from aic_tpu_torch.raytrace import Camera as TCamera
from aic_tpu_torch.raytrace import GraphicsOptions as TOptions
from aic_tpu_torch.raytrace import Viewport as TViewport
from aic_tpu_torch.raytrace.render import decode_png
from aic_tpu_torch.universe.sound import SoundDef as TSound
from aic_tpu_torch.universe.transaction import Fluff as TFluff
from test_torch_mesh import spaces
from test_torch_physics import ATOL, RTOL
from test_torch_state import PKGS, to_port

ROOT = Path(__file__).resolve().parents[1]


# -- 6. the exports -----------------------------------------------------------------


def _gltf(path):
    """(JSON without image URIs, buffer bytes, decoded images)."""
    doc = json.loads(Path(path).read_text())
    buffers = [base64.b64decode(b.pop("uri").split(",", 1)[1]) for b in doc["buffers"]]
    images = []
    for im in doc.get("images", []):
        png = base64.b64decode(im.pop("uri").split(",", 1)[1])
        images.append(np.asarray(Image.open(io.BytesIO(png)).convert("RGBA")))
    return doc, buffers, images


def assert_gltf_equal(jpath, tpath):
    jd, jb, ji = _gltf(jpath)
    td, tb, ti = _gltf(tpath)
    assert td == jd
    assert tb == jb
    assert len(ti) == len(ji)
    for a, b in zip(ji, ti):
        np.testing.assert_array_equal(b, a)
    return td


def _shifted_frames(pkg):
    """test_mesh_atlas.py's animation: a block moving along a row."""
    p, mesh = PKGS[pkg], {"jax": jmesh, "torch": tmesh}[pkg]
    frames = []
    for shift in range(3):
        sp = p.Space(p.GridAab.from_lower_size((0, 0, 0), (4, 1, 1)))
        sp.set((shift, 0, 0), p.block.from_color((1.0, 1.0, 0.0, 1.0)))
        frames.append(mesh.mesh_space_voxel_detail(sp))
    return frames


def test_gltf_matches_aic_tpu(tmp_path):
    cases = {"single block": lambda m, s: m.mesh_space(s), "checker4": lambda m, s: m.mesh_space_textured(s),
             "mixed 12^3": lambda m, s: m.mesh_space_textured(s),
             "voxels 20^3": lambda m, s: m.mesh_space_voxel_detail(s, style="unit"),
             # Unshrunk u32 indices.
             "random8": lambda m, s: dataclasses.replace(m.mesh_space(s), indices=np.arange(30, dtype=np.uint32))}
    for name, make in cases.items():
        js, ts = spaces(name)
        jio.export_gltf(make(jmesh, js), str(tmp_path / "j.gltf"))
        tio.export_gltf(make(tmesh, ts), str(tmp_path / "t.gltf"))
        doc = assert_gltf_equal(tmp_path / "j.gltf", tmp_path / "t.gltf")
        prim = doc["meshes"][0]["primitives"][0]
        assert ("TEXCOORD_0" in prim["attributes"]) == (name in ("checker4", "mixed 12^3")), name
        assert doc["accessors"][prim["indices"]]["componentType"] == (5125 if name == "random8" else 5123)
    # The port's atlas PNG is decodable without an imaging library.
    js, ts = spaces("checker4")
    tio.export_gltf(tmesh.mesh_space_textured(ts), str(tmp_path / "t.gltf"))
    uri = json.loads((tmp_path / "t.gltf").read_text())["images"][0]["uri"]
    np.testing.assert_array_equal(decode_png(base64.b64decode(uri.split(",", 1)[1])),
                                  tmesh.mesh_space_textured(ts).texture)


def test_gltf_animation_matches_aic_tpu(tmp_path):
    cams = [[0, 0, 5], [1, 0, 5], [2, 0, 5]]
    jio.export_gltf_animation(_shifted_frames("jax"), str(tmp_path / "j.gltf"), camera_positions=cams)
    tio.export_gltf_animation(_shifted_frames("torch"), str(tmp_path / "t.gltf"), camera_positions=cams)
    doc = assert_gltf_equal(tmp_path / "j.gltf", tmp_path / "t.gltf")
    assert len(doc["animations"][0]["channels"]) == 4 and len(doc["nodes"]) == 4
    js, ts = spaces("checker4")
    jio.export_gltf_animation([jmesh.mesh_space_textured(js)] * 2, str(tmp_path / "j.gltf"), frame_pace=0.1)
    tio.export_gltf_animation([tmesh.mesh_space_textured(ts)] * 2, str(tmp_path / "t.gltf"), frame_pace=0.1)
    assert len(assert_gltf_equal(tmp_path / "j.gltf", tmp_path / "t.gltf")["images"]) == 2


def test_stl_matches_aic_tpu_from_byte_80(tmp_path):
    js, ts = spaces("mixed 12^3")
    pairs = [(jmesh.mesh_space(spaces("single block")[0]), tmesh.mesh_space(spaces("single block")[1])),
             (jmesh.mesh_space_voxel_detail(js), tmesh.mesh_space_voxel_detail(ts))]
    # A degenerate triangle gets a zero normal in both.
    degenerate = np.array([[0, 0, 0], [1, 1, 1], [2, 2, 2], [0, 1, 0]], np.float32)
    pairs.append(tuple(m.SpaceMesh(degenerate, np.ones((4, 4), np.float32), np.array([0, 1, 2, 0, 3, 1], np.uint32))
                       for m in (jmesh, tmesh)))
    for jm, tm in pairs:
        jio.export_stl(jm, str(tmp_path / "j.stl"))
        tio.export_stl(tm, str(tmp_path / "t.stl"))
        a, b = (tmp_path / "j.stl").read_bytes(), (tmp_path / "t.stl").read_bytes()
        assert b[80:] == a[80:]
        assert len(b) == 84 + 50 * tm.triangle_count
        assert b[:80].rstrip(b"\0") == b"aic_tpu_torch binary STL"


# -- 7. the camera script ------------------------------------------------------------


SCRIPTS = [
    {"position": {"times": [0.0, 2.0], "values": [[0, 0, 0], [10, 4, 2]]}},
    {"position": {"times": [1.0, 2.0], "values": [[1, 1, 1], [3, 3, 3]]}},
    {"position": {"times": [1.0, 1.0], "values": [[0, 0, 0], [2, 2, 2]]}},
    {"position": {"times": [0.0, 0.5, 3.0], "values": [[1, 6, 1], [7, 6, 7], [-2, 3, 0.5]]},
     "look_direction": {"times": [0.0, 1.0], "values": [[0, 0, -1], [1, -0.5, 0.25]]}},
    {"look_direction": {"times": [0.0], "values": [[0.3, 0.2, -1]]}},
]


@pytest.mark.parametrize("case", range(len(SCRIPTS)))
def test_camera_script_matches_aic_tpu(case, tmp_path):
    d = SCRIPTS[case]
    js, ts = jscript.CameraScript.from_dict(d), tscript.CameraScript.from_dict(d)
    for t in np.linspace(-0.5, 3.5, 41):
        for ch in ("position", "look_direction"):
            a, b = getattr(js, ch), getattr(ts, ch)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(b.get(t), a.get(t))
        jc, tc = JCamera(JOptions(), JViewport(8, 8)), TCamera(TOptions(), TViewport(8, 8))
        js.camera_at(t, jc, (9, 9, 9), (5, 5, -10))
        ts.camera_at(t, tc, (9, 9, 9), (5, 5, -10))
        np.testing.assert_array_equal(tc.eye_to_world, np.asarray(jc.eye_to_world))
    for s in (js, ts):
        s.add_frame(4.0, (4, 0, 0), (1, 0, 0))
    assert ts.to_dict() == js.to_dict()
    (tmp_path / "s.json").write_text(json.dumps(ts.to_dict()))
    assert tscript.CameraScript.from_file(str(tmp_path / "s.json")).to_dict() == js.to_dict()


def test_camera_script_rejects_what_aic_tpu_rejects():
    for bad in ({"position": {"times": [2.0, 1.0], "values": [[0, 0, 0], [1, 1, 1]]}},
                {"position": {"times": [0.0], "values": [[0, 0], [1, 1]]}}):
        for mod in (jscript, tscript):
            with pytest.raises(ValueError):
                mod.CameraScript.from_dict(bad)


def _bodies(u, i):
    b = u.bodies
    return {k: np.asarray(getattr(b, k).cpu() if isinstance(getattr(b, k), torch.Tensor) else getattr(b, k))[i]
            for k in ("position", "velocity", "yaw", "pitch")}


def test_performance_drives_the_body_like_aic_tpu():
    """The script's position and look written into the player's body:
    exactly equal after the behavior's own step, and after 30 ticks
    (physics after each) within the physics tests' tolerance, the look
    exactly."""
    d = SCRIPTS[3]
    uj = j_build_universe("cornell-box", JParams(size=8))
    ut = t_build_universe("cornell-box", TParams(size=8), device="cpu")
    perf = {}
    for u, mod in ((uj, jscript), (ut, tscript)):
        u.light_rounds_per_tick = 0
        perf[mod] = mod.Performance(mod.CameraScript.from_dict(d))
        tick = dataclasses.make_dataclass("Tick", ["dt"])(dt=1 / 60)
        assert perf[mod].step(u, "player", tick) == (None, "step")
        perf[mod].time = 0.0
    i = ut.characters["player"].body_index
    for k, v in _bodies(uj, i).items():
        np.testing.assert_array_equal(_bodies(ut, i)[k], v, err_msg=k)
    uj.add_behavior("player", perf[jscript])
    ut.add_behavior("player", perf[tscript])
    for n in range(30):
        uj.step()
        ut.step()
        a, b = _bodies(uj, i), _bodies(ut, i)
        np.testing.assert_allclose(b["position"], a["position"], atol=ATOL, rtol=RTOL, err_msg=f"tick {n}")
        np.testing.assert_array_equal(b["yaw"], a["yaw"])
        np.testing.assert_array_equal(b["pitch"], a["pitch"])
    assert b["position"][0] > 1.5  # moved along the scripted path
    bare = tscript.Performance(tscript.CameraScript.from_dict(d), character_name="nobody")
    assert bare.step(ut, "player", None) == (None, "drop")


# -- 8. main --graphics record --------------------------------------------------------


CLI_SCRIPT = {"position": {"times": [0.0, 0.1], "values": [[4.0, 4.0, 8.5], [2.5, 4.5, 8.0]]},
              "look_direction": {"times": [0.0, 0.1], "values": [[0.0, -0.1, -1.0], [0.3, -0.2, -1.0]]}}
CLI_ARGS = ["--template", "cornell-box", "--size", "8", "--graphics", "record", "--no-relight", "--width", "24",
            "--height", "16"]


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """Both packages' `main --graphics record` outputs: a 3-frame APNG
    along a camera script, an animated glTF of 2 stepped frames, an STL."""
    d = tmp_path_factory.mktemp("record")
    (d / "s.json").write_text(json.dumps(CLI_SCRIPT))
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        # No bloom: `aic_tpu`'s bloom costs a 16 s compile on the CPU (the
        # port's bloom is held against it in tests/test_torch_slice.py).
        for raytrace in (jraytrace, traytrace):
            mp.setattr(raytrace, "GraphicsOptions", functools.partial(raytrace.GraphicsOptions, bloom_intensity=0.0))
        for pkg, main, extra in (("jax", jmain.main, []), ("torch", tmain.main, ["--device", "cpu"])):
            outs[pkg] = {k: d / f"{pkg}.{k}" for k in ("png", "gltf", "stl")}
            main(CLI_ARGS + extra + ["--frames", "3", "--camera-script", str(d / "s.json"),
                                     "--output", str(outs[pkg]["png"])])
            main(CLI_ARGS + extra + ["--frames", "2", "--output", str(outs[pkg]["gltf"])])
            main(CLI_ARGS + extra + ["--output", str(outs[pkg]["stl"])])
    return outs


def apng_frames(path):
    """The decoded frames of an animated PNG, each repeated by its
    duration in units of 1000 // 30 ms."""
    out = []
    with Image.open(path) as im:
        for frame in ImageSequence.Iterator(im):
            reps = int(round(frame.info["duration"] / (1000 // 30)))
            out += [np.asarray(frame.convert("RGBA"))] * reps
    return out


def test_record_apng_matches_aic_tpu(recorded):
    a, b = apng_frames(recorded["jax"]["png"]), apng_frames(recorded["torch"]["png"])
    assert len(a) == len(b) == 3
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(y, x, err_msg=f"frame {i}")
        assert y[..., :3].max() > 0, i
    data = recorded["torch"]["png"].read_bytes()
    assert data.count(b"fcTL") == 3 and data.count(b"acTL") == 1
    np.testing.assert_array_equal(decode_png(data), b[0])


def test_record_gltf_and_stl_match_aic_tpu(recorded):
    doc = assert_gltf_equal(recorded["jax"]["gltf"], recorded["torch"]["gltf"])
    assert len(doc["nodes"]) == 2 and len(doc["animations"][0]["channels"]) == 2
    a, b = recorded["jax"]["stl"].read_bytes(), recorded["torch"]["stl"].read_bytes()
    assert b[80:] == a[80:] and len(b) > 84


def test_record_cli_needs_neither_pil_nor_jax(tmp_path):
    """`python -m aic_tpu_torch.main --device cpu --graphics record` to
    .gltf, .stl and a 3-frame .png, with PIL and JAX blocked; the outputs
    equal what the port's functions write."""
    (tmp_path / "s.json").write_text(json.dumps(CLI_SCRIPT))
    runs = [["--output", str(tmp_path / "c.gltf")], ["--output", str(tmp_path / "c.stl")],
            ["--frames", "3", "--camera-script", str(tmp_path / "s.json"), "--output", str(tmp_path / "c.png")]]
    code = (
        "import runpy, sys\n"
        "for name in ('PIL', 'jax', 'aic_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for extra in {runs!r}:\n"
        f"    sys.argv = ['aic_tpu_torch.main'] + {CLI_ARGS!r} + ['--device', 'cpu'] + extra\n"
        "    runpy.run_module('aic_tpu_torch.main', run_name='__main__', alter_sys=True)\n"
        "bad = [m for m in sys.modules if m.startswith(('PIL.', 'jax.', 'aic_tpu.')) and sys.modules[m]]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    space = PKGS["torch"].cornell_box(8)
    mesh = tmesh.mesh_space_textured(space)
    tio.export_gltf(mesh, str(tmp_path / "f.gltf"))
    assert (tmp_path / "c.gltf").read_bytes() == (tmp_path / "f.gltf").read_bytes()
    doc = json.loads((tmp_path / "c.gltf").read_text())
    prim = doc["meshes"][0]["primitives"][0]
    assert doc["accessors"][prim["attributes"]["POSITION"]]["count"] == len(mesh.positions)
    assert doc["accessors"][prim["indices"]]["count"] == 3 * mesh.triangle_count
    tio.export_stl(tmesh.mesh_space_voxel_detail(space), str(tmp_path / "f.stl"))
    assert (tmp_path / "c.stl").read_bytes() == (tmp_path / "f.stl").read_bytes()
    png = (tmp_path / "c.png").read_bytes()
    assert png.count(b"fcTL") == 3
    assert struct.unpack(">II", png[png.index(b"acTL") + 4 : png.index(b"acTL") + 12]) == (3, 0)
    assert decode_png(png).shape == (16, 24, 4)


# -- 9. audio ------------------------------------------------------------------------


def test_mixer_and_spatialize_match_aic_tpu():
    mixers = {}
    for mod, snd in ((jaudio, JSound), (taudio, TSound)):
        m = mod.AudioMixer()
        m.schedule(snd(frequency=440.0, duration=0.05), 0.0, gain=1.0, pan=-1.0)
        m.schedule(snd(frequency=880.0, duration=0.05, waveform="square"), 0.1, gain=0.7, pan=0.3)
        m.schedule(snd(waveform="noise", duration=0.02), 0.03, gain=2.5, pan=2.0)
        m.schedule(snd(frequency=220.0), 0.2, gain=0.0)
        mixers[mod] = m.take()
    np.testing.assert_array_equal(mixers[taudio], mixers[jaudio])
    rng = np.random.default_rng(9)
    for _ in range(50):
        lp, sp = rng.uniform(-30, 30, 3), rng.uniform(-30, 30, 3)
        yaw = float(rng.uniform(-360, 360))
        assert taudio.spatialize(lp, yaw, sp) == jaudio.spatialize(lp, yaw, sp)
    assert taudio.spatialize((1, 2, 3), 10.0, (1, 2, 3)) == jaudio.spatialize((1, 2, 3), 10.0, (1, 2, 3))


def test_session_audio_wav_matches_aic_tpu(tmp_path):
    """test_aux.py's session audio: fluff drained, spatialized against
    the player's body and mixed; the WAV bytes equal."""
    wavs = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            u = j_build_universe("cornell-box", JParams(size=8))
            s, audio_mod, fluff = JSession(u, viewport=JViewport(8, 8)), jaudio, JFluff
        else:
            u = t_build_universe("cornell-box", TParams(size=8), device="cpu")
            s, audio_mod, fluff = TSession(u, viewport=TViewport(8, 8)), taudio, TFluff
        u.light_rounds_per_tick = 0
        path = tmp_path / f"{pkg}.wav"
        audio = audio_mod.SessionAudio(s, audio_mod.WavFileSink(str(path)))
        u._emit_fluff([fluff("Place", (4, 4, 4))])
        assert audio.pump(now=0.0) == 1
        u._emit_fluff([fluff("Destroy", (1, 2, 7)), fluff("NoSuchSound", (0, 0, 0))])
        assert audio.pump(now=0.25) == 1
        u._emit_fluff([fluff("Place", (9, 0, 3))])
        assert audio.pump(now=0.4) == 1
        audio.flush()
        wavs[pkg] = (path.read_bytes(), audio.mixer.take())
    assert wavs["torch"][0] == wavs["jax"][0]
    np.testing.assert_array_equal(wavs["torch"][1], wavs["jax"][1])
    with wave.open(str(tmp_path / "torch.wav")) as w:
        assert w.getnchannels() == 2 and w.getnframes() > 0.4 * 44100


# -- 10. the reference relight -------------------------------------------------------


@pytest.fixture(scope="module")
def cornell8_state():
    return PKGS["jax"].cornell_box(8).snapshot()


def test_ref_relight_matches_aic_tpu(cornell8_state):
    """Two runs of `aic_tpu`'s reference relight are bit-equal, so the
    port's is held to them bit for bit: statuses, packed light, updates."""
    j1 = jnative.ref_relight_state(cornell8_state, return_light=True)
    j2 = jnative.ref_relight_state(cornell8_state, return_light=True)
    np.testing.assert_array_equal(j2[2], j1[2])
    assert j2[1] == j1[1] > 0
    t = tnative.ref_relight_state(to_port(cornell8_state), return_light=True)
    assert t[1] == j1[1] and t[0] > 0
    np.testing.assert_array_equal(t[2][..., 3], j1[2][..., 3])
    np.testing.assert_array_equal(t[2], j1[2])
    assert (j1[2][..., 3] == lightpack.STATUS_VISIBLE).any()
    # The port's own snapshot of cornell-box 8 gives the same light.
    t2 = tnative.ref_relight_state(PKGS["torch"].cornell_box(8).snapshot(device="cpu"), return_light=True)
    np.testing.assert_array_equal(t2[2], j1[2])
    secs, updates = tnative.ref_relight_state(to_port(cornell8_state))
    assert updates == j1[1] and secs > 0


def test_ref_relight_light_bench_runs():
    secs, n = tnative.ref_relight_light_bench()
    assert n == 54 * 16 * 54 and secs > 0
