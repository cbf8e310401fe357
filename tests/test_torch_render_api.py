"""The port's render API around the general tracer
(`aic_tpu_torch.raytrace.render`, `ortho`, `renderer`, `space.state`'s
windowing, `main --graphics print`) against `aic_tpu`'s, on the CPU.

Both packages render the same state (`to_port`) through the same camera.
One options object and one viewport serve every case that can share an
`aic_tpu` compile (its `trace_rays` compiles once per state shape,
option set and ray shape). Tolerances: images within ±1 per channel on
≥ 99.9% of pixels (tests/test_torch_slice.py's), step counts and hit
kinds equal, depth within 1e-5 relative, flaws equal.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aic_tpu.space.state as jstate
import aic_tpu_torch.space.state as tstate
from aic_tpu.raytrace import Camera as JCamera
from aic_tpu.raytrace import GraphicsOptions as JOptions
from aic_tpu.raytrace import Viewport as JViewport
from aic_tpu.raytrace import ortho as jortho
from aic_tpu.raytrace import renderer as jrenderer
from aic_tpu_torch.raytrace import Camera, Viewport
from aic_tpu_torch.raytrace import ortho as tortho
from aic_tpu_torch.raytrace import renderer as trenderer
from aic_tpu_torch.raytrace import trace_kernel, trace_kernel_v1
from aic_tpu_torch.raytrace.tracer import trace_rays
from test_torch_state import PKGS, fresh_pallas_caches, to_port  # noqa: F401 (autouse)
from test_torch_trace import torch_options
from test_torch_tracer import scene_cornell, scene_r64
from test_window import big_space

# The packages export a `render` function that hides the module's name.
jrender = importlib.import_module("aic_tpu.raytrace.render")
trender = importlib.import_module("aic_tpu_torch.raytrace.render")

W, H = 32, 24
EYE, TARGET = (8.0, 8.0, 28.0), (8.0, 7.0, 8.0)
#: The renderer's character stands inside the box, within cursor reach
#: (6 cubes) of the floor.
RT_EYE, RT_TARGET = (8.0, 3.0, 3.0), (8.0, 0.0, 0.0)
# No bloom: `aic_tpu`'s bloom costs a 16 s compile on the CPU, and the
# port's bloom is held against it in tests/test_torch_slice.py.
JOPTS = JOptions(lighting_display="smoothstep", fog="none", bloom_intensity=0.0)
TOPTS = torch_options(JOPTS)


def cameras(w=W, h=H, opts=JOPTS, eye=EYE, target=TARGET):
    jcam = JCamera(opts, JViewport(w, h))
    jcam.look_at(eye, target)
    tcam = Camera(torch_options(opts), Viewport(w, h))
    tcam.look_at(eye, target)
    return jcam, tcam


def assert_images_close(got, want):
    assert got.flaws == want.flaws
    assert got.data.shape == want.data.shape
    close = np.abs(got.data.astype(np.int32) - want.data.astype(np.int32)).max(-1) <= 1
    assert close.mean() >= 0.999, close.mean()


@pytest.fixture(scope="module")
def cornell():
    st = scene_cornell()
    return st, to_port(st)


# -- the render functions ------------------------------------------------------


def test_pixel_cost_matches_aic_tpu(cornell):
    jst, tst = cornell
    jcam, tcam = cameras()
    want = jrender.render_pixel_cost(jst, jcam)
    got = trender.render_pixel_cost(tst, tcam)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.data[..., 0].max() == 255 and len(np.unique(got.data[..., 0])) >= 3


def test_depth_and_hit_folds_match_aic_tpu(cornell):
    jst, tst = cornell
    jcam, tcam = cameras()
    want = np.asarray(jrender.render_depth(jst, jcam))
    got = trender.render_depth(tst, tcam).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isfinite(got).mean() > 0.3
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], rtol=1e-5, atol=0)

    def fold(acc, hits):
        n, t = acc
        hit = hits["hit_kind"] != 0
        return n + hit, t + np.where(np.asarray(hit), np.asarray(hits["hit_t"]), 0.0)

    zero = np.zeros(W * H)
    wn, wt = jrender.accumulate_hits(jst, jcam, fold, (zero, zero))
    tn, tt = trender.accumulate_hits(tst, tcam, fold, (torch.zeros(W * H, dtype=torch.int64), zero))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(wn))
    np.testing.assert_allclose(tt, wt, rtol=1e-5)


def test_print_space_ascii_matches_aic_tpu(cornell):
    jst, tst = cornell
    jcam, tcam = cameras()
    want = jrender.print_space_ascii(jst, jcam)
    got = trender.print_space_ascii(tst, tcam)
    assert got == want
    assert len(set(got)) > 4 and got.count("\n") == H - 1


def test_render_scaled_and_resample_match_aic_tpu(cornell):
    jst, tst = cornell
    jcam, tcam = cameras()
    assert_images_close(trender.render_scaled(tst, tcam, 0.5), jrender.render_scaled(jst, jcam, 0.5))
    # The half-scale frame's shapes, so that `aic_tpu`'s eager resample
    # reuses its compiles.
    rng = np.random.RandomState(0)
    img8 = rng.randint(0, 256, (H // 2, W // 2, 4)).astype(np.uint8)
    imgf = rng.uniform(0.0, 3.0, (H // 2, W // 2, 4)).astype(np.float32)
    for img in (img8, imgf):
        want = np.asarray(jrender.resample_frame(img, H, W))
        got = trender.resample_frame(img, H, W).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), atol=1e-5)


def test_auto_exposure_target_matches_aic_tpu():
    light = np.random.RandomState(1).uniform(0.0, 4.0, (H, W, 3)).astype(np.float32)
    want = jrender.auto_exposure_target(jnp.asarray(light))
    got = trender.auto_exposure_target(torch.as_tensor(light))
    assert got == pytest.approx(want, rel=1e-5)


def test_ortho_views_match_aic_tpu(cornell):
    """The three axis views of cornell-box 16 (an 18³ state: one ray
    shape for all three)."""
    jst, tst = cornell
    want = jortho.render_orthographic_views(jst, scale=2)
    got = tortho.render_orthographic_views(tst, scale=2)
    assert sorted(got) == sorted(want)
    for face in want:
        assert_images_close(got[face], want[face])
        assert (got[face].data[..., 3] > 0).mean() > 0.5


# -- RtRenderer ------------------------------------------------------------------


def _renderer(pkg, universe_cls, rmod, jst, ui_state):
    p = PKGS[pkg]
    sp = p.cornell_box(16)
    sp.spawn_eye_position = RT_EYE
    sp.spawn_look_direction = tuple(np.subtract(RT_TARGET, RT_EYE))
    u = universe_cls()
    u.insert_space("space", sp)
    u.insert_character("player", "space", sp.spawn_position)
    u.states["space"] = jst if pkg == "jax" else to_port(jst)
    opts = JOPTS if pkg == "jax" else TOPTS
    cams = rmod.StandardCameras(
        opts, (JViewport if pkg == "jax" else Viewport)(W, H), rmod.CharacterSource(u, "player"),
        rmod.UiViewState(state=ui_state, graphics_options=opts),
    )
    r = rmod.RtRenderer(cams)
    r.update(cursor=cams.project_cursor((0.1, -0.2)))
    assert r._cursor is not None
    return r.draw("hello\nworld")


def _ui_state(pkg):
    p = PKGS[pkg]
    sp = p.Space(p.GridAab.from_lower_size((-3, -3, -4), (2, 1, 1)),
                 physics=p.SpacePhysics(sky=p.Sky.uniform((1.0, 1.0, 0.5)), light_enabled=False))
    sp.set((-3, -3, -4), p.block.from_color((0.0, 1.0, 0.0, 1.0)))
    sp.set((-2, -3, -4), p.block.from_color((1.0, 0.0, 0.0, 0.5)))
    return sp.snapshot() if pkg == "jax" else sp.snapshot(device="cpu")


def test_rt_renderer_draw_matches_aic_tpu(cornell):
    """The UI layer (no sky), the world, the NO_WORLD fill, the
    depth-tested cursor and the info text."""
    from aic_tpu.universe import Universe as JUniverse
    from aic_tpu_torch.universe import Universe as TUniverse

    jst, _ = cornell
    want = _renderer("jax", JUniverse, jrenderer, jst, _ui_state("jax"))
    got = _renderer("torch", lambda: TUniverse(device="cpu"), trenderer, jst, _ui_state("torch"))
    assert_images_close(got, want)
    assert (got.data[..., :3] == 0).all(-1).any()  # cursor lines and text outline
    assert (got.data[..., :3] == 255).all(-1).any()  # text


# -- windowing ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def big():
    st = big_space(96).snapshot()
    return st, to_port(st)


def test_window_state_matches_aic_tpu(big):
    jst, tst = big
    eye = (24.0, 6.0, 30.0)
    lo, hi = jstate.visible_light_volume(jst, eye, 24.0)
    assert tstate.visible_light_volume(tst, eye, 24.0) == (lo, hi)
    jwin, twin = jstate.window_state(jst, lo, hi), tstate.window_state(tst, lo, hi)
    assert twin.lower == jwin.lower and twin.contents.shape[0] < tst.contents.shape[0]
    for k in ("contents", "light", "light_dirty", "cells"):
        np.testing.assert_array_equal(getattr(twin, k).numpy(), np.asarray(getattr(jwin, k)), err_msg=k)
    assert twin.tables is tst.tables
    with pytest.raises(ValueError):
        tstate.window_state(tst, (-10, 0, 0), (5, 5, 5))


def test_windowed_render_matches_aic_tpu(big, monkeypatch):
    """`render` above the window volume (lowered here for both packages):
    the windowed frame, traced by the general tracer in `aic_tpu` and by
    the megakernel in the port."""
    jst, tst = big
    monkeypatch.setattr(jrender, "AUTO_WINDOW_VOLUME", 1 << 16)
    monkeypatch.setattr(trender, "AUTO_WINDOW_VOLUME", 1 << 16)
    opts = JOptions(lighting_display="flat", fog="none", view_distance=24.0, bloom_intensity=0.0)
    jcam, tcam = cameras(opts=opts, eye=(24.0, 6.0, 30.0), target=(20.0, 2.0, 22.0))
    win = trender.view_window(tst, tcam)
    assert win.contents.shape[0] < tst.contents.shape[0]
    before = dict(trender.TRACES)
    assert_images_close(trender.render(tst, tcam), jrender.render(jst, jcam))
    assert trender.TRACES["megakernel"] == before["megakernel"] + 1


# -- dispatch ------------------------------------------------------------------------


def _pad_palette(st, rows):
    """The state with its palette tables padded to `rows` entries by
    copies of entry 0 (air), which nothing references."""
    t = st.tables
    p = t.resolution.shape[0]
    pad = {}
    for f in dataclasses.fields(t):
        v = getattr(t, f.name)
        if v.shape[0] == p:
            pad[f.name] = torch.cat([v, v[:1].expand((rows - p,) + v.shape[1:])])
        elif v.shape[0] == 6 * p:
            pad[f.name] = torch.cat([v, v[:6].repeat(rows - p, *([1] * (v.dim() - 1)))])
    return dataclasses.replace(st, tables=dataclasses.replace(t, **pad))


def _huge_state():
    """1040 × 1 × 1040 cubes: 65 × 65 = 4225 regions of 16³."""
    p = PKGS["torch"]
    sp = p.Space(p.GridAab.from_lower_size((0, 0, 0), (1040, 2, 1040)))
    sp.fill(p.GridAab.from_lower_size((500, 0, 500), (40, 1, 40)), p.block.from_color((0.5, 0.5, 0.5, 1.0)))
    return sp.snapshot(device="cpu")


def test_render_dispatch_by_predicates(cornell):
    """`render_hdr` picks K1's twin, K3's twin or the general tracer by the
    predicates alone, and each frame equals the picked tracer's; the
    kernels still refuse, when called directly, the states they do not
    hold."""
    jst, tst = cornell
    _, tcam = cameras(8, 8)
    states = {
        "megakernel": tst,
        "v1": _pad_palette(tst, 0x8001),
        "general": to_port(scene_r64()),
        "huge": _huge_state(),
    }
    assert trace_kernel.megakernel_fits(states["megakernel"])
    assert not trace_kernel.megakernel_fits(states["v1"]) and trace_kernel_v1.v1_fits(states["v1"])
    for name in ("general", "huge"):
        st = states[name]
        assert not trace_kernel.megakernel_fits(st) and not trace_kernel_v1.v1_fits(st)
        for megakernel in (True, False):
            with pytest.raises(ValueError, match="general tracer"):
                trace_kernel.trace_rays_kernel(st, *tcam.pixel_rays(device="cpu"), TOPTS, megakernel=megakernel)
    frames = {}
    for name, st in states.items():
        tracer = "general" if name == "huge" else name
        assert trender.pick_tracer(st) == tracer
        before = dict(trender.TRACES)
        light, trans = trender.render_hdr(st, tcam)
        assert {k: trender.TRACES[k] - before[k] for k in before} == {
            k: int(k == tracer) for k in before
        }
        o, d = tcam.pixel_rays(device="cpu")
        if tracer == "general":
            want = trace_rays(st, o, d, TOPTS)
        else:
            want = trace_kernel.trace_rays_kernel(st, o, d, TOPTS, megakernel=tracer == "megakernel")
        assert torch.equal(light, want[0]) and torch.equal(trans, want[1])
        frames[name] = light
    # The three tracers agree on one state: K3's twin on the padded
    # palette and the general tracer on the plain one, against K1's twin.
    np.testing.assert_allclose(frames["v1"].numpy(), frames["megakernel"].numpy(), atol=2e-3)
    o, d = tcam.pixel_rays(device="cpu")
    np.testing.assert_allclose(trace_rays(tst, o, d, TOPTS)[0].numpy(), frames["megakernel"].numpy(), atol=2e-3)


def test_bounce_render_goes_through_trace_rays_bounce(cornell):
    _, tst = cornell
    opts = dataclasses.replace(JOPTS, lighting_display="bounce", bounce_samples=2)
    _, tcam = cameras(8, 8, opts=opts)
    before = trender.TRACES["bounce"]
    frame = trender.render(tst, tcam)
    assert trender.TRACES["bounce"] == before + 1 and frame.flaws == ()
    assert frame.data.shape == (8, 8, 4) and frame.data[..., :3].max() > 0


# -- main --graphics print -------------------------------------------------------


def test_main_print_mode(capsys):
    from aic_tpu_torch import main as torch_main

    torch_main.main(["--template", "cornell-box", "--size", "8", "--graphics", "print",
                     "--width", "12", "--height", "8", "--device", "cpu", "--no-relight"])
    out = capsys.readouterr().out.rstrip("\n").split("\n")
    assert len(out) == 4  # two pixel rows a line
    assert all(line.count("▀") == 12 and line.endswith("\x1b[0m") for line in out)
    assert "\x1b[38;2;" in out[0]
