"""The port's interactive session (aic_tpu_torch.apps.session, settings)
against `aic_tpu`'s, on the CPU.

`FrameClock` and `InputState` are plain Python: the same inputs give the
same outputs, exactly. Both packages' sessions then play the same small
world (tests/test_torch_universe.py's: a floor, a wall, a lamp, a Become
cycle and a player, relit by `aic_tpu` and handed to the port with
`to_port`) under the same scripted keys, look and clicks for 30 steps:
the character's position and velocity within tests/test_torch_physics.py's
ATOL / RTOL after every step, its look equal, a world click's edit equal.
Frames (`render`, `render_with_ui` with the HUD and with the paused
page) are held within `assert_images_close`
(tests/test_torch_render_api.py: ±1 on ≥ 99.9% of pixels) at 32×24, each
package rendering the same light (`aic_tpu`'s state). The UI spaces'
device states are compared as arrays.
"""

import numpy as np
import pytest
import torch

import aic_tpu.apps.session as jsession
import aic_tpu_torch.apps.session as tsession
from aic_tpu.raytrace import GraphicsOptions as JOptions
from aic_tpu.raytrace import Viewport as JViewport
from aic_tpu.universe import cursor as jcursor
from aic_tpu_torch.raytrace import Viewport as TViewport
from aic_tpu_torch.universe import cursor as tcursor
from test_torch_physics import ATOL, RTOL
from test_torch_render_api import assert_images_close
from test_torch_state import fresh_pallas_caches, to_port  # noqa: F401 (autouse)
from test_torch_trace import torch_options
from test_torch_universe import _universes

W, H = 32, 24
# No bloom: `aic_tpu`'s bloom costs a 16 s compile on the CPU (the port's
# bloom is held against it in tests/test_torch_slice.py).
JOPTS = JOptions(lighting_display="smoothstep", fog="none", bloom_intensity=0.0)


# -- FrameClock, InputState ------------------------------------------------------


def test_frame_clock_catch_up_matches_aic_tpu():
    """Seeded frame times, fast ones and some late by several steps: the
    same steps due each time, never more than CATCH_UP_STEPS, and none
    while the clock is ahead."""
    assert tsession.CATCH_UP_STEPS == jsession.CATCH_UP_STEPS
    rng = np.random.default_rng(5)
    gaps = rng.choice([0.004, 0.004, 0.004, 0.0167, 0.02], size=200)
    gaps[[60, 140]] = 0.5
    times = np.cumsum(gaps)
    jc, tc = jsession.FrameClock(), tsession.FrameClock()
    got = [tc.steps_due(float(t)) for t in times]
    want = [jc.steps_due(float(t)) for t in times]
    assert got == want
    assert max(got) == tsession.CATCH_UP_STEPS and 0 in got


def _input_script(mod):
    """Momentary holds, a focus loss, mouselook and a rebinding through
    one InputState; everything observable after each event."""
    s = mod.InputState()
    out = []

    def look():
        out.append((sorted(s.keys), sorted(s.momentary), tuple(s.turn_buffer), s.has_focus,
                    tuple(np.round(s.movement(), 12))))

    s.key_down("w"), s.key_momentary("d"), look()
    for _ in range(8):
        s.step(mod.STEP_DT * 1.5)
        look()
    s.key_down("left"), s.mouselook_delta(12.0, -5.0)
    out.append(s.take_turning(mod.STEP_DT)), look()
    out.append(s.take_turning(mod.STEP_DT))
    s.key_focus(False), look()
    s.key_down("a"), look()
    s.key_focus(True), s.key_down("a"), look()
    s.rebind("a", "move", (0, 1, 0))
    out.append(s.command("a")), look()
    out.append(s.command("5"))
    return out


def test_input_state_matches_aic_tpu():
    assert _input_script(tsession) == _input_script(jsession)


# -- a session played by both packages -------------------------------------------

STEPS = 30
#: step → keys held from then on; look deltas; momentary presses.
KEYS = {0: set(), 6: {"w"}, 13: {"w", "left"}, 17: {"d"}, 19: {"d", " "}, 21: {"a", "up"}, 26: set()}
LOOK = {9: (20.0, -8.0), 23: (-35.0, 4.0)}
MOMENTARY = {15: "s", 24: "e"}


def _sessions():
    uj, ut = _universes(behavior=False)
    # No light rounds: they do not move the player, and the step's light
    # is held in tests/test_torch_universe.py.
    uj.light_rounds_per_tick = ut.light_rounds_per_tick = 0
    js = jsession.Session(uj, viewport=JViewport(W, H), options=JOPTS)
    ts = tsession.Session(ut, viewport=TViewport(W, H), options=torch_options(JOPTS))
    for s in (js, ts):
        s.enable_ui()
    return js, ts


def _bodies(s):
    b = s.universe.bodies
    return {k: np.asarray(getattr(b, k)) for k in ("position", "velocity", "yaw", "pitch")}


@pytest.fixture(scope="module")
def played():
    """Both sessions after the scripted 30 steps, with each step's
    bodies and steps due."""
    js, ts = _sessions()
    trace = []
    for i in range(STEPS):
        for s in (js, ts):
            if i in KEYS:
                s.input.keys = set(KEYS[i])
            if i in LOOK:
                s.input.mouselook_delta(*LOOK[i])
            if i in MOMENTARY:
                s.input.key_momentary(MOMENTARY[i])
        now = i * jsession.STEP_DT * 1.0001
        due = (js.maybe_step(now), ts.maybe_step(now))
        trace.append((due, _bodies(js), _bodies(ts)))
    return js, ts, trace


def test_session_trajectory_matches_aic_tpu(played):
    _js, _ts, trace = played
    assert sum(d[0] for d, _, _ in trace) >= STEPS - 1
    for i, (due, want, got) in enumerate(trace):
        assert due[0] == due[1], i
        for k in ("position", "velocity"):
            np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL, err_msg=f"step {i} {k}")
        for k in ("yaw", "pitch"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"step {i} {k}")
    moved = trace[-1][2]["position"][0] - trace[0][2]["position"][0]
    assert np.abs(moved[[0, 2]]).max() > 0.5  # the keys walked the player
    assert trace[-1][2]["yaw"][0] != 0.0 and trace[-1][2]["pitch"][0] != 0.0


def _same_light(js, ts):
    """The port's session renders `aic_tpu`'s world state (the packages'
    relights may stop one packed step apart)."""
    ts.universe.states["world"] = to_port(js.universe.states["world"])


def test_render_and_render_with_ui_match_aic_tpu(played):
    js, ts, _ = played
    _same_light(js, ts)
    assert_images_close(ts.render(), js.render())
    want = js.render_with_ui()
    got = ts.render_with_ui()
    assert_images_close(got, want)
    assert (got.data[..., :3] != ts.render().data[..., :3]).any()  # the HUD is drawn
    np.testing.assert_array_equal(ts.ui_state.contents.numpy(), np.asarray(js.ui_state.contents))


def _pixel_for(cam, region):
    """Pixel whose ray points closest at the region's centre
    (tests/test_ui_pages.py's projection)."""
    center = np.array([lo + sz / 2.0 for lo, sz in zip(region.lower, region.size)])
    o, d = cam.pixel_rays(device="cpu")
    o, d = o.numpy().astype(np.float64), d.numpy().astype(np.float64)
    to_c = center[None, None, :] - o
    to_c /= np.linalg.norm(to_c, axis=-1, keepdims=True)
    dn = d / np.linalg.norm(d, axis=-1, keepdims=True)
    y, x = np.unravel_index(np.argmax((to_c * dn).sum(-1)), d.shape[:2])
    return int(x), int(y)


def test_pause_and_settings_pages_match_aic_tpu(played):
    """Pausing opens the paused page, rendered; its Settings button opens
    the settings page (its device state compared as an array); a
    setting's button cycles the option in both."""
    js, ts, _ = played
    _same_light(js, ts)
    for s in (js, ts):
        s.paused = True
    assert_images_close(ts.render_with_ui(), js.render_with_ui())
    page = ts.pages.current()
    actions = {a: r for r, a in page.space.ui_actions}
    x, y = _pixel_for(page.camera(ts.camera.viewport), actions[("open", "settings")])
    assert js.click(x, y) == ts.click(x, y) == ("open", "settings")
    assert ts.pages.current().id == js.pages.current().id == "settings"
    np.testing.assert_array_equal(ts.pages.current().snapshot().contents.numpy(),
                                  np.asarray(js.pages.current().snapshot().contents))
    page = ts.pages.current()
    actions = {a: r for r, a in page.space.ui_actions}
    x, y = _pixel_for(page.camera(ts.camera.viewport), actions[("setting", "fog")])
    assert js.click(x, y) == ts.click(x, y) == ("setting", "fog")
    assert ts.options.fog == js.options.fog == "abrupt"
    for s in (js, ts):
        s.back(), s.back()
    assert not ts.paused and not js.paused and ts.pages.current() is None


def test_slot_selection_matches_aic_tpu(played):
    js, ts, _ = played
    for s in (js, ts):
        s.select_slot(2)
    np.testing.assert_array_equal(ts.ui_state.contents.numpy(), np.asarray(js.ui_state.contents))
    assert ts.inventory.selected == js.inventory.selected == 2


def test_toolbar_click_selects_its_slot(played):
    """The port's toolbar slots are buttons (the reference's toolbar):
    a click on a pixel that shows slot 1 selects it."""
    _js, ts, _ = played
    slot_cube = (ts.ui_widgets["tx"] + 1, 0)
    x0, y0 = _pixel_for(ts.ui_camera, type(ts.ui_space.bounds).from_lower_size(slot_cube + (0,), (1, 1, 2)))
    for y, x in sorted(((y, x) for y in range(y0 - 2, y0 + 3) for x in range(x0 - 2, x0 + 3)),
                       key=lambda p: abs(p[0] - y0) + abs(p[1] - x0)):
        ndc = np.array([2.0 * (x + 0.5) / W - 1.0, 1.0 - 2.0 * (y + 0.5) / H])
        cur = tcursor.cursor_raycast(ts.ui_space, *ts.ui_camera.project_ndc_into_world(ndc), max_distance=1000.0)
        if cur is not None and tuple(cur.cube[:2]) == slot_cube:
            assert ts.click(x, y) == ("slot", 1)
            assert ts.inventory.selected == 1
            return
    raise AssertionError("no pixel shows toolbar slot 1")


def test_world_click_edit_matches_aic_tpu(played):
    """A click at the centre of the view with RemoveBlock selected
    removes the same cube in both; the port's device state follows."""
    js, ts, _ = played
    for s, cursor in ((js, jcursor), (ts, tcursor)):
        s.inventory.slots = [cursor.RemoveBlock()]
        s.inventory.selected = 0
        s.set_look(180.0, -60.0)
    before = ts.universe.spaces["world"].contents.copy()
    assert js.click(W // 2, H // 2) is True
    assert ts.click(W // 2, H // 2) is True
    np.testing.assert_array_equal(ts.universe.spaces["world"].contents, js.universe.spaces["world"].contents)
    assert (ts.universe.spaces["world"].contents != before).sum() == 1
    np.testing.assert_array_equal(ts.universe.states["world"].contents.numpy(),
                                  np.asarray(js.universe.states["world"].contents))
    assert [f.name for f in ts.universe.drain_fluff("t")] == [f.name for f in js.universe.drain_fluff("t")]


def test_session_runs_its_steps_on_the_universe_device(played):
    _js, ts, _ = played
    assert ts.device == "cpu" and ts.ui_state.contents.device.type == "cpu"
    row = tsession.body_row(ts.universe, ts.character.body_index)
    np.testing.assert_array_equal(row["position"], ts.universe.bodies.position[0].numpy())
    assert isinstance(ts.universe.bodies.velocity, torch.Tensor)
