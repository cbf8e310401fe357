"""Session: the platform-independent application loop.

Port of `aic_tpu/apps/session.py`, the equivalent of the reference
`Session`/`FrameClock`/`InputProcessor` (all-is-cubes-ui/src/apps/
{session.rs:52, time.rs:10, input.rs:39}): a fixed 60 Hz simulation
schedule with bounded catch-up, keyboard state → character motion
intents, and a renderer-agnostic frame hook.

The universe's bodies live on its device. A simulation step reads the
character's row with one copy to the host and writes its velocity (and
look, when it turned) with one copy to the device; the camera reads the
row once a frame. `render_with_ui` traces the world and the UI layer on
the device, composites, tone-maps and encodes there, and copies the
finished RGBA image to the host once. Its stages are spans of
`Session.profiler` ("step", "world", "ui", "composite", "post_process",
"to_host"); set `profiler.sync` to time each with its device work.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..profiling import Profiler
from ..raytrace import Camera, GraphicsOptions, Viewport
from ..universe import Universe

CATCH_UP_STEPS = 2  # session.rs CATCH_UP_STEPS bound on missed-frame catch-up
STEP_DT = 1.0 / 60.0


MOMENTARY_HOLD_S = 0.2  # input.rs:155 momentary_timeout 200 ms
TURN_RATE_DEG_S = 80.0  # input.rs:296 key_turning_step = 80°/s
MOUSELOOK_SCALE = 0.2  # input.rs:200 mouselook_buffer += delta * 0.2


@dataclass
class InputState:
    """input.rs:39 InputProcessor: held-key state → motion intents.

    `bindings` maps keys to named commands (the key-rebinding table the
    reference's InputProcessor keymap provides): movement commands carry
    a direction; action commands ("jump", "pause", "slot-N", "quit") are
    read by frontends via `command(key)`. `rebind` replaces a key's
    command at runtime.

    Richness per the reference InputProcessor:
    - `key_momentary` virtually holds a key for 200 ms, for frontends
      that only see key *presses* (web keypress events, terminals) —
      input.rs:154.
    - `key_focus(False)` drops all held state so keys never stick when
      the window loses focus — input.rs:165.
    - Mouselook deltas accumulate into a turn buffer (scaled 0.2°/px,
      input.rs:197-200) consumed once per simulation step together with
      arrow-key turning at 80°/s (input.rs apply_input) — frame-rate
      independent look control.
    - `mouse_ndc` tracks the free cursor for picking (input.rs:214).
    """

    keys: set = field(default_factory=set)
    bindings: dict = None
    #: key -> remaining virtual-hold seconds (input.rs momentary_timeout).
    momentary: dict = field(default_factory=dict)
    #: Accumulated (yaw°, pitch°) to apply next step.
    turn_buffer: list = field(default_factory=lambda: [0.0, 0.0])
    #: Last known cursor position in NDC, or None when outside/captured.
    mouse_ndc: Optional[tuple] = None
    has_focus: bool = True

    DEFAULT_BINDINGS = {
        "w": ("move", (0, 0, -1)),
        "s": ("move", (0, 0, 1)),
        "a": ("move", (-1, 0, 0)),
        "d": ("move", (1, 0, 0)),
        "e": ("move", (0, 1, 0)),
        "c": ("move", (0, -1, 0)),
        # Arrow keys turn (input.rs net_movement(Left, Right) turning).
        "left": ("turn", (1.0, 0.0)),
        "right": ("turn", (-1.0, 0.0)),
        "up": ("turn", (0.0, 1.0)),
        "down": ("turn", (0.0, -1.0)),
        " ": ("jump", None),
        "p": ("pause", None),
        "q": ("quit", None),
        **{str(n): ("slot", n - 1) for n in range(1, 10)},
    }

    def __post_init__(self):
        if self.bindings is None:
            self.bindings = dict(self.DEFAULT_BINDINGS)

    def rebind(self, key: str, command: str, arg=None) -> None:
        self.bindings[key] = (command, arg)

    def command(self, key: str):
        return self.bindings.get(key)

    # -- key state (input.rs:136-177) ---------------------------------------

    def key_down(self, key: str) -> None:
        if self.has_focus:
            self.keys.add(key)

    def key_up(self, key: str) -> None:
        self.keys.discard(key)
        self.momentary.pop(key, None)

    def key_momentary(self, key: str) -> None:
        """Press + virtual 200 ms hold (input.rs:154): for event sources
        that never deliver a key-up."""
        self.key_down(key)
        self.momentary[key] = MOMENTARY_HOLD_S

    def key_focus(self, focus: bool) -> None:
        """input.rs:165 key_focus: focus loss clears all held state."""
        self.has_focus = focus
        if not focus:
            self.keys.clear()
            self.momentary.clear()
            self.turn_buffer[0] = self.turn_buffer[1] = 0.0

    # -- look control ---------------------------------------------------------

    def mouselook_delta(self, dx: float, dy: float) -> None:
        """Relative pointer motion while captured (input.rs:197): right
        motion turns right (yaw−), up motion looks up (pitch+)."""
        self.turn_buffer[0] -= dx * MOUSELOOK_SCALE
        self.turn_buffer[1] -= dy * MOUSELOOK_SCALE

    def take_turning(self, dt: float) -> tuple[float, float]:
        """Consume the accumulated (yaw°, pitch°) for one step: buffered
        mouselook plus held arrow keys at 80°/s (input.rs:294-302)."""
        dyaw, dpitch = self.turn_buffer
        self.turn_buffer[0] = self.turn_buffer[1] = 0.0
        for k in self.keys:
            cmd = self.bindings.get(k)
            if cmd and cmd[0] == "turn":
                dyaw += cmd[1][0] * TURN_RATE_DEG_S * dt
                dpitch += cmd[1][1] * TURN_RATE_DEG_S * dt
        return dyaw, dpitch

    def step(self, dt: float) -> None:
        """Per-simulation-step upkeep (input.rs:263 step): decay
        momentary holds, releasing expired keys."""
        expired = []
        for k in self.momentary:
            self.momentary[k] -= dt
            if self.momentary[k] <= 0:
                expired.append(k)
        for k in expired:
            self.key_up(k)

    def movement(self) -> np.ndarray:
        v = np.zeros(3)
        for k in self.keys:
            cmd = self.bindings.get(k)
            if cmd and cmd[0] == "move":
                v += cmd[1]
        n = np.linalg.norm(v)
        return v / n if n > 0 else v


class FrameClock:
    """apps/time.rs:10: fixed-schedule stepping with catch-up."""

    def __init__(self):
        self.last_step_time: Optional[float] = None

    def steps_due(self, now: float) -> int:
        if self.last_step_time is None:
            self.last_step_time = now
            return 1
        due = int((now - self.last_step_time) / STEP_DT)
        due = min(due, CATCH_UP_STEPS)
        if due > 0:
            self.last_step_time += due * STEP_DT
        return due


WALK_SPEED = 4.0  # character.rs walking speed cubes/s
FLY_SPEED = 10.0
JUMP_SPEED = 8.0


def body_row(universe, i: int) -> dict:
    """Body `i` of the universe's batch on the host, read with one copy:
    position and velocity (f32[3]), yaw and pitch (f32), flying and
    on_ground (bool; on_ground False before the first physics step)."""
    b = universe.bodies
    og = universe.on_ground
    og = torch.zeros(1, device=b.position.device) if og is None else og[i : i + 1].to(torch.float32)
    row = torch.cat([b.position[i], b.velocity[i], b.yaw[i : i + 1], b.pitch[i : i + 1],
                     b.flying[i : i + 1].to(torch.float32), og]).cpu().numpy()
    return dict(position=row[0:3], velocity=row[3:6], yaw=row[6], pitch=row[7],
                flying=bool(row[8]), on_ground=bool(row[9]))


def set_body_row(universe, i: int, **fields) -> None:
    """Write fields of body `i` (any of position, velocity, yaw, pitch)
    with one copy to the device; the scatter runs there. Velocity goes
    through `Body.set_velocity`, which ignores a non-finite input; the
    position is written as given (the record script's `Performance`)."""
    b = universe.bodies
    names = [k for k in ("position", "velocity", "yaw", "pitch") if k in fields]
    host = np.concatenate([np.asarray(fields[k], np.float32).reshape(-1) for k in names])
    vals = torch.as_tensor(host).to(b.position.device)
    at = 0
    for k in names:
        n = 3 if k in ("position", "velocity") else 1
        col = getattr(b, k).clone()
        col[i] = vals[at : at + n] if n == 3 else vals[at]
        at += n
        b = b.set_velocity(col) if k == "velocity" else dataclasses.replace(b, **{k: col})
    universe.bodies = b


class Session:
    """session.rs:52: owns a Universe + a character + input; `frame()`
    advances simulation per the frame clock and renders. Everything it
    traces runs on the universe's device."""

    def __init__(
        self,
        universe: Universe,
        character_name: str = "player",
        viewport: Viewport = Viewport(640, 360),
        options: Optional[GraphicsOptions] = None,
    ):
        self.universe = universe
        self.character_name = character_name
        self.input = InputState()
        self.clock = FrameClock()
        self._paused = False
        self.quit_requested = False
        self.options = options or GraphicsOptions()
        self.camera = Camera(self.options, viewport)
        self.info_text: str = ""
        from ..vui.notification import NotificationHub

        self.notifications = NotificationHub()
        # Settings store backing the in-game settings page
        # (all-is-cubes-ui/src/settings.rs; Session::settings).
        from .settings import Settings

        self.settings = Settings(options=self.options)
        #: VUI page navigation (vui/page.rs VuiPageState) — populated by
        #: enable_ui; None means no page layer (plain world render).
        self.pages = None
        self.hud = None
        #: Draw a wireframe over the targeted cube (gpu cursor lines role).
        self.debug_cursor = False
        self._last_cursor = None
        self._frame_ema = 0.0
        #: Transient fluff particles (gpu/in_wgpu/space.rs:1104 renders
        #: fluff as particle sets): [(world_pos f64[3], name, birth_tick)].
        self.particles: list = []
        self.particle_lifetime_ticks = 24  # ~0.4 s at 60 Hz
        #: Host-clock spans of the step and of the frame's stages.
        self.profiler = Profiler()

    @property
    def device(self):
        return self.universe.device

    @property
    def character(self):
        return self.universe.characters.get(self.character_name)

    # -- pause / page-state coupling (vui_manager.rs set_state) -------------

    @property
    def paused(self) -> bool:
        return self._paused

    @paused.setter
    def paused(self, value: bool):
        """Pausing opens the paused page; resuming clears the page stack
        (the reference couples paused<->VuiPageState::Paused the same
        way, vui_manager.rs pause handling)."""
        value = bool(value)
        if value == self._paused:
            return
        self._paused = value
        if self.pages is not None:
            if value:
                self.pages.open("paused")
            else:
                self.pages.clear()

    def back(self) -> None:
        """Escape semantics (session.rs back/escape): pop the top page;
        popping the last page resumes play."""
        if self.pages is not None and self.pages.back():
            if self.pages.depth == 0:
                self._paused = False
            return
        self._paused = False

    def set_look(self, yaw_deg: float, pitch_deg: float):
        set_body_row(self.universe, self.character.body_index, yaw=yaw_deg, pitch=pitch_deg)

    def toggle_flying(self):
        """Flip the character's flying flag (the frontends' F key), on the
        device."""
        ch = self.character
        if ch is None:
            return
        u = self.universe
        flying = u.bodies.flying.clone()
        flying[ch.body_index] = ~flying[ch.body_index]
        u.bodies = dataclasses.replace(u.bodies, flying=flying)

    def apply_input(self):
        """session.rs:374-392: key state → character velocity intent."""
        ch = self.character
        if ch is None:
            return
        i = ch.body_index
        row = body_row(self.universe, i)
        yaw = float(row["yaw"])
        pitch = float(row["pitch"])
        flying = row["flying"]

        # Turning: buffered mouselook + arrow keys, consumed per step
        # (input.rs apply_input: yaw wraps, pitch clamps ±90).
        dyaw, dpitch = self.input.take_turning(STEP_DT)
        turned = dyaw != 0.0 or dpitch != 0.0
        if turned:
            yaw = (yaw + dyaw) % 360.0
            pitch = float(np.clip(pitch + dpitch, -90.0, 90.0))
        self.input.step(STEP_DT)

        move = self.input.movement()
        # Rotate intent by yaw (around Y): -Z is forward.
        c, s = np.cos(np.radians(yaw)), np.sin(np.radians(yaw))
        world = np.array(
            [move[0] * c - move[2] * s, move[1], move[0] * s + move[2] * c]
        )
        speed = FLY_SPEED if flying else WALK_SPEED
        vel = row["velocity"].copy()  # f32, as `aic_tpu`'s host copy
        target = world * speed
        if flying:
            vel[:] = target
        else:
            vel[0] = target[0]
            vel[2] = target[2]
            # Jump only from the ground (character/step.rs:59: input.jump
            # consumed && is_on_ground — velocity.y <= 0 plus a floor
            # contact from the previous physics step). Holding the key
            # re-jumps on landing but never thrusts mid-air.
            on_ground = self.universe.on_ground is not None and row["on_ground"] and vel[1] <= 0.0
            if " " in self.input.keys and on_ground:
                vel[1] += JUMP_SPEED
        if turned:
            set_body_row(self.universe, i, velocity=vel, yaw=yaw, pitch=pitch)
        else:
            set_body_row(self.universe, i, velocity=vel)

    def eye_camera(self) -> Camera:
        """Camera at the character's eye (character.rs eye height 1.6-ish)."""
        row = body_row(self.universe, self.character.body_index)
        eye = row["position"].astype(np.float64) + np.array([0.0, 1.6, 0.0])
        yaw = float(row["yaw"])
        pitch = float(row["pitch"])
        cy, sy = np.cos(np.radians(yaw)), np.sin(np.radians(yaw))
        cp, sp = np.cos(np.radians(pitch)), np.sin(np.radians(pitch))
        forward = np.array([-sy * cp, sp, -cy * cp])
        self.camera.look_at(eye, eye + forward)
        return self.camera

    def maybe_step(self, now: Optional[float] = None) -> int:
        """session.rs:353 maybe_step_universe."""
        now = time.monotonic() if now is None else now
        steps = self.clock.steps_due(now)
        if not steps:
            return 0
        with self.profiler.span("step"):
            for _ in range(steps):
                self.apply_input()
                info = self.universe.step(paused=self.paused)
                # Fluff → transient particles (space.rs:1104 particle sets).
                for fluff in self.universe.drain_fluff("particles"):
                    pos = np.asarray(fluff.position, np.float64) + 0.5
                    self.particles.append((pos, fluff.name, info.tick))
                if self.particles:
                    cutoff = info.tick - self.particle_lifetime_ticks
                    self.particles = [p for p in self.particles if p[2] > cutoff]
                # Reading the device-path stats forces a host sync
                # (UniverseStepInfo._drain) — refresh the diagnostic line at
                # a low cadence so the step loop itself stays async.
                if info.tick % 15 == 0:
                    self.info_text = (
                        f"tick {info.tick} | edits {info.space_edits} | "
                        f"lightq {info.light_queue} | {info.wall_time_s*1000:.1f}ms"
                    )
            if self.hud is not None:
                # HUD widget controllers ride the step cadence (vui_manager
                # steps controllers every frame) — cheap no-op when nothing
                # changed, per-cell transaction when something did.
                self.refresh_ui()
        return steps

    def _adapt_exposure(self, light):
        """Auto-exposure smoothing (character/exposure.rs:67): move the
        camera exposure toward the scene-derived target."""
        from ..raytrace.render import auto_exposure_target

        target = auto_exposure_target(light)
        target = float(np.clip(target, 0.05, 20.0))
        self.camera.exposure += (target - self.camera.exposure) * 0.2

    def render(self):
        from ..raytrace.render import Rendering, finish_frame, render_hdr

        t0 = time.perf_counter()
        ch = self.character
        if ch is None or ch.space_name not in self.universe.spaces:
            # The character or its space is gone (test-renderers
            # error_character_gone contract): draw succeeds with no data
            # and reports the degradation instead of crashing.
            vp = self.camera.viewport
            return Rendering(
                vp.width,
                vp.height,
                np.zeros((vp.height, vp.width, 4), np.uint8),
                flaws=("NO_CHARACTER",),
            )
        state = self.universe.get_state(ch.space_name)
        cam = self.eye_camera()
        light, trans = render_hdr(state, cam)
        if self.options.exposure_auto:
            self._adapt_exposure(light)
        # np.array (a copy): overlays draw into this buffer in place.
        img = np.array(finish_frame(light, trans, float(cam.exposure), self.options).cpu().numpy())
        if self.particles:
            img = self._draw_particles(img, cam)
        if self.debug_cursor and self._last_cursor is not None:
            from ..raytrace.lines import cursor_wireframe, overlay_wireframes

            img = overlay_wireframes(
                img, cam, [(cursor_wireframe(self._last_cursor.cube), (255, 255, 255))]
            )
        img = self._debug_overlays(img, cam)
        # Info-text overlay content (the reference's info-text window,
        # session.rs info_text): frame time + moving-average FPS.
        dt = time.perf_counter() - t0
        self._frame_ema = 0.8 * self._frame_ema + 0.2 * dt if self._frame_ema else dt
        self.info_text = (
            f"frame {dt * 1e3:6.1f} ms | {1.0 / max(self._frame_ema, 1e-6):5.1f} fps | "
            f"{cam.viewport.width}x{cam.viewport.height}"
        )
        return Rendering(cam.viewport.width, cam.viewport.height, img)

    #: Fluff-name → particle tint (the reference derives particle colors
    #: from the fluff's definition; the standard effects map here).
    PARTICLE_COLORS = {
        "Place": (210, 230, 255),
        "BlockPlaced": (210, 230, 255),
        "Destroy": (255, 190, 110),
        "BlockDestroyed": (255, 190, 110),
        "Activate": (255, 255, 160),
    }

    def _draw_particles(self, img, cam):
        """Fluff particle overlay: one expanding 4-point sparkle per
        recent fluff event, aging out over `particle_lifetime_ticks`
        (the raytrace-renderer analog of the wgpu renderer's fluff
        particle sets, gpu/in_wgpu/space.rs:1104)."""
        from ..raytrace.lines import draw_segments, project_segments

        tick = self.universe.clock.ticks
        by_color: dict = {}
        for pos, name, birth in self.particles:
            age = (tick - birth) / max(self.particle_lifetime_ticks, 1)
            r = 0.12 + 0.3 * min(max(age, 0.0), 1.0)  # expanding burst
            color = self.PARTICLE_COLORS.get(name, (255, 255, 255))
            segs = by_color.setdefault(color, [])
            for d in ((r, 0, 0), (0, r, 0), (0, 0, r)):
                a = pos - np.asarray(d, np.float64)
                b = pos + np.asarray(d, np.float64)
                segs.append((a, b))
        img = np.ascontiguousarray(img)
        for color, segs in by_color.items():
            px = project_segments(cam, np.asarray(segs, np.float64))
            draw_segments(img, px, color=color)
        return img

    def _debug_overlays(self, img, cam):
        """GraphicsOptions debug wireframes (graphics_options.rs:121-152;
        gpu common/debug_lines.rs): chunk boxes, the character's
        collision box, and light rays at the cursor."""
        opts = self.options
        sets = []
        from ..raytrace.lines import wireframe_box

        if opts.debug_collision_boxes and self.character is not None:
            b = self.universe.bodies
            i = self.character.body_index
            pos, lo, hi = torch.stack([b.position[i], b.box_lo[i], b.box_hi[i]]).cpu().numpy()
            sets.append((wireframe_box(pos + lo, pos + hi), (0, 255, 0)))
        if opts.debug_chunk_boxes and self.character is not None:
            # 16³ chunk boundaries around the eye (chunking.rs CHUNK_SIZE).
            eye = np.asarray(cam.view_position, np.float64)
            base = np.floor(eye / 16.0).astype(int)
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for dz in (-1, 0, 1):
                        lo = (base + (dx, dy, dz)) * 16
                        sets.append((wireframe_box(lo, lo + 16), (90, 90, 255)))
        if opts.debug_light_rays_at_cursor and self._last_cursor is not None:
            # A sample of the 602-ray light chart from the cursor cube
            # (gpu everything.rs light-ray debug visualization).
            from ..light.chart import generate_directions

            c = np.asarray(self._last_cursor.cube, np.float64) + 0.5
            dirs = generate_directions()[0][::40]
            segs = np.stack([np.broadcast_to(c, (len(dirs), 3)), c + dirs * 3.0], axis=1)
            sets.append((segs, (255, 255, 0)))
        if sets:
            from ..raytrace.lines import overlay_wireframes

            img = overlay_wireframes(img, cam, sets)
        return img

    def update_cursor(self):
        """Re-run the cursor raycast from the eye (Session::update_cursor,
        session.rs): stores the result for tools + the debug highlight."""
        from ..universe.cursor import cursor_raycast

        ch = self.character
        cam = self.eye_camera()
        eye = np.asarray(cam.eye_to_world[:3, 3], np.float64)
        fwd = -np.asarray(cam.eye_to_world[:3, 2], np.float64)
        self._last_cursor = cursor_raycast(self.universe.spaces[ch.space_name], eye, fwd)
        return self._last_cursor

    # ---- UI layer (reference: ui/src/vui, Layers<Camera> world+ui) -------

    def show_notification(self, title: str, fraction: float = 0.0, part: str = ""):
        """Session::show_notification (ui_content/notification.rs): create
        a live notification handle shown in the HUD until dropped."""
        from ..vui.notification import ProgressContent

        return self.notifications.show(ProgressContent(title, fraction, part))

    def enable_ui(self, inventory=None):
        """Attach the voxel-UI HUD layer (vui_manager.rs HudLayout), its
        device state on the universe's device."""
        from ..universe.cursor import free_editing_inventory
        from ..vui import ui_camera
        from ..vui.controller import HudController
        from ..vui.page import PageStack

        self.inventory = inventory if inventory is not None else free_editing_inventory()
        # The toolbar and the character's click dispatch must share one
        # inventory (the reference's HudInputs reads the character's
        # inventory; character.rs:307 clicks use it) — otherwise slot
        # selection in the UI wouldn't change what a click does.
        if self.character is not None:
            self.character.inventory_obj = self.inventory
        # HudController owns the UI space + device state and one
        # WidgetController per dynamic widget (vui_manager.rs); updates
        # are per-changed-cell transactions, not full redraw/re-snapshot.
        self.hud = HudController(self.inventory, self.notifications, device=self.device)
        self.ui_space = self.hud.space
        self.ui_widgets = self.hud.widgets
        self.ui_camera = ui_camera(self.ui_space, self.camera.viewport)
        self.pages = PageStack(settings=self.settings, notifications=self.notifications, device=self.device)
        if self._paused:
            self.pages.open("paused")

    @property
    def ui_state(self):
        """UI-layer device state — owned by the HudController so that
        per-cell transaction commits are visible immediately."""
        return self.hud.state if self.hud is not None else None

    def refresh_ui(self):
        """Step the widget controllers; commits only the changed cells
        to the UI device state (widget_trait.rs step() analog)."""
        self.hud.step(self)

    def click(self, x_px: float, y_px: float, button: int = 0):
        """Dispatch a click at viewport pixel coords: UI layer first (the
        reference routes clicks through the HUD before the world,
        vui_manager.rs), then the world cursor + selected tool
        (character.rs:307 Character::click). Returns the UI action taken,
        True for a world edit, or None."""
        from ..universe.cursor import click as world_click
        from ..universe.cursor import cursor_raycast

        vp = self.camera.viewport
        ndc = np.array(
            [2.0 * (x_px + 0.5) / vp.width - 1.0, 1.0 - 2.0 * (y_px + 0.5) / vp.height]
        )
        # UI layer pick: the top page when one is open, else the HUD.
        if self.ui_state is not None:
            page = self.pages.current() if self.pages is not None else None
            if page is not None:
                ui_space = page.space
                ui_cam = page.camera(vp)
            else:
                ui_space = self.ui_space
                ui_cam = self.ui_camera
            origin, direction = ui_cam.project_ndc_into_world(ndc)
            cur = cursor_raycast(ui_space, origin, direction, max_distance=1000.0)
            if cur is not None:
                for region, action in getattr(ui_space, "ui_actions", []):
                    if region.contains_cube(cur.cube):
                        return self.handle_ui_action(action)
                if page is None:
                    slot = self._toolbar_slot(cur.cube)
                    if slot is not None:
                        return self.handle_ui_action(("slot", slot))
        if self.paused:
            return None
        ch = self.character
        if ch is None:
            return None
        cam = self.eye_camera()
        origin, direction = cam.project_ndc_into_world(ndc)
        world = self.universe.spaces[ch.space_name]
        cur = cursor_raycast(world, origin, direction)
        return world_click(self.universe, ch, cur, button)

    def _toolbar_slot(self, cube) -> Optional[int]:
        """The toolbar slot a HUD cube lies in, or None. A click there
        selects the slot (the reference's toolbar slots are buttons,
        toolbar.rs); `aic_tpu`'s toolbar registers no action, and its
        click falls through to the world."""
        toolbar, tx = self.ui_widgets["toolbar"], self.ui_widgets["tx"]
        x, y, _z = cube
        if y == 0 and tx <= x < tx + toolbar.slots:
            return x - tx
        return None

    def handle_ui_action(self, action):
        """Standard page actions (pages.rs buttons): resume/quit/back,
        open-page, setting toggles, template selection, toolbar slots."""
        if action == "resume":
            self.paused = False
        elif action == "quit":
            self.quit_requested = True
        elif action == "back":
            self.back()
        elif isinstance(action, tuple) and action[0] == "open":
            if self.pages is not None:
                self.pages.open(action[1])
        elif isinstance(action, tuple) and action[0] == "setting":
            from ..vui.page import cycle_setting

            cycle_setting(self.settings, action[1])
            self.apply_settings()
            if self.pages is not None:
                # Labels show current values — rebuild the page.
                self.pages.invalidate("settings")
        elif isinstance(action, tuple) and action[0] == "slot":
            self.select_slot(action[1])
        elif isinstance(action, tuple) and action[0] == "template":
            from ..content.template import build_universe

            self.universe = build_universe(action[1], device=self.device)
        return action

    def show_message(self, message: str):
        """Open the modal message page (pages.rs:223 new_message_page)."""
        if self.pages is not None:
            self.pages.open("message", message=message)

    def document_name(self) -> str | None:
        """The universe's document identity for window titles
        (desktop session.rs:204 reads `info.whence.document_name()`)."""
        return self.universe.whence.document_name()

    def save_universe(self) -> str | None:
        """Save back to the universe's origin (whence.rs save flow).
        Returns the document name on success; raises ValueError when the
        universe has no saveable origin (NoWhence)."""
        self.universe.whence.save(self.universe)
        return self.document_name()

    def open_universe_file(self, path: str) -> None:
        """Load a universe file onto this session's device and make it the
        live universe (the desktop's drag-drop open, winit.rs:506
        DroppedFile)."""
        from ..io.whence import load_universe_file

        self.universe = load_universe_file(path, device=self.device)

    def apply_settings(self):
        """Propagate the settings store into the live graphics options +
        camera (Session::settings mutation propagation)."""
        self.options = self.settings.graphics_options()
        exposure = self.camera.exposure
        eye_to_world = self.camera.eye_to_world
        self.camera = Camera(self.options, self.camera.viewport, eye_to_world)
        self.camera.exposure = exposure

    def select_slot(self, slot: int):
        """Toolbar slot selection (session.rs number-key handling)."""
        if getattr(self, "inventory", None) is None:
            return
        self.inventory.selected = slot
        self.refresh_ui()

    def render_with_ui(self):
        """Render world + UI layers and composite front-to-back
        (renderer.rs:424 Layers compositing; paused shows the pause page),
        on the device; one copy of the RGBA image to the host."""
        from ..math.color import linear_to_srgb8
        from ..raytrace.render import Rendering, render_hdr
        from ..vui.hud import composite_over

        prof = self.profiler
        ch = self.character
        with prof.span("world"):
            state = self.universe.get_state(ch.space_name)
            cam = self.eye_camera()
            world_light, world_trans = render_hdr(state, cam)
        if self.ui_state is not None and self.options.show_ui:
            with prof.span("ui"):
                # The top page when one is open, else the HUD.
                page = self.pages.current() if self.pages is not None else None
                if page is not None:
                    ui_light, ui_trans = render_hdr(page.snapshot(), page.camera(cam.viewport), include_sky=False)
                else:
                    ui_light, ui_trans = render_hdr(self.ui_state, self.ui_camera, include_sky=False)
            with prof.span("composite"):
                world_light, world_trans = composite_over(ui_light, ui_trans, world_light, world_trans)
        with prof.span("post_process"):
            srgb = linear_to_srgb8(cam.post_process(world_light))
            alpha = torch.clamp(torch.round((1.0 - world_trans) * 255.0), 0, 255).to(torch.uint8)
            rgba = torch.cat([srgb, alpha[..., None]], dim=-1)
        with prof.span("to_host"):
            img = rgba.cpu().numpy()
        return Rendering(cam.viewport.width, cam.viewport.height, img)
