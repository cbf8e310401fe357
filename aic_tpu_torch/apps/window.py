"""Window frontend: a live OS-window session loop (winit analog).

Port of `aic_tpu/apps/window.py`; pygame is imported when a window is
made, never at import time.

The reference's desktop frontend (all-is-cubes-desktop/src/winit.rs:176,
334-440) owns a winit event loop: window events feed the InputProcessor
(input.rs:39 — key press/release state, mouselook capture with cursor
grab, click dispatch), redraws render the session camera and present.
Here the OS surface is pygame/SDL (the toolkit this environment ships);
the traced frame is blitted to the window each redraw. The event→intent
mapping is the session's own InputState binding table, so terminal and
window frontends share all command semantics.

Mouselook follows input.rs's capture model: click grabs the pointer
(relative mouse mode), Esc releases it; while captured, relative motion
turns the character at MOUSELOOK_SENSITIVITY degrees/px and clicks
dispatch tools; while free, clicks first try the UI layer.

Headless test support: SDL's "dummy" video driver drives the identical
code path without a display (tests/test_torch_frontends.py).
"""

from __future__ import annotations

import os
import time

import numpy as np

# Mouselook sensitivity lives in InputState (session.MOUSELOOK_SCALE,
# input.rs:200): deltas buffer there and are consumed once per step.


def _pygame():
    if "DISPLAY" not in os.environ and "SDL_VIDEODRIVER" not in os.environ:
        os.environ["SDL_VIDEODRIVER"] = "dummy"
    os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
    import pygame

    return pygame


class WindowMain:
    """Owns the OS window + the interactive loop (winit.rs:334 run loop)."""

    def __init__(self, session, max_fps: float = 60.0, title="all-is-cubes"):
        self.session = session
        self.max_fps = max_fps
        self.title = title
        self.captured = False
        self._fps = 0.0
        self.pg = _pygame()
        self.frames = 0

    def __enter__(self):
        pg = self.pg
        pg.display.init()
        vp = self.session.camera.viewport
        self.screen = pg.display.set_mode((vp.width, vp.height))
        self._set_title()
        pg.key.set_repeat()  # key state, not repeats (input.rs held keys)
        return self

    def _set_title(self):
        """Window title from the universe's document name (desktop
        session.rs:204: '<document> — <app>' when the universe has an
        identity, the fixed title otherwise)."""
        doc = self.session.document_name()
        self.pg.display.set_caption(
            f"{doc} — {self.title}" if doc else self.title
        )

    def __exit__(self, *exc):
        self._set_capture(False)
        self.pg.display.quit()

    # --- input ------------------------------------------------------------
    def _set_capture(self, on: bool):
        """Mouselook capture (input.rs:citation has_interest_in_pointer /
        winit.rs cursor grab): relative mouse mode while captured."""
        pg = self.pg
        self.captured = on
        try:
            pg.event.set_grab(on)
            pg.mouse.set_visible(not on)
            pg.mouse.set_relative_mode(on)
        except Exception:
            pass  # dummy driver has no pointer to grab

    def _key_name(self, event) -> str | None:
        """Translate a pygame key event to a binding-table key token."""
        pg = self.pg
        if event.key == pg.K_SPACE:
            return " "
        if event.key == pg.K_RETURN:
            return "\r"
        name = pg.key.name(event.key)
        return name if len(name) == 1 else name  # arrows: "up", "left", ...

    def handle_events(self) -> None:
        """Pump one batch of window events into session intents
        (winit.rs:373 window_event match)."""
        pg = self.pg
        s = self.session
        for event in pg.event.get():
            if event.type == pg.QUIT:
                s.quit_requested = True
            elif event.type == pg.KEYDOWN:
                k = self._key_name(event)
                if event.key == pg.K_ESCAPE:
                    if self.captured:
                        self._set_capture(False)
                    else:
                        s.paused = not s.paused
                        s.refresh_ui()
                elif k == "\r":
                    vp = s.camera.viewport
                    s.click(vp.width / 2, vp.height / 2)
                elif k == "p":
                    s.paused = not s.paused
                    s.refresh_ui()
                elif k == "f":
                    self._toggle_fly()
                elif k == "q":
                    s.quit_requested = True
                elif k == "s" and (event.mod & pg.KMOD_CTRL):
                    # Save back to the universe's origin (whence.rs save;
                    # desktop Ctrl-S flow). No origin -> notify, no crash.
                    try:
                        name = s.save_universe()
                        s.show_notification(f"Saved {name}")
                    except ValueError as e:
                        s.show_notification(str(e))
                elif k and s.input.command(k) and s.input.command(k)[0] == "slot":
                    s.select_slot(s.input.command(k)[1])
                elif k:
                    s.input.key_down(k)
            elif event.type == pg.KEYUP:
                k = self._key_name(event)
                if k:
                    s.input.key_up(k)
            elif event.type == pg.DROPFILE:
                # Drag-dropped universe file (winit.rs:506 DroppedFile):
                # load it and make it the live universe; the window title
                # picks up the new document name.
                try:
                    s.open_universe_file(event.file)
                    self._set_title()
                    s.show_notification(f"Opened {s.document_name()}")
                except Exception as e:  # noqa: BLE001 - surfaced to user
                    s.show_notification(f"Failed to open: {e}")
            elif event.type == pg.WINDOWFOCUSLOST:
                # input.rs:165 key_focus(false): never leave keys stuck.
                s.input.key_focus(False)
            elif event.type == pg.WINDOWFOCUSGAINED:
                s.input.key_focus(True)
            elif event.type == pg.MOUSEMOTION:
                if self.captured and not s.paused:
                    dx, dy = event.rel
                    s.input.mouselook_delta(dx, dy)  # consumed per step
                else:
                    # Track the free cursor in NDC for picking
                    # (input.rs:214 mouse_ndc_position).
                    vp = s.camera.viewport
                    x, y = event.pos
                    s.input.mouse_ndc = (
                        2.0 * (x + 0.5) / vp.width - 1.0,
                        1.0 - 2.0 * (y + 0.5) / vp.height,
                    )
            elif event.type == pg.MOUSEBUTTONDOWN:
                if not self.captured:
                    # Free cursor: paused → UI-page click; in play → the
                    # first click (re)captures the pointer, like the
                    # reference's grab-on-click (winit.rs cursor grab).
                    if s.paused:
                        x, y = event.pos
                        s.click(x, y, 0 if event.button == 1 else 1)
                    else:
                        self._set_capture(True)
                else:
                    vp = s.camera.viewport
                    s.click(
                        vp.width / 2,
                        vp.height / 2,
                        0 if event.button == 1 else 1,
                    )

    def _toggle_fly(self):
        self.session.toggle_flying()

    # --- frame --------------------------------------------------------------
    def frame(self, now: float | None = None) -> np.ndarray:
        """One loop iteration: events → step → render → present.
        Returns the presented sRGB frame (H, W, 4)."""
        pg = self.pg
        s = self.session
        now = time.monotonic() if now is None else now
        self.handle_events()
        s.maybe_step(now)
        t0 = time.perf_counter()
        rendering = s.render_with_ui()
        self._fps = 0.8 * self._fps + 0.2 / max(time.perf_counter() - t0, 1e-6)
        frame = np.asarray(rendering.data)
        surf = pg.surfarray.make_surface(
            np.swapaxes(frame[..., :3], 0, 1)
        )
        self.screen.blit(surf, (0, 0))
        pg.display.flip()
        pg.display.set_caption(
            f"{self.title} | {self._fps:5.1f} fps | "
            f"{'PAUSED | ' if s.paused else ''}{s.info_text}"
        )
        self.frames += 1
        return frame

    def run(self):
        while not self.session.quit_requested:
            start = time.monotonic()
            self.frame(start)
            leftover = 1.0 / self.max_fps - (time.monotonic() - start)
            if leftover > 0:
                time.sleep(leftover)


def run_window_session(
    space, state, width=640, height=360, options=None, universe=None
):
    """Build a Session around `space` (with `state`, its device state) or
    a pre-loaded `universe`, which keeps its whence/save-back origin, and
    run the window loop (winit.rs:176 create_window + main loop)."""
    from ..raytrace import Viewport
    from ..universe import Universe
    from .session import Session

    if universe is not None:
        u = universe
    else:
        u = Universe(device=state.device)
        u.insert_space("world", space)
        u.states["world"] = state
        spawn = (
            tuple(float(x) for x in space.spawn_position)
            if space.spawn_position is not None
            else tuple(
                lo + sz / 2.0
                for lo, sz in zip(space.bounds.lower, space.bounds.size)
            )
        )
        u.insert_character("player", "world", spawn)
    session = Session(u, viewport=Viewport(width, height), options=options)
    session.enable_ui()
    with WindowMain(session) as wm:
        wm.run()
