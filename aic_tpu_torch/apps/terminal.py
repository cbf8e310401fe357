"""Interactive terminal frontend: a live input→step→render loop.

Port of `aic_tpu/apps/terminal.py`; the character's body is read and
written through the session (`body_row`, `Session.set_look`,
`Session.toggle_flying`), on the universe's device.

The analog of the reference's ratatui terminal mode
(all-is-cubes-desktop/src/terminal.rs:41,62): raw-mode keyboard input
drives the Session's InputProcessor, the universe steps on the 60 Hz
FrameClock, and frames raytrace to 24-bit-color half-block ANSI art at
whatever rate the device delivers.

Keys: WASD move · E/C up/down (fly) · arrows look · space jump ·
F toggle fly · P pause · Q / Esc quit · Enter click (activate/tool).
"""

from __future__ import annotations

import os
import select
import sys
import time

import numpy as np

from .session import body_row


def _ansi_image(data: np.ndarray) -> str:
    h = data.shape[0] // 2 * 2
    lines = []
    for y in range(0, h, 2):
        parts = []
        last = None
        for x in range(data.shape[1]):
            t = data[y, x]
            b = data[y + 1, x]
            key = (t[0], t[1], t[2], b[0], b[1], b[2])
            if key != last:
                parts.append(
                    f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m"
                )
                last = key
            parts.append("▀")
        lines.append("".join(parts) + "\x1b[0m\x1b[K")
    return "\r\n".join(lines)


class TerminalMain:
    """Owns terminal raw mode + the interactive loop (terminal.rs:62)."""

    LOOK_STEP = 10.0  # degrees per arrow press

    def __init__(self, session, max_fps: float = 30.0):
        self.session = session
        self.max_fps = max_fps
        self._fps = 0.0

    # --- raw terminal handling ------------------------------------------
    def __enter__(self):
        import termios
        import tty

        self._fd = sys.stdin.fileno()
        self._saved = termios.tcgetattr(self._fd)
        tty.setcbreak(self._fd)
        sys.stdout.write("\x1b[?25l\x1b[2J")  # hide cursor, clear
        return self

    def __exit__(self, *exc):
        import termios

        termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)
        sys.stdout.write("\x1b[?25h\x1b[0m\n")
        sys.stdout.flush()

    def _read_keys(self) -> list[str]:
        """Drain pending stdin bytes into key tokens (incl. escape seqs)."""
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = os.read(self._fd, 1).decode(errors="ignore")
            if ch == "\x1b":
                if select.select([sys.stdin], [], [], 0.01)[0]:
                    seq = os.read(self._fd, 2).decode(errors="ignore")
                    keys.append(
                        {"[A": "up", "[B": "down", "[C": "right", "[D": "left"}.get(
                            seq, "esc"
                        )
                    )
                else:
                    keys.append("esc")
            else:
                keys.append(ch)
        return keys

    # --- the loop ---------------------------------------------------------
    def run(self):
        s = self.session
        ch = s.character
        # Key-up events don't exist in cbreak mode: held movement keys are
        # emulated by a short decay window per key.
        held: dict[str, float] = {}
        HOLD = 0.25

        while not s.quit_requested:
            now = time.monotonic()
            for k in self._read_keys():
                if k in ("q", "esc"):
                    s.quit_requested = True
                elif k == "p":
                    s.paused = not s.paused
                elif k == "f":
                    s.toggle_flying()
                elif k in ("up", "down", "left", "right"):
                    row = body_row(s.universe, ch.body_index)
                    yaw, pitch = float(row["yaw"]), float(row["pitch"])
                    if k == "left":
                        yaw += self.LOOK_STEP
                    elif k == "right":
                        yaw -= self.LOOK_STEP
                    elif k == "up":
                        pitch = min(pitch + self.LOOK_STEP, 89.0)
                    else:
                        pitch = max(pitch - self.LOOK_STEP, -89.0)
                    s.set_look(yaw, pitch)
                elif k in ("\r", "\n"):
                    s.click(s.camera.viewport.width / 2, s.camera.viewport.height / 2)
                else:
                    held[k] = now

            s.input.keys = {k for k, t in held.items() if now - t < HOLD}
            s.maybe_step(now)

            t0 = time.perf_counter()
            rendering = s.render_with_ui()
            frame_dt = time.perf_counter() - t0
            self._fps = 0.8 * self._fps + 0.2 / max(frame_dt, 1e-6)

            pos = body_row(s.universe, ch.body_index)["position"]
            status = (
                f"\x1b[0m {self._fps:5.1f} fps render | "
                f"pos {pos[0]:7.2f} {pos[1]:7.2f} {pos[2]:7.2f} | "
                f"{'PAUSED | ' if s.paused else ''}"
                f"WASD move, arrows look, F fly, Q quit\x1b[K"
            )
            sys.stdout.write("\x1b[H" + _ansi_image(rendering.data) + "\r\n" + status)
            sys.stdout.flush()

            # Frame pacing.
            budget = 1.0 / self.max_fps
            leftover = budget - (time.monotonic() - now)
            if leftover > 0:
                time.sleep(leftover)


def run_terminal_session(space, state, width=120, height=80, options=None, universe=None):
    """Build a Session around `space` (with `state`, its device state) or
    a pre-loaded `universe`, and run the interactive loop."""
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
                lo + sz / 2.0 for lo, sz in zip(space.bounds.lower, space.bounds.size)
            )
        )
        u.insert_character("player", "world", spawn)
    session = Session(u, viewport=Viewport(width, height), options=options)
    session.enable_ui()
    with TerminalMain(session) as tm:
        tm.run()
