"""Command-line frontend of the port (counterpart of `aic_tpu/main.py`).

Builds a template's universe on a device, or opens a universe file
(`UNIVERSE_FILE`: `.json`, the native save, or `.vox`; the session saves
back to it), relights it with `evaluate_light` (the dense passes where
most of the world is dirty, as in a freshly built one), and then:

  record     renders one frame to PNG (`--output frame.png`), or saves the
             world as `.json` or `.vox` when the output names one
  print      prints one frame as 24-bit-colour half blocks
  headless   steps the universe for `--duration` simulated seconds at 60
             ticks a second without rendering
  serve      serves an interactive session with its HUD over HTTP and a
             WebSocket (`--port`; apps/server.py)
  window     plays the session in an OS window (pygame; apps/window.py)
  terminal   plays the session in the terminal (apps/terminal.py); with no
             tty on stdin it prints one frame, as `print` does

    python -m aic_tpu_torch.main --template atrium --graphics record \\
        --output frame.png --width 1920 --height 1080
    python -m aic_tpu_torch.main --template demo-city --graphics serve \\
        --width 1920 --height 1080 --port 8080
    python -m aic_tpu_torch.main world.json --graphics print --device cpu
    python -m aic_tpu_torch.main --template cornell-box --size 16 \\
        --graphics headless --duration 0.2 --device cpu

`--device cuda` (the default) runs the relight, the step and the trace
through the CUDA kernels and refuses to run without a card; `--device
cpu` runs their plain PyTorch twins. Not ported yet: animated records
(`--frames`, `--camera-script`), the `.gltf`/`.stl` exports (ROADMAP
A14) and `.alliscubesjson` files (A9(c)).
"""

from __future__ import annotations

import argparse
import sys
import time
import zlib

import numpy as np


def default_camera(space, width, height, options):
    """The JAX frontend's camera: at the spawn point, looking at the
    centre of the bounds.

    One deviation: where that view is vertical (the atrium's spawn point
    lies straight below the centre, and `aic_tpu`'s look-at then makes
    NaN rays), the eye moves to bench.py's headline framing of the
    atrium, `lower + size·(0.5, 0.75, 0.9)`."""
    from .raytrace import Camera, Viewport

    cam = Camera(options, Viewport(width, height))
    lo = np.asarray(space.bounds.lower, float)
    hi = np.asarray(space.bounds.upper, float)
    center = (lo + hi) / 2
    if space.spawn_position is not None:
        eye = np.asarray(space.spawn_position, float)
    else:
        eye = center + (hi - lo) * np.array([0.4, 0.35, 1.1])
    if np.linalg.norm(np.cross(center - eye, (0.0, 1.0, 0.0))) < 1e-9:
        eye = lo + (hi - lo) * np.array([0.5, 0.75, 0.9])
    cam.look_at(eye, center)
    return cam


def ansi_image(data: np.ndarray) -> str:
    """sRGB image → 24-bit-color half-block terminal art (terminal.rs
    ray_image analog; `aic_tpu/main.py:68-86`)."""
    h = data.shape[0] // 2 * 2
    rows = []
    for y in range(0, h, 2):
        row = []
        for x in range(data.shape[1]):
            top = data[y, x]
            bot = data[y + 1, x]
            row.append(
                f"\x1b[38;2;{top[0]};{top[1]};{top[2]}m"
                f"\x1b[48;2;{bot[0]};{bot[1]};{bot[2]}m▀"
            )
        rows.append("".join(row) + "\x1b[0m")
    return "\n".join(rows)


def _ensure_player(u):
    """Guarantee a 'player' character for session modes on a loaded
    universe document (the desktop's get-or-create character on open)."""
    if "player" in u.characters:
        return
    sname = next(iter(u.spaces))
    sp = u.spaces[sname]
    spawn = (
        tuple(float(x) for x in sp.spawn_position)
        if sp.spawn_position is not None
        else tuple(lo + sz / 2.0 for lo, sz in zip(sp.bounds.lower, sp.bounds.size))
    )
    u.insert_character("player", sname, spawn)


def space_digest(space) -> str:
    """A short identity of a Space's contents: its shape, palette length
    and the CRC-32 of its contents (`[open]` prints it)."""
    crc = zlib.crc32(np.ascontiguousarray(space.contents.astype("<u2")).tobytes())
    return f"{'x'.join(map(str, space.bounds.size))} palette {space.palette_len()} crc {crc:08x}"


def main(argv=None):
    p = argparse.ArgumentParser(prog="aic-tpu-torch")
    p.add_argument(
        "input",
        nargs="?",
        default=None,
        metavar="UNIVERSE_FILE",
        help="universe file to open (.json native, .vox); the session saves "
        "back to it (whence.rs provenance). When omitted, --template builds "
        "a fresh universe.",
    )
    p.add_argument("--template", default="cornell-box")
    p.add_argument(
        "--graphics",
        default="record",
        choices=["record", "print", "headless", "terminal", "window", "serve"],
    )
    p.add_argument("--port", type=int, default=8080, help="serve mode port")
    p.add_argument("--size", type=int, default=None, help="template size")
    p.add_argument("--width", type=int, default=120)
    p.add_argument("--height", type=int, default=80)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default="frame.png")
    p.add_argument("--duration", type=float, default=1.0, help="headless sim seconds")
    p.add_argument("--lighting", default="smoothstep")
    p.add_argument("--no-relight", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device: cuda or cpu")
    # Logging/telemetry (logging.rs LoggingArgs: --verbose,
    # --simplify-log-format, rerun stream → --telemetry JSONL).
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--simplify-log-format", action="store_true")
    p.add_argument("--telemetry", default=None, metavar="FILE.jsonl")
    args = p.parse_args(argv)

    import torch

    from . import logging as aic_logging
    from .content import TemplateParameters, build_universe
    from .light.update import evaluate_light
    from .raytrace import GraphicsOptions, render, save_png

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    aic_logging.install(verbose=args.verbose, simplify_log_format=args.simplify_log_format)
    log = aic_logging.get_logger("aic_tpu_torch.main")
    telemetry = aic_logging.Telemetry(args.telemetry) if args.telemetry else None

    if args.input:
        # Open a universe document; `whence` points back at it so the
        # session's save writes to the origin (save/whence.rs:20).
        from .io.whence import load_universe_file

        u = load_universe_file(args.input, device=device)
        wname = "world" if "world" in u.spaces else next(iter(u.spaces))
        print(f"[open] {u.whence.document_name()}: {len(u.spaces)} spaces; {wname} "
              f"{space_digest(u.spaces[wname])}", file=sys.stderr)
    else:
        try:
            u = build_universe(args.template, TemplateParameters(seed=args.seed, size=args.size), device=device)
        except KeyError as e:
            raise SystemExit(str(e).strip("'\""))
        wname = "world"
    space, state = u.spaces[wname], u.states[wname]
    if not args.no_relight and state.light_enabled:
        t0 = time.time()
        state, n = evaluate_light(state, batch_size=1024, max_rounds=5000)
        u.states[wname] = state
        print(f"[light] {n} cube updates in {time.time() - t0:.1f}s", file=sys.stderr)

    if args.graphics == "headless":
        if telemetry is not None:
            telemetry.attach_to_universe(u)
        n_ticks = int(args.duration * 60)
        t0 = time.time()
        with aic_logging.ProgressBar(n_ticks, "step") as bar:
            for _ in range(n_ticks):
                info = u.step()
                bar.advance()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"[headless] {n_ticks} ticks in {time.time() - t0:.1f}s" + (
            f"; last tick {info.tick}: {info.space_edits} edits, {info.light_updates} light updates, "
            f"queue {info.light_queue}" if n_ticks else ""), file=sys.stderr)
        log.info("[headless] %d ticks in %.1fs", n_ticks, time.time() - t0)
        if telemetry is not None:
            telemetry.close()
        return

    options = GraphicsOptions(lighting_display=args.lighting, fog="none")
    if args.graphics in ("serve", "window") or (args.graphics == "terminal" and sys.stdin.isatty()):
        _ensure_player(u)
        if telemetry is not None:
            telemetry.attach_to_universe(u)
    if args.graphics == "serve":
        from .apps.server import SessionServer
        from .apps.session import Session
        from .raytrace import Viewport

        session = Session(u, viewport=Viewport(args.width, args.height), options=options)
        session.enable_ui()
        # Build the kernels and trace a first frame before serving, so no
        # request waits for a compile.
        t0 = time.time()
        session.maybe_step()
        session.render_with_ui()
        print(f"[render] first session frame {args.width}x{args.height} in {time.time() - t0:.1f}s",
              file=sys.stderr)
        srv = SessionServer(session, port=args.port)
        print(f"serving on http://127.0.0.1:{srv.port}/", file=sys.stderr)
        try:
            srv.serve_forever()
        finally:
            srv.httpd.server_close()
        return
    if args.graphics == "window":
        from .apps.window import run_window_session

        run_window_session(space, state, width=args.width, height=args.height, options=options, universe=u)
        return
    if args.graphics == "terminal" and sys.stdin.isatty():
        from .apps.terminal import run_terminal_session

        run_terminal_session(space, state, width=args.width, height=args.height, options=options, universe=u)
        return
    if args.graphics == "record" and not args.output.endswith(".png"):
        # Non-image outputs: save the scene itself (the reference's
        # `--output` export dispatch, all-is-cubes-desktop/src/record.rs).
        out = args.output
        if out.endswith((".gltf", ".stl")):
            raise SystemExit(f"{out}: the mesh exports are not ported yet (ROADMAP A14)")
        if out.endswith(".vox"):
            from .io.vox import export_vox

            export_vox(space, out)
        else:
            from .io.save import save_universe
            from .universe import Universe

            saved = Universe(device=device)
            saved.insert_space("world", space)
            save_universe(saved, out)
        print(f"wrote {out}", file=sys.stderr)
        return

    cam = default_camera(space, args.width, args.height, options)
    t0 = time.time()
    r = render(state, cam)
    print(f"[render] {args.width}x{args.height} in {time.time() - t0:.1f}s", file=sys.stderr)
    if r.flaws:
        print(f"[render] flaws: {', '.join(r.flaws)}", file=sys.stderr)

    if args.graphics in ("print", "terminal"):
        # terminal without a tty: the one-shot print (terminal.rs -print).
        print(ansi_image(r.data))
        return
    save_png(r, args.output)
    print(f"wrote {args.output}", file=sys.stderr)


if __name__ == "__main__":
    main()
