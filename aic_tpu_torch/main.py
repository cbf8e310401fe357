"""Command-line frontend of the port (counterpart of `aic_tpu/main.py`).

Builds a template's universe on a device, relights it to convergence
with `evaluate_light` (the dense passes for a freshly built world), and
then renders one frame to PNG (`--graphics record`) or prints it to the
terminal as 24-bit-colour half blocks (`--graphics print`), or steps the
universe for `--duration` simulated seconds at 60 ticks a second without
rendering (`--graphics headless`):

    python -m aic_tpu_torch.main --template atrium --graphics record \\
        --output frame.png --width 1920 --height 1080
    python -m aic_tpu_torch.main --template cornell-box --size 16 \\
        --graphics headless --duration 0.2 --device cpu
    python -m aic_tpu_torch.main --template cornell-box --size 8 \\
        --graphics print --width 40 --height 20 --device cpu

`--device cuda` (the default) runs the relight, the step and the trace
through the CUDA kernels and refuses to run without a card; `--device
cpu` runs their plain PyTorch twins. The other graphics modes of
`aic_tpu` are not ported yet.
"""

from __future__ import annotations

import argparse
import sys
import time

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


def main(argv=None):
    p = argparse.ArgumentParser(prog="aic-tpu-torch")
    p.add_argument("--template", default="cornell-box")
    p.add_argument("--graphics", default="record", choices=["record", "print", "headless"])
    p.add_argument("--size", type=int, default=None, help="template size")
    p.add_argument("--width", type=int, default=120)
    p.add_argument("--height", type=int, default=80)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default="frame.png")
    p.add_argument("--duration", type=float, default=1.0, help="headless sim seconds")
    p.add_argument("--lighting", default="smoothstep")
    p.add_argument("--no-relight", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device: cuda or cpu")
    args = p.parse_args(argv)

    import torch

    from .content import TemplateParameters, build_universe
    from .light.update import evaluate_light
    from .raytrace import GraphicsOptions, render, save_png

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    try:
        u = build_universe(args.template, TemplateParameters(seed=args.seed, size=args.size), device=device)
    except KeyError as e:
        raise SystemExit(str(e).strip("'\""))
    space, state = u.spaces["world"], u.states["world"]
    if not args.no_relight and state.light_enabled:
        t0 = time.time()
        state, n = evaluate_light(state, batch_size=1024, max_rounds=5000)
        u.states["world"] = state
        print(f"[light] {n} cube updates in {time.time() - t0:.1f}s", file=sys.stderr)

    if args.graphics == "headless":
        n_ticks = int(args.duration * 60)
        t0 = time.time()
        for _ in range(n_ticks):
            info = u.step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"[headless] {n_ticks} ticks in {time.time() - t0:.1f}s" + (
            f"; last tick {info.tick}: {info.space_edits} edits, {info.light_updates} light updates, "
            f"queue {info.light_queue}" if n_ticks else ""), file=sys.stderr)
        return

    options = GraphicsOptions(lighting_display=args.lighting, fog="none")
    cam = default_camera(space, args.width, args.height, options)
    t0 = time.time()
    r = render(state, cam)
    print(f"[render] {args.width}x{args.height} in {time.time() - t0:.1f}s", file=sys.stderr)
    if r.flaws:
        print(f"[render] flaws: {', '.join(r.flaws)}", file=sys.stderr)

    if args.graphics == "print":
        print(ansi_image(r.data))
        return
    save_png(r, args.output)
    print(f"wrote {args.output}", file=sys.stderr)


if __name__ == "__main__":
    main()
