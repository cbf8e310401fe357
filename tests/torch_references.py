"""Full-width references made by `aic_tpu`, for the port's frames on the card.

    JAX_PLATFORMS=cpu python3 tests/torch_references.py [WORLD ...]

A helper, not a test module (pytest collects `test_*.py` only). It
imports both packages and runs `aic_tpu` on the CPU (its XLA tracer:
`aic_tpu/raytrace/render.py:27 _use_pallas` is false off the TPU). For
each world whose 1920x1080 frame `chip_smoke.py` renders on a main path
it writes, under `tests/goldens/aic_tpu_1080p/`:

- `<world>_light.npz`: the packed light u8[X,Y,Z,4] `aic_tpu` traced
  with (key `light`);
- `<world>.png`: `aic_tpu`'s RGBA frame of its snapshot carrying that
  light, written by PIL's optimising encoder;
- `manifest.json`: each world's shape, camera (`eye_to_world`, as the
  port's `main.default_camera` places it, passed as numbers), options,
  how its light was made, its relight passes and the seconds taken.

The worlds and their light:

- `atrium` (`content.atrium()`): converged by `aic_tpu`'s own
  `evaluate_light_dense`, so the card's own relit frame is held to it
  too;
- `demo-city` (seed 0, size 96, as `chip_smoke.city_world` builds it):
  `evaluate_light_dense(state, max_passes=2)`;
- `plaza640` (the port's own world, carried to `aic_tpu` through the
  shared save format): the seed alone, `aic_tpu/light/refproc.py
  fast_evaluate_seed`.

The atrium's relight takes several minutes on an 8-core CPU. Name
worlds to rewrite only those; the manifest keeps the others' entries.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "goldens", "aic_tpu_1080p")
WIDTH, HEIGHT = 1920, 1080
WORLDS = ("atrium", "plaza640", "demo-city")
#: The options `chip_smoke.py` renders its main paths' frames with.
OPTIONS = dict(lighting_display="smoothstep", fog="none")


def port_space(world: str):
    """The world as `chip_smoke.py` builds it, with the port's content code."""
    from aic_tpu_torch.content import TemplateParameters, atrium, build_template_space, plaza

    if world == "atrium":
        return atrium()
    if world == "plaza640":
        return plaza()
    return build_template_space("demo-city", TemplateParameters(seed=0, size=96))


def jax_state(world: str, space):
    """`aic_tpu`'s snapshot of the world: built by its own content code, or
    (plaza640, which `aic_tpu` has no template for) loaded from the port's
    save of `space`."""
    from aic_tpu.content import TemplateParameters, atrium, build_template_space

    if world == "atrium":
        return atrium().snapshot()
    if world == "demo-city":
        return build_template_space("demo-city", TemplateParameters(seed=0, size=96)).snapshot()
    from aic_tpu.io.save import load_universe
    from aic_tpu_torch.io.save import save_universe

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plaza640.json")
        save_universe({"world": space}, path)
        return load_universe(path).spaces["world"].snapshot()


def jax_light(world: str, state):
    """(lit state, passes, how) by `aic_tpu`'s relight for the world."""
    from aic_tpu.light import evaluate_light_dense
    from aic_tpu.light.refproc import fast_evaluate_seed

    if world == "atrium":
        lit, passes = evaluate_light_dense(state)
        return lit, int(passes), "evaluate_light_dense (converged)"
    if world == "demo-city":
        lit, passes = evaluate_light_dense(state, max_passes=2)
        return lit, int(passes), "evaluate_light_dense(max_passes=2)"
    return fast_evaluate_seed(state)[0], 0, "fast_evaluate_seed (the seed alone)"


def make_reference(world: str) -> dict:
    from PIL import Image

    from aic_tpu.raytrace import Camera, GraphicsOptions, Viewport, render
    from aic_tpu_torch.main import default_camera
    from aic_tpu_torch.raytrace import GraphicsOptions as PortOptions

    t0 = time.perf_counter()
    space = port_space(world)
    eye_to_world = default_camera(space, WIDTH, HEIGHT, PortOptions(**OPTIONS)).eye_to_world
    state = jax_state(world, space)
    shape = tuple(int(v) for v in state.contents.shape)
    if shape != tuple(space.bounds.size):
        raise SystemExit(f"{world}: aic_tpu's state {shape} is not the port's world {tuple(space.bounds.size)}")
    t1 = time.perf_counter()
    lit, passes, how = jax_light(world, state)
    light = np.asarray(lit.light)
    t2 = time.perf_counter()
    cam = Camera(GraphicsOptions(**OPTIONS), Viewport(WIDTH, HEIGHT), eye_to_world=eye_to_world)
    frame = render(lit, cam)
    if frame.flaws:
        raise SystemExit(f"{world}: aic_tpu's frame has flaws {frame.flaws}")
    t3 = time.perf_counter()
    os.makedirs(OUT, exist_ok=True)
    np.savez_compressed(os.path.join(OUT, f"{world}_light.npz"), light=light)
    Image.fromarray(frame.data).save(os.path.join(OUT, f"{world}.png"), optimize=True)
    entry = dict(
        shape=list(shape), eye_to_world=np.asarray(eye_to_world, np.float64).tolist(), options=OPTIONS,
        light=how, passes=passes, seconds=dict(build=round(t1 - t0, 1), relight=round(t2 - t1, 1),
                                               frame=round(t3 - t2, 1)),
    )
    print(f"{world}: {entry['seconds']}, {how}, {passes} passes", flush=True)
    return entry


def main(worlds) -> None:
    for w in worlds:
        if w not in WORLDS:
            raise SystemExit(f"unknown world {w!r}: one of {', '.join(WORLDS)}")
    path = os.path.join(OUT, "manifest.json")
    manifest = {}
    if os.path.exists(path):
        with open(path) as f:
            manifest = json.load(f)
    for w in worlds:
        manifest[w] = make_reference(w)
        with open(path, "w") as f:
            json.dump(dict(sorted(manifest.items())), f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    main(sys.argv[1:] or WORLDS)
