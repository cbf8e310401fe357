"""The port's renders held to the goldens `aic_tpu` made, on the CPU.

- tests/test_render_goldens.py's six self-goldens (`aic_tpu`'s renders),
  each scene built with the port (`chip_smoke.golden_case`, which the
  card's `goldens` phase makes its scenes with) and rendered by the
  port's `render` through the kernels' plain twins, at that file's
  threshold.
- The full-width references of tests/goldens/aic_tpu_1080p/ (written by
  tests/torch_references.py): each PNG decodes to 1920x1080 RGBA, each
  stored light has its world's shape, and the atrium's camera is the one
  the main path renders with.
- The light oracle's bound on the card (`chip_smoke.ORACLE_BOUND`):
  `aic_tpu`'s own smooth light (its jitted `_interpolated_light`) and the
  port's, against the f64 oracle on the samples the card takes of the
  lit cornell-box 16, stay within it.
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from aic_tpu.raytrace import tracer as jtracer  # noqa: E402
from aic_tpu_torch.raytrace import GraphicsOptions, decode_png, render  # noqa: E402
from aic_tpu_torch.testing import Threshold, compare_to_golden  # noqa: E402

GOLDENS = Path(__file__).resolve().parent / "goldens"
REFERENCES = GOLDENS / "aic_tpu_1080p"
#: The worlds of the main paths (chip_smoke.py: the atrium and plaza640 in
#: `main`, demo-city in `city_world`).
WORLD_SHAPES = {"atrium": (60, 35, 40), "plaza640": (640, 8, 640), "demo-city": (96, 28, 96)}


@pytest.fixture(scope="module")
def cases():
    """Each self-golden case's (state, camera), built once."""
    return {}


def _case(cases, name):
    if name not in cases:
        cases[name] = chip_smoke.golden_case(name, "cpu")
    return cases[name]


@pytest.mark.parametrize("name", chip_smoke.SELF_GOLDENS)
def test_self_golden(cases, name, monkeypatch):
    monkeypatch.delenv("AIC_RECORD_GOLDENS", raising=False)
    path = GOLDENS / f"{name}.png"
    assert path.exists()
    state, cam = _case(cases, name)
    ok, msg = compare_to_golden(render(state, cam).data, str(path), Threshold(*chip_smoke.SELF_GOLDEN_THRESHOLD))
    assert ok, f"{name}: {msg}"


def test_references_decode_at_full_width():
    manifest = json.loads((REFERENCES / "manifest.json").read_text())
    assert sorted(manifest) == sorted(WORLD_SHAPES) == sorted(chip_smoke.REFERENCE_TRACERS)
    for world, shape in WORLD_SHAPES.items():
        img = decode_png((REFERENCES / f"{world}.png").read_bytes())
        assert img.shape == (1080, 1920, 4) and img.dtype == np.uint8
        assert img[..., 3].any() and img[..., :3].std() > 0
        with np.load(REFERENCES / f"{world}_light.npz") as f:
            light = f["light"]
        assert light.shape == shape + (4,) and light.dtype == np.uint8
        assert tuple(manifest[world]["shape"]) == shape
        assert manifest[world]["options"] == dict(lighting_display="smoothstep", fog="none")


def test_reference_camera_is_the_main_paths():
    """The atrium's reference was rendered from the camera `chip_smoke.py`
    renders the atrium with (`main.default_camera`, bench.py's framing)."""
    from aic_tpu_torch.content import atrium
    from aic_tpu_torch.main import default_camera

    manifest = json.loads((REFERENCES / "manifest.json").read_text())
    cam = default_camera(atrium(), 1920, 1080, GraphicsOptions(lighting_display="smoothstep", fog="none"))
    np.testing.assert_array_equal(cam.eye_to_world, np.asarray(manifest["atrium"]["eye_to_world"]))


def _jax_smooth_light(state, cube, point, face, mode):
    """`aic_tpu`'s `_interpolated_light` under `jax.jit` (as its phase
    shader runs it) on the port state's arrays."""
    fn = jax.jit(lambda light, sky, c, p, f: jtracer._interpolated_light(
        SimpleNamespace(light=light, sky_faces=sky), c, p, f, mode))
    out = fn(jnp.asarray(state.light.numpy()), jnp.asarray(state.sky_faces.numpy()),
             jnp.asarray(cube, jnp.int32), jnp.asarray(point), jnp.asarray(face, jnp.int32))
    return np.asarray(out, np.float64)


def test_oracle_bound_covers_aic_tpu(cases):
    """On the card's samples of the lit cornell-box 16 (the cornell_lit_
    smoothstep case's state), `aic_tpu`'s smooth light and the port's
    (both functions, on the CPU) are within `chip_smoke.ORACLE_BOUND` of
    the f64 oracle, in both modes."""
    state, _ = _case(cases, "cornell_lit_smoothstep")
    cube, point, face = chip_smoke.surface_samples(state, chip_smoke.ORACLE_SAMPLES, chip_smoke.ORACLE_SEED)
    errs = {}
    for mode, oracle_mode in chip_smoke.ORACLE_MODES:
        want = chip_smoke.oracle_light(state, cube, point, face, oracle_mode)
        jax_err = float(np.abs(_jax_smooth_light(state, cube, point, face, mode) - want).max())
        with torch.no_grad():
            rows, direct = chip_smoke.port_smooth_light(state, cube, point, face, mode)
        errs[mode] = (jax_err, float(np.abs(rows - want).max()), float(np.abs(direct - want).max()))
    print(f"max abs difference to the oracle (aic_tpu, port rows, port direct): {errs}")
    assert chip_smoke.ORACLE_BOUND == max(1e-5, max(e[0] for e in errs.values()))
    assert max(max(e) for e in errs.values()) <= chip_smoke.ORACLE_BOUND
