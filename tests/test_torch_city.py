"""Demo-city (`content/city.py`, with its exhibits and the modules they pull
in) in the port against `aic_tpu`.

- Full size (96×28×96, seed 0, built once per package for the module):
  the port's Space equals `aic_tpu`'s — contents, light and dirty marks
  after the fast seed, the spawn point, 226 palette entries in the same
  order, each evaluated the same, and the snapshot field for field (R32
  octant rows and wide classify pages among the megakernel tables). A
  48×32 frame of it through K1's plain version equals `aic_tpu`'s
  `render_hdr` (its XLA tracer on the CPU) within 2e-3
  (tests/test_pallas_trace.py:30), and its listed phase loop equals the
  all-ray loop bit for bit (`tests/test_torch_phases.py`).
- Size 48 (no exhibits): both universes from `build_universe`, `aic_tpu`'s
  state carried across (`to_port`), stepped 12 ticks from the fast light
  seed as bench.py's `step_demo_city_ms` steps it (bench.py:217-238; a
  load relight would not survive the first tick, whose palette growth
  rebuilds the state from the host Space in both packages):
  contents equal every tick, the player's body within 1e-4
  (tests/test_torch_physics.py), light within one packed step, statuses
  equal.
"""

import numpy as np
import pytest

import aic_tpu.content as jc
import aic_tpu_torch.content as tc
from aic_tpu.raytrace import Camera as JaxCamera
from aic_tpu.raytrace import GraphicsOptions as JaxOptions
from aic_tpu.raytrace import Viewport as JaxViewport
from aic_tpu.raytrace.render import render_hdr as jax_render_hdr
from aic_tpu_torch import main as torch_main
from aic_tpu_torch.raytrace import GraphicsOptions, render_hdr, trace_kernel
from aic_tpu_torch.text import font as tfont
from test_torch_content import assert_spaces_equal
from test_torch_physics import ATOL
from test_torch_state import to_port, fresh_pallas_caches  # noqa: F401 (autouse)

PIXEL_ATOL = 2e-3
W, H = 48, 32


@pytest.fixture(scope="module")
def cities():
    real = tfont.rasterize_pil

    def refuse(text):
        raise AssertionError(f"the port drew {text!r} with PIL")

    tfont.rasterize_pil = refuse
    tfont.rasterize_text.cache_clear()
    try:
        ts = tc.build_template_space("demo-city", tc.TemplateParameters(seed=0, size=96))
    finally:
        tfont.rasterize_pil = real
    js = jc.build_template_space("demo-city", jc.TemplateParameters(seed=0, size=96))
    return js, ts


@pytest.fixture(scope="module")
def city_state(cities):
    """The port's snapshot of the full city on the CPU, taken once for
    the module (the tests read it and never write into it)."""
    return cities[1].snapshot(device="cpu")


def test_city_equals_aic_tpu(cities):
    js, ts = cities
    assert ts.palette_len() == js.palette_len() == 226
    assert_spaces_equal(js, ts)


def test_city_takes_k1_r32_and_wide_pages(city_state):
    st = city_state
    assert tuple(st.contents.shape) == (96, 28, 96)
    assert int((st.tables.voxel_index >= 0).sum()) == 177
    assert trace_kernel.megakernel_fits(st)
    ctx = trace_kernel.get_bitmask_ctx2(st)
    assert ctx.has_r32 and ctx.wide_pages


def test_city_frame_matches_aic_tpu(cities, city_state):
    """`main.default_camera`'s view of the full city at 48×32: the port
    through K1's plain version against `aic_tpu`'s XLA tracer."""
    js, ts = cities
    opts = GraphicsOptions(lighting_display="smoothstep", fog="none")
    tcam = torch_main.default_camera(ts, W, H, opts)
    lo, hi = np.asarray(ts.bounds.lower, float), np.asarray(ts.bounds.upper, float)
    jcam = JaxCamera(JaxOptions(lighting_display="smoothstep", fog="none"), JaxViewport(W, H))
    jcam.look_at(np.asarray(js.spawn_position, float), (lo + hi) / 2)
    np.testing.assert_allclose(tcam.eye_to_world, jcam.eye_to_world)
    want_l, want_t = jax_render_hdr(js.snapshot(), jcam)
    before = trace_kernel.LAUNCHES
    got_l, got_t, stats = render_hdr(city_state, tcam, with_stats=True)
    assert trace_kernel.LAUNCHES == before and not stats["unfinished"]
    assert float(got_l.max()) > 0.05
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=PIXEL_ATOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=PIXEL_ATOL)


def test_city_listed_phase_loop_matches_all_rays(cities, city_state, monkeypatch):
    """`main.default_camera`'s 48×32 view of the full city through the
    megakernel's listed phase loop equals the all-ray loop bit for bit
    (K1's plain version on the CPU; R32 octant rows, wide pages)."""
    from test_torch_phases import assert_bit_equal, frame_both_ways

    ts = cities[1]
    opts = GraphicsOptions(lighting_display="smoothstep", fog="none")
    o, d = torch_main.default_camera(ts, W, H, opts).pixel_rays(device="cpu")
    (got, want), listed = frame_both_ways(city_state, o.reshape(-1, 3), d.reshape(-1, 3), opts,
                                          monkeypatch)
    assert_bit_equal(got, want)
    assert listed[0] > 0
    assert bool((got[3][0]["hit_kind"] != 0).any())


def test_city48_steps_match_aic_tpu():
    uj = jc.build_universe("demo-city", jc.TemplateParameters(seed=0, size=48))
    ut = tc.build_universe("demo-city", tc.TemplateParameters(seed=0, size=48), device="cpu")
    ut.states["world"] = to_port(uj.states["world"])
    np.testing.assert_allclose(ut.bodies.position.numpy(), np.asarray(uj.bodies.position))
    for i in range(12):
        ij, it = uj.step(), ut.step()
        sj, st = uj.states["world"], ut.states["world"]
        np.testing.assert_array_equal(st.contents.numpy(), np.asarray(sj.contents).astype(np.int32), err_msg=f"tick {i}")
        np.testing.assert_array_equal(ut.spaces["world"].contents, uj.spaces["world"].contents, err_msg=f"tick {i}")
        a, b = st.light.numpy().astype(np.int32), np.asarray(sj.light).astype(np.int32)
        assert int(np.abs(a[..., :3] - b[..., :3]).max()) <= 1, f"tick {i}"
        np.testing.assert_array_equal(a[..., 3], b[..., 3], err_msg=f"tick {i}")
        np.testing.assert_allclose(ut.bodies.position.numpy(), np.asarray(uj.bodies.position), atol=ATOL,
                                   err_msg=f"tick {i}")
        np.testing.assert_allclose(ut.bodies.velocity.numpy(), np.asarray(uj.bodies.velocity), atol=ATOL,
                                   err_msg=f"tick {i}")
        assert it.space_edits == ij.space_edits, i
    assert ut.spaces["world"].palette_len() == uj.spaces["world"].palette_len()
