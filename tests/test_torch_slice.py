"""The port's main path end to end against `aic_tpu`, on the small atrium.

The slice is `Space.snapshot` → `evaluate_light_dense` → `render` (bloom,
tone mapping, sRGB) at 64×48 with smooth lighting, on
`atrium(width=24, depth=16, floors=2)`, framed like bench.py's headline.
On the CPU both packages relight by plain Jacobi and the port traces with
the megakernel's plain twin.

Each stage is held to its own tolerance: the relight takes the same
passes and lands within one packed step (statuses equal); each lit state
renders to HDR within 2e-3 (tests/test_pallas_trace.py:30) and to RGBA
within ±1 on ≥ 99.9% of pixels. The port's light differs from the XLA
pass's by one packed step in a few cubes (f32 against bf16 face rows),
so the two end-to-end frames are compared through those stages rather
than directly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aic_tpu.light.dense import evaluate_light_dense as jax_evaluate
from aic_tpu.raytrace import Camera as JaxCamera
from aic_tpu.raytrace import GraphicsOptions as JaxOptions
from aic_tpu.raytrace import Viewport as JaxViewport
from aic_tpu.raytrace.render import render as jax_render
from aic_tpu.raytrace.render import render_hdr as jax_render_hdr
from aic_tpu_torch import main as torch_main
from aic_tpu_torch.light import evaluate_light_dense as torch_evaluate
from aic_tpu_torch.raytrace import Camera, GraphicsOptions, Viewport, render, render_hdr
from aic_tpu_torch.raytrace import trace_kernel
from test_torch_state import PKGS, to_port, fresh_pallas_caches  # noqa: F401 (autouse)

W, H = 64, 48


@pytest.fixture(scope="module")
def slice_run():
    space = PKGS["jax"].atrium(width=24, depth=16, floors=2)
    st = space.snapshot()
    jax_lit, jax_passes = jax_evaluate(st)
    torch_lit, torch_passes = torch_evaluate(to_port(st))
    size = np.asarray(st.contents.shape, np.float64)
    lower = np.asarray(st.lower, np.float64)
    eye, target = lower + size * np.array([0.5, 0.75, 0.9]), lower + size / 2
    jcam = JaxCamera(JaxOptions(lighting_display="smoothstep", fog="none"), JaxViewport(W, H))
    jcam.look_at(eye, target)
    tcam = Camera(GraphicsOptions(lighting_display="smoothstep", fog="none"), Viewport(W, H))
    tcam.look_at(eye, target)
    return dict(
        st=st, jax_lit=jax_lit, jax_passes=jax_passes, torch_lit=torch_lit,
        torch_passes=torch_passes, jcam=jcam, tcam=tcam, space=space,
    )


def test_relight_same_passes_within_one_step(slice_run):
    r = slice_run
    assert r["torch_passes"] == r["jax_passes"]
    want = np.asarray(r["jax_lit"].light).astype(np.int32)
    got = r["torch_lit"].light.numpy().astype(np.int32)
    assert np.abs(got[..., :3] - want[..., :3]).max() <= 1
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    assert not bool((r["torch_lit"].light_dirty > 0).any())


@pytest.mark.parametrize("light_from", ["jax", "torch"])
def test_frame_matches(slice_run, light_from):
    """The same lit state renders to the same frame in both packages."""
    r = slice_run
    if light_from == "jax":
        jst, tst = r["jax_lit"], to_port(r["jax_lit"])
    else:
        tst = r["torch_lit"]
        jst = dataclasses.replace(r["jax_lit"], light=jnp.asarray(tst.light.numpy()))
    # With its stats, as `jax_render` below traces it: one compile for both.
    want_l, want_t, _ = jax_render_hdr(jst, r["jcam"], with_stats=True)
    before = trace_kernel.LAUNCHES
    got_l, got_t, stats = render_hdr(tst, r["tcam"], with_stats=True)
    assert trace_kernel.LAUNCHES == before  # CPU tensors: plain version
    assert not stats["unfinished"]
    got_l2, got_t2 = render_hdr(tst, r["tcam"])  # `aic_tpu`'s pair without stats
    assert torch.equal(got_l2, got_l) and torch.equal(got_t2, got_t)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=2e-3)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=2e-3)

    want = jax_render(jst, r["jcam"])
    got = render(tst, r["tcam"])
    assert got.flaws == want.flaws == ()
    assert got.data.shape == want.data.shape == (H, W, 4)
    close = np.abs(got.data.astype(np.int32) - want.data.astype(np.int32)).max(-1) <= 1
    assert close.mean() >= 0.999
    assert got.data[..., :3].reshape(-1, 3).std(0).max() > 0  # not a constant frame
    assert (got.data[..., 3] > 0).mean() > 0.5


def test_default_camera_frames_the_atrium(slice_run):
    """The port's frontend camera: the spawn view is vertical in the
    atrium, so it takes bench.py's headline framing (the fixture's)."""
    cam = torch_main.default_camera(slice_run["space"], W, H, GraphicsOptions())
    np.testing.assert_allclose(cam.eye_to_world, slice_run["tcam"].eye_to_world)
    o, d = cam.pixel_rays(device="cpu")
    assert torch.isfinite(o).all() and torch.isfinite(d).all()


def test_main_writes_png(tmp_path):
    out = tmp_path / "frame.png"
    torch_main.main([
        "--template", "cornell-box", "--size", "8", "--graphics", "record",
        "--output", str(out), "--width", "24", "--height", "16", "--device", "cpu",
    ])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
