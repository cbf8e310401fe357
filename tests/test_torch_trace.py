"""The port's traversal megakernel and tracer (aic_tpu_torch.raytrace)
against `aic_tpu`.

On the CPU the port runs the megakernel's plain PyTorch twin
(`trace_kernel.megakernel_plain`). Its 28 per-ray state fields are held
against the Pallas megakernel run in interpret mode (`_run_kernel2(...,
interpret=True)`): integer fields equal, float fields within 1e-5
relative. Images are held against the XLA tracer `trace_rays` at
atol=2e-3, the tolerance of tests/test_pallas_trace.py:30 (the two
`aic_tpu` tracers differ on knife edges).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aic_tpu.raytrace import GraphicsOptions
from aic_tpu.raytrace import pallas_trace
from aic_tpu.raytrace.tracer import trace_rays
from aic_tpu_torch.raytrace import trace_kernel
from aic_tpu_torch.raytrace.options import GraphicsOptions as TorchOptions
from aic_tpu_torch.raytrace.render import Rendering, save_png
from test_pallas_trace import OPTS_PLAIN, grid_rays, scene_atoms, scene_r32, scene_voxels
from test_torch_state import PKGS, to_port, fresh_pallas_caches  # noqa: F401 (autouse)


def torch_options(opts: GraphicsOptions) -> TorchOptions:
    return TorchOptions(**{f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)})


def random_rays(n, lo, hi, seed):
    rng = np.random.RandomState(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


# -- the megakernel's 28 fields against the Pallas kernel ----------------------

FIELD_CASES = {
    "atoms": (scene_atoms, lambda: grid_rays(32, 32, -3.0, (0.1, 23.9), (0.1, 23.9), (1.0, 0.12, 0.07))),
    "voxels": (scene_voxels, lambda: random_rays(1024, -4.0, 24.0, seed=3)),
    "r32": (scene_r32, lambda: random_rays(1024, -4.0, 24.0, seed=5)),
}


@pytest.mark.parametrize("name", sorted(FIELD_CASES))
def test_megakernel_fields_match_pallas(name):
    """One launch from the phase-1 state, run until every ray is done,
    on 1024 rays (one Pallas group)."""
    build, rays = FIELD_CASES[name]
    st = build()
    o, d = rays()
    tst = to_port(st)
    ctx = trace_kernel.build_bitmask_ctx2(tst)
    r, s, _ = trace_kernel.initial_state(
        tst, torch.as_tensor(o.reshape(-1, 3)), torch.as_tensor(d.reshape(-1, 3)), ctx
    )
    before = trace_kernel.LAUNCHES
    got = trace_kernel.run_megakernel(r, s, ctx)
    assert trace_kernel.LAUNCHES == before  # CPU tensors: plain version
    want = pallas_trace._run_kernel2(
        {k: jnp.asarray(v.numpy()) for k, v in r.items()},
        {k: jnp.asarray(v.numpy()) for k, v in s.items()},
        pallas_trace.build_bitmask_ctx2(st), 4096, 8, True,
    )
    assert (got["mode"].numpy() == trace_kernel.MODE_DONE).all()
    assert (np.asarray(want["mode"]) == trace_kernel.MODE_DONE).all()
    assert (got["hit"].numpy() != 0).any()
    for k in trace_kernel.STATE_FIELDS:
        g, w = got[k].numpy(), np.asarray(want[k])
        if k in trace_kernel.FLOAT_FIELDS:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


# -- images against the XLA tracer ----------------------------------------------

SMOOTH_FOG = GraphicsOptions(lighting_display="smoothstep", fog="abrupt", transparency="volumetric")
VOLUMETRIC = GraphicsOptions(lighting_display="none", fog="none", transparency="volumetric")
CORNELL = GraphicsOptions(lighting_display="smoothstep", fog="none", transparency="volumetric")


def _grazing():
    ys = np.arange(0, 24, 1.0, np.float32)
    o = np.stack([np.full_like(ys, -2.0), ys, ys], -1)
    return o, np.tile(np.asarray([1.0, 0.0, 0.0], np.float32), (len(ys), 1))


def _cornell_rays():
    o, d = grid_rays(32, 32, 40.0, (0.0, 26.0), (0.0, 26.0), (-1.0, -0.02, -0.03))
    return o[..., [1, 2, 0]], d[..., [1, 2, 0]]


def _thin_batch():
    o, d = random_rays(1024, -2.0, 25.0, seed=5)
    return o.reshape(2, 512, 3), d.reshape(2, 512, 3)


IMAGE_CASES = {
    "atoms_plain": (scene_atoms, lambda: grid_rays(32, 32, -3.0, (0.1, 23.9), (0.1, 23.9), (1.0, 0.12, 0.07)), OPTS_PLAIN),
    "atoms_smooth_fog": (scene_atoms, lambda: grid_rays(32, 32, -3.0, (0.1, 23.9), (0.1, 23.9), (1.0, 0.12, 0.07)), SMOOTH_FOG),
    "voxels_plain": (scene_voxels, lambda: grid_rays(32, 32, -2.0, (0.05, 19.95), (0.05, 19.95), (1.0, 0.08, 0.05)), OPTS_PLAIN),
    "voxels_volumetric": (scene_voxels, lambda: grid_rays(32, 32, -2.0, (0.05, 19.95), (0.05, 19.95), (1.0, 0.08, 0.05)), VOLUMETRIC),
    "voxels_incoherent": (scene_voxels, lambda: random_rays(512, -4.0, 24.0, seed=3), OPTS_PLAIN),
    "r32_grid": (scene_r32, lambda: grid_rays(32, 32, -2.0, (0.05, 19.95), (0.05, 19.95), (1.0, 0.08, 0.05)), OPTS_PLAIN),
    "r32_incoherent": (scene_r32, lambda: random_rays(256, -4.0, 24.0, seed=5), OPTS_PLAIN),
    "rays_from_inside": (scene_atoms, lambda: random_rays(256, 1.0, 23.0, seed=11), OPTS_PLAIN),
    "cornell_smoothstep": (lambda: PKGS["jax"].cornell_box(26).snapshot(), _cornell_rays, CORNELL),
    "axis_aligned_grazing": (scene_atoms, _grazing, OPTS_PLAIN),
    "thin_batch": (scene_atoms, _thin_batch, OPTS_PLAIN),
}


@pytest.mark.parametrize("name", sorted(IMAGE_CASES))
def test_image_matches_xla_tracer(name):
    build, rays, opts = IMAGE_CASES[name]
    st = build()
    o, d = rays()
    want_l, want_t = trace_rays(st, jnp.asarray(o), jnp.asarray(d), opts, beam_tile=0)
    got_l, got_t, unfinished = trace_kernel.trace_rays_kernel(
        to_port(st), torch.as_tensor(o), torch.as_tensor(d), torch_options(opts)
    )
    assert not unfinished
    assert tuple(got_l.shape) == np.asarray(want_l).shape
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=2e-3)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=2e-3)


def test_budget_exhaustion_reports_unfinished(monkeypatch):
    """A budget too small for the rays is reported, not hidden."""
    st = to_port(scene_voxels())
    o, d = random_rays(64, -4.0, 24.0, seed=3)
    monkeypatch.setattr(trace_kernel, "MAX_ITERS", 1)
    _l, _t, unfinished = trace_kernel.trace_rays_kernel(
        st, torch.as_tensor(o), torch.as_tensor(d), torch_options(OPTS_PLAIN)
    )
    assert unfinished


def test_save_png_round_trip(tmp_path):
    import struct
    import zlib

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (5, 7, 4), dtype=np.uint8)
    path = tmp_path / "x.png"
    save_png(Rendering(7, 5, img), str(path))
    raw = path.read_bytes()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", raw[16:24])
    assert (w, h) == (7, 5)
    idat_len = struct.unpack(">I", raw[33:37])[0]
    data = zlib.decompress(raw[41 : 41 + idat_len])
    rows = np.frombuffer(data, np.uint8).reshape(5, 1 + 7 * 4)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(5, 7, 4), img)
