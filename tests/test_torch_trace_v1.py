"""The port's v1 surface finder (aic_tpu_torch.raytrace.trace_kernel_v1)
and the v1 trace path against `aic_tpu`'s v1 Pallas kernel.

On the CPU the port runs the kernel's plain PyTorch twin
(`surface_finder_plain`). Its 15 output fields are held against
`pallas_trace._run_kernel(..., interpret=True)` on 1024 rays (one Pallas
group): integer fields equal, float fields within 1e-5 relative. The
Pallas kernel advances its group one domain at a time and the twin every
ray at once, so both run until no ray walks. Images of the whole path
(`trace_rays_kernel(megakernel=False)`: launches, the round glue through
the packed cells, shading) are held against `trace_rays_pallas(
megakernel=False, interpret=True)` at atol=2e-3
(tests/test_pallas_trace.py:30). The 640×8×640 plaza, where the auto
dispatch of both packages picks v1, is in tests/test_torch_plaza.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aic_tpu.raytrace import pallas_trace
from aic_tpu_torch.raytrace import trace_kernel, trace_kernel_v1 as v1
from test_pallas_trace import OPTS_PLAIN, grid_rays, scene_atoms, scene_r32, scene_voxels
from test_torch_state import PKGS, SCENES, to_port, fresh_pallas_caches  # noqa: F401 (autouse)
from test_torch_trace import CORNELL, _cornell_rays, random_rays, torch_options

# -- the kernel's 15 fields against the Pallas v1 kernel -------------------------

FIELD_CASES = {
    "atoms": (scene_atoms, lambda: grid_rays(32, 32, -3.0, (0.1, 23.9), (0.1, 23.9), (1.0, 0.12, 0.07))),
    "voxels": (scene_voxels, lambda: random_rays(1024, -4.0, 24.0, seed=3)),
}


def _launch_state(build, rays):
    """(aic_tpu state, port state, v1 ctx, ray constants, 9-field launch
    state) for space-local rays from the initial state."""
    st = build()
    tst = to_port(st)
    ctx = v1.build_bitmask_ctx(tst)
    o, d = rays()
    r, s2, entry = trace_kernel.initial_state(
        tst, torch.as_tensor(o.reshape(-1, 3)), torch.as_tensor(d.reshape(-1, 3)), ctx
    )
    return st, tst, ctx, r, v1.initial_state_v1(s2), entry


def _pallas_fields(st, r, s):
    jctx = pallas_trace.build_bitmask_ctx(st)
    return pallas_trace._run_kernel(
        {k: jnp.asarray(v.numpy()) for k, v in r.items()},
        {k: jnp.asarray(v.numpy()) for k, v in s.items()},
        jctx.l1, jctx.rows, jctx.rdims, jctx.size, jctx.n_regions, v1.ITERS, v1.SUBSTEPS, True,
    )


def _assert_fields_equal(got, want):
    assert not (np.asarray(want["walking"]) == 1).any()
    for k in v1.OUT_FIELDS:
        g, w = got[k].numpy(), np.asarray(want[k])
        if k in v1.FLOAT_FIELDS:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("name", sorted(FIELD_CASES))
def test_surface_finder_fields_match_pallas(name):
    """One launch from the phase-1 state until no ray walks."""
    st, _tst, ctx, r, s, _entry = _launch_state(*FIELD_CASES[name])
    before = v1.LAUNCHES
    got = v1.run_surface_finder(r, s, ctx)
    assert v1.LAUNCHES == before  # CPU tensors: plain version
    assert (got["hit"].numpy() == v1.HIT_OUTER).any()
    _assert_fields_equal(got, _pallas_fields(st, r, s))


def test_surface_finder_inner_round_matches_pallas():
    """The second launch on the voxel scene, after the round glue pushed
    the rays that hit a voxel block into its grid: inner hits and inner
    exits, with inner steps of |1/d|/2^resl."""
    st, tst, ctx, r, s, entry = _launch_state(*FIELD_CASES["voxels"])
    saved, hb = v1.empty_buffers(s["dom"].shape[0], "cpu")
    out = v1.run_surface_finder(r, s, ctx)
    s2, _saved, _hb = v1.advance(tst, ctx, r, entry["d_len"], s, saved, hb, out)
    assert (s2["resl"].numpy() > 0).any()
    got = v1.run_surface_finder(r, s2, ctx)
    hits = set(got["hit"].numpy().tolist())
    assert {v1.HIT_INNER, v1.INNER_EXIT} <= hits
    _assert_fields_equal(got, _pallas_fields(st, r, s2))


# -- tables -----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["atoms", "atrium_small", "cornell16", "voxels"])
def test_bitmask_ctx_equal(name):
    """v1 tables (region rows, then one row per voxel entry at its native
    edge; the L1 row) equal `aic_tpu`'s."""
    st = SCENES[name](PKGS["jax"]).snapshot()
    want = pallas_trace.build_bitmask_ctx(st)
    got = v1.build_bitmask_ctx(to_port(st))
    for k in ("rdims", "size", "n_regions", "n_ventries"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("rows", "l1"):
        w = np.asarray(getattr(want, k))
        np.testing.assert_array_equal(getattr(got, k).numpy().view(w.dtype), w, err_msg=k)


def test_v1_refuses_r32_like_aic_tpu():
    """R32 blocks: both packages' v1 tables refuse them; with the
    megakernel forced off the port raises, naming the missing tracer."""
    st = scene_r32()
    with pytest.raises(ValueError):
        pallas_trace.build_bitmask_ctx(st)
    o, d = random_rays(8, -4.0, 24.0, seed=1)
    with pytest.raises(ValueError, match="XLA tracer"):
        trace_kernel.trace_rays_kernel(
            to_port(st), torch.as_tensor(o), torch.as_tensor(d), torch_options(OPTS_PLAIN),
            megakernel=False,
        )


def test_auto_dispatch_follows_megakernel_fits(monkeypatch):
    """Auto dispatch takes the megakernel where its tables fit and v1
    where `megakernel_fits` says no, with no other change."""
    tst = to_port(scene_voxels())
    o, d = random_rays(64, -4.0, 24.0, seed=2)
    calls = []
    real = v1.trace_phases_v1
    monkeypatch.setattr(v1, "trace_phases_v1", lambda *a: calls.append(1) or real(*a))
    args = (tst, torch.as_tensor(o), torch.as_tensor(d), torch_options(OPTS_PLAIN))
    assert trace_kernel.megakernel_fits(tst)
    want = trace_kernel.trace_rays_kernel(*args)
    assert calls == []
    monkeypatch.setattr(trace_kernel, "megakernel_fits", lambda state: False)
    got = trace_kernel.trace_rays_kernel(*args)
    assert calls == [1]
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=2e-3)


def test_round_budget_reports_unfinished(monkeypatch):
    """Too few rounds for the voxel grids is reported, not hidden."""
    tst = to_port(scene_voxels())
    o, d = grid_rays(32, 32, -2.0, (0.05, 19.95), (0.05, 19.95), (1.0, 0.08, 0.05))
    monkeypatch.setattr(v1, "ROUNDS", 1)
    _l, _t, unfinished = trace_kernel.trace_rays_kernel(
        tst, torch.as_tensor(o), torch.as_tensor(d), torch_options(OPTS_PLAIN), megakernel=False
    )
    assert unfinished


# -- images against trace_rays_pallas(megakernel=False) ---------------------------

IMAGE_CASES = {
    "atoms": (scene_atoms, lambda: grid_rays(32, 32, -3.0, (0.1, 23.9), (0.1, 23.9), (1.0, 0.12, 0.07)), OPTS_PLAIN, {}),
    "voxels": (scene_voxels, lambda: grid_rays(32, 32, -2.0, (0.05, 19.95), (0.05, 19.95), (1.0, 0.08, 0.05)), OPTS_PLAIN, {}),
    "rays_from_inside": (scene_atoms, lambda: random_rays(256, 1.0, 23.0, seed=11), OPTS_PLAIN, {}),
    "incoherent": (scene_voxels, lambda: random_rays(512, -4.0, 24.0, seed=3), OPTS_PLAIN, {"max_rounds": 96}),
    "cornell_smoothstep": (lambda: PKGS["jax"].cornell_box(26).snapshot(), _cornell_rays, CORNELL, {}),
}


@pytest.mark.parametrize("name", sorted(IMAGE_CASES))
def test_image_matches_pallas_v1(name):
    build, rays, opts, pallas_kw = IMAGE_CASES[name]
    st = build()
    o, d = rays()
    want_l, want_t, stats = pallas_trace.trace_rays_pallas(
        st, jnp.asarray(o), jnp.asarray(d), opts, interpret=True, return_stats=True,
        megakernel=False, **pallas_kw,
    )
    assert not bool(stats["unfinished"])
    before = v1.LAUNCHES
    got_l, got_t, unfinished = trace_kernel.trace_rays_kernel(
        to_port(st), torch.as_tensor(o), torch.as_tensor(d), torch_options(opts), megakernel=False
    )
    assert v1.LAUNCHES == before  # CPU tensors: plain version
    assert not unfinished
    assert tuple(got_l.shape) == np.asarray(want_l).shape
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=2e-3)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=2e-3)
