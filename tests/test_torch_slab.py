"""The port's slab-sharded world (`aic_tpu_torch.parallel.slab`) on 4 CPU
ranks over gloo, against the port's one-process passes and `aic_tpu`'s
slab-sharded world on a 4-device mesh.

The scene is tests/test_slab.py's 32×12×16 world (pillars across the
cuts, glass, a lamp on a cut, a voxel block), built in both packages,
split in slabs of 8, at light distance 5 (a halo of 6 planes: one hop)
and 9 (10 planes: two hops). One world of ranks (`parallel.spawn`) runs
every rank-side case; `aic_tpu`'s side is computed once per module.

Tolerances: the slab pass equals the port's unsharded `relight_all_pass`
bit for bit (the design's claim, `parallel/slab.py`), and `aic_tpu`'s
within one packed step, statuses equal (the packages sum a cube's rays in
another order); the pass counts to convergence within one (a sum one ulp
apart can cross the stop threshold a pass earlier); the slab traces
within tests/test_slab.py's 5e-3 of the one-process traces of both
packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aic_tpu.parallel.slab as jslab
from aic_tpu.parallel.mesh import make_mesh as jmake_mesh
from aic_tpu.raytrace import GraphicsOptions as JOptions
from aic_tpu.raytrace.tracer import trace_rays as jtrace_rays
from aic_tpu_torch.light import dense
from aic_tpu_torch.light.dense import _pair_tables
from aic_tpu_torch.parallel import spawn
from aic_tpu_torch.raytrace import GraphicsOptions as TOptions
from aic_tpu_torch.raytrace.tracer import trace_rays
from test_slab import CAMS, _ray_fan
from test_torch_state import PKGS, fresh_pallas_caches, to_port  # noqa: F401 (autouse)
from torch_rank_workers import RANKS_TIMEOUT, slab_worker

RANKS = 4
MDS = (5, 9)  # pad 6 < slab 8: one hop; pad 10 > slab 8: two hops
SLAB_ATOL = 5e-3  # tests/test_slab.py's slab-vs-replicated tolerance
OPTIONS = [
    dict(lighting_display="none", fog="none", transparency="surface"),
    dict(lighting_display="flat", fog="none", transparency="volumetric"),
    dict(lighting_display="smoothstep", fog="distance", transparency="volumetric"),
]
#: Rays that miss the world, graze one slab, or run along a cut plane
#: (tests/test_slab.py:163): dx == 0 rays on the x = 16 cut included.
EDGE_O = np.array([[16.0, 50.0, 8.0], [16.0, 6.0, -9.0], [4.0, 0.5, -9.0], [-5.0, 2.0, 7.5]], np.float32)
EDGE_D = np.array([[0, 1, 0], [0, 0, 1], [0, 0.05, 1], [1, 0, 0]], np.float32)


def scene(p, md):
    """tests/test_slab.py's scene, in package `p`."""
    b = p.block
    sp = p.Space(p.GridAab.from_lower_size((0, 0, 0), (32, 12, 16)),
                 physics=p.SpacePhysics(sky=p.Sky.uniform((0.6, 0.7, 0.9)), light_max_distance=md))
    sp.fill(p.GridAab.from_lower_size((0, 0, 0), (32, 1, 16)), b.from_color((0.5, 0.5, 0.4, 1.0)))
    red = b.from_color((0.9, 0.2, 0.2, 1.0))
    for x in range(3, 32, 5):
        for y in range(1, 4):
            sp.set((x, y, 7), red)
    glass = b.Block(b.Atom(color=(0.3, 0.9, 0.4, 0.4)))
    sp.set((11, 1, 3), glass)
    sp.set((12, 1, 3), glass)
    sp.set((16, 2, 10), b.Block(b.Atom(color=(0, 0, 0, 1.0), emission=(3.0, 2.0, 1.0))))
    vox = p.Space(p.GridAab.cube(4))
    for i in range(4):
        vox.set((i, i, i), b.from_color((0.9, 0.9, 0.1, 1.0)))
    sp.set((19, 1, 12), b.Block(b.Recur(space=vox, resolution=4)))
    return sp


def rays():
    fans = [_ray_fan(eye, fwd) for eye, fwd in CAMS]
    return {"fans": (np.concatenate([o for o, _ in fans]), np.concatenate([d for _, d in fans])),
            "edges": (EDGE_O, EDGE_D)}


def _jitted_slab_pass(orig):
    """`aic_tpu`'s `relight_pass_slab`, compiled once per sharded world:
    called eagerly, its shard_map compiles anew on every pass (~20 s on
    the CPU)."""
    compiled = {}

    def relight_pass_slab(sh, lanes=None):
        key = (id(sh.tables), sh.global_size, lanes)
        if key not in compiled:
            def one(vols):
                sh2 = dataclasses.replace(sh, vols=dict(vols))
                stats = orig(sh2, lanes=lanes)
                return sh2.vols["light"], stats["max_diff"]

            compiled[key] = jax.jit(one)
        light, max_diff = compiled[key](sh.vols)
        sh.vols["light"] = light
        relight_pass_slab.lights.append(light)
        return {"max_diff": max_diff}

    relight_pass_slab.lights = []
    return relight_pass_slab


@pytest.fixture(scope="module")
def runs():
    """Both packages' results. `aic_tpu`: per light distance the gathered
    light after one slab pass, and `evaluate_light_slab`'s passes (the
    first of which is that pass), on a 4-device mesh; its one-process
    trace of the lit md-5 world under the richest options. The port: the
    ranks' results (`torch_rank_workers.slab_worker`)."""
    mesh = jmake_mesh(RANKS, axis="slab")
    jax_out = {"pass": {}, "passes": {}}
    worlds, jstates = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        fast = _jitted_slab_pass(jslab.relight_pass_slab)
        mp.setattr(jslab, "relight_pass_slab", fast)
        for md in MDS:
            jsp = scene(PKGS["jax"], md)
            st = jsp.snapshot()
            jsp.fast_evaluate_light()
            lit = jsp.snapshot()
            jstates[md] = (st, lit)
            worlds[md] = (to_port(st), to_port(lit))
            fast.lights.clear()
            jax_out["passes"][md] = jslab.evaluate_light_slab(jslab.shard_space(st, mesh))
            jax_out["pass"][md] = np.concatenate(list(np.asarray(fast.lights[0])), axis=0)
    o, d = np.concatenate([r[0] for r in rays().values()]), np.concatenate([r[1] for r in rays().values()])
    jl, jt = jtrace_rays(jstates[5][1], jnp.asarray(o), jnp.asarray(d), JOptions(**OPTIONS[2]), beam_tile=0)
    jax_out["trace"] = (np.asarray(jl), np.asarray(jt))
    narrow = PKGS["torch"].Space(PKGS["torch"].GridAab.from_lower_size((0, 0, 0), (30, 4, 4))).snapshot(device="cpu")
    (port, *rest) = spawn(slab_worker, RANKS, "cpu", "gloo",
                          args=(worlds, rays(), [TOptions(**k) for k in OPTIONS], narrow), timeout=RANKS_TIMEOUT)
    assert rest == [None] * (RANKS - 1)
    return jax_out, port, worlds


def _within_one_step(got, want):
    got, want = np.asarray(got).astype(np.int32), np.asarray(want).astype(np.int32)
    assert np.abs(got[..., :3] - want[..., :3]).max() <= 1
    np.testing.assert_array_equal(got[..., 3], want[..., 3])


def test_ranks_import_no_jax(runs):
    assert runs[1]["jax_free"]


@pytest.mark.parametrize("md", MDS)
def test_slab_pass_equals_unsharded_pass(runs, md):
    """One hop and two: the gathered slab pass is the port's unsharded
    pass bit for bit, and within one packed step of `aic_tpu`'s slab pass."""
    jax_out, port, worlds = runs
    st = worlds[md][0]
    want = dense.relight_all_pass(st, dense.build_relight_ctx(st)).numpy()
    np.testing.assert_array_equal(port["pass"][md], want)
    _within_one_step(port["pass"][md], jax_out["pass"][md])


@pytest.mark.parametrize("md", MDS)
def test_evaluate_light_slab_passes(runs, md):
    jax_out, port, _ = runs
    assert 1 <= port["passes"][md] < 32
    assert abs(port["passes"][md] - jax_out["passes"][md]) <= 1


@pytest.mark.parametrize("md", MDS)
def test_trace_rays_slab_matches_one_process_trace(runs, md):
    """Fans of ±x, dx == 0 and diagonal rays, and rays that miss the
    world, graze one slab or run along a cut, under three option sets."""
    _, port, worlds = runs
    lit = worlds[md][1]
    for name, (o, d) in rays().items():
        for i, kw in enumerate(OPTIONS):
            wl, wt = trace_rays(lit, torch.as_tensor(o), torch.as_tensor(d), TOptions(**kw), beam_tile=0)
            gl, gt = port["trace"][md, name, i]
            np.testing.assert_allclose(gl, wl.numpy(), atol=SLAB_ATOL, err_msg=f"{name} {kw}")
            np.testing.assert_allclose(gt, wt.numpy(), atol=SLAB_ATOL, err_msg=f"{name} {kw}")


@pytest.mark.parametrize("md", MDS)
def test_trace_rays_slab_lights_faces_on_a_cut(runs, md):
    """The converged world's light is far from the sky's, so a face on a
    cut lit by the sky instead of the light across it (`aic_tpu`'s slab
    trace) is off by more than the tolerance: flat and smooth lighting
    of the slab trace match the one-process trace of the gathered light."""
    _, port, worlds = runs
    light, *traces = port["relit"][md]
    relit = dataclasses.replace(worlds[md][0], light=torch.as_tensor(light))
    o, d = rays()["fans"]
    for kw, (gl, gt) in zip(OPTIONS[1:], traces):
        wl, wt = trace_rays(relit, torch.as_tensor(o), torch.as_tensor(d), TOptions(**kw), beam_tile=0)
        np.testing.assert_allclose(gl, wl.numpy(), atol=SLAB_ATOL, err_msg=str(kw))
        np.testing.assert_allclose(gt, wt.numpy(), atol=SLAB_ATOL, err_msg=str(kw))


def test_trace_rays_slab_matches_aic_tpu(runs):
    """Against `aic_tpu`'s one-process `trace_rays`: the port's slab trace
    lights a face on a cut with the light across it, where `aic_tpu`'s
    slab trace reads the sky (`parallel/slab.py`)."""
    jax_out, port, _ = runs
    gl = np.concatenate([port["trace"][5, name, 2][0] for name in rays()])
    gt = np.concatenate([port["trace"][5, name, 2][1] for name in rays()])
    np.testing.assert_allclose(gl, jax_out["trace"][0], atol=SLAB_ATOL)
    np.testing.assert_allclose(gt, jax_out["trace"][1], atol=SLAB_ATOL)


def test_shard_space_requires_divisible_x(runs):
    assert "divisible" in runs[1]["narrow"]


@pytest.mark.parametrize("md", (3, 5, 9, 30, 60))
def test_no_chart_ray_enters_past_pad(md):
    """The slab pass's first condition: no pair that enters a cube (one
    that does not end its ray) lies further than pad = min(md + 1, X)
    planes from the origin, so the extended slab holds every cube a ray
    from the rank's own planes walks through, and its faces at an
    interior cut are never reached. (The second, that K2's sum for a cube
    does not depend on its block mates, needs the card:
    tests/test_torch_cuda.py::test_relight_sum_independent_of_block_mates.)"""
    for x in (8, 32, 640):
        size = (x, 16, 16)
        ch = _pair_tables(md, size)
        entered = ~ch["is_end"]
        assert np.abs(ch["off"][entered, 0]).max() <= min(md + 1, x)
