"""The port's multi-rank paths (`aic_tpu_torch.parallel`, the ray-split
relight pass, `graft_entry`) on 4 CPU ranks over gloo, against the port's
one-process functions and `aic_tpu`'s on a 4-device mesh.

The scene is tests/test_parallel.py's: cornell-box 12, 32×32 smooth
lighting, and the same box at 32×40 (rows padded to whole beam tiles on
every rank). One world of ranks (`parallel.spawn`) runs the rank-side
cases; `aic_tpu`'s side is computed once per module.

Tolerances: a row-sharded frame is the port's `trace_rays` bit for bit
(every ray is traced alone, and each rank's rows hold whole beam tiles),
and `aic_tpu`'s within `LIGHT_ATOL` (tests/test_torch_tracer.py); the
ray-split relight pass within one packed step of the unsharded pass and
of `aic_tpu`'s ray-split pass, statuses equal (the all-reduce sums the
ranks' rays in another order).
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from aic_tpu.light.dense import build_relight_ctx as jbuild_ctx
from aic_tpu.light.dense import relight_all_pass_sharded as jpass_sharded
from aic_tpu.parallel import make_mesh as jmake_mesh
from aic_tpu.parallel import render_sharded as jrender_sharded
from aic_tpu_torch import graft_entry
from aic_tpu_torch.light import dense
from aic_tpu_torch.parallel import make_mesh, spawn
from aic_tpu_torch.raytrace.tracer import trace_rays
from test_parallel import _demo_scene
from test_torch_state import fresh_pallas_caches, to_port  # noqa: F401 (autouse)
from test_torch_tracer import LIGHT_ATOL
from test_torch_trace import torch_options
from torch_rank_workers import RANKS_TIMEOUT, fail_on_rank_1, parallel_worker

RANKS = 4


def port_camera(options, height):
    """The port's camera at `_demo_scene`'s pose, `height` rows of 32
    pixels."""
    from aic_tpu_torch.raytrace import Camera, Viewport

    cam = Camera(options, Viewport(32, height))
    cam.look_at(np.array([0.5, 0.5, 1.6]) * 12, (6.0, 6.0, 6.0))
    return cam


@pytest.fixture(scope="module")
def runs():
    jstate, jcam, jopts = _demo_scene()
    mesh = jmake_mesh(RANKS)
    jframe = tuple(np.asarray(a) for a in jrender_sharded(jstate, jcam, mesh))
    jlight = np.asarray(jax.jit(lambda st, ctx: jpass_sharded(st, ctx, mesh))(jstate, jbuild_ctx(jstate)))
    state = to_port(jstate)
    opts = torch_options(jopts)
    cams = [port_camera(opts, h) for h in (32, 40)]
    (port, *rest) = spawn(parallel_worker, RANKS, "cpu", "gloo", args=(state, cams, state), timeout=RANKS_TIMEOUT)
    assert rest == [None] * (RANKS - 1)
    return {"jframe": jframe, "jlight": jlight, "state": state, "cams": cams}, port


def test_make_mesh_rejects_overcommit(runs):
    with pytest.raises(RuntimeError, match="mesh"):
        make_mesh(1000, device="cpu")
    assert "8-rank mesh" in runs[1]["overcommit"]


def test_ranks_import_no_jax(runs):
    assert runs[1]["jax_free"]


@pytest.mark.parametrize("halo", [2, 5], ids=["one hop", "two hops"])
def test_halo_exchange(runs, halo):
    """Rank r's slab of 3 planes, extended: the world's planes
    [3r − halo, 3r + 3 + halo), zeros past its ends."""
    world = (np.arange(6, dtype=np.float32).reshape(3, 2)[None] + 100 * np.arange(1, RANKS + 1)[:, None, None])
    padded = np.concatenate([np.zeros((halo, 2), np.float32), world.reshape(-1, 2), np.zeros((halo, 2), np.float32)])
    got = runs[1]["halos"][halo]
    for r in range(RANKS):
        np.testing.assert_array_equal(got[r], padded[3 * r: 3 * r + 3 + 2 * halo])


@pytest.mark.parametrize("i", [0, 1], ids=["32x32", "32x40 padded"])
def test_render_sharded_equals_trace_rays(runs, i):
    ref, port = runs
    cam = ref["cams"][i]
    o, d = cam.pixel_rays(device="cpu")
    want = trace_rays(ref["state"], o, d, cam.options)
    for got, w in zip(port["frames"][i], want):
        np.testing.assert_array_equal(got, w.numpy())
    if i == 0:
        for got, w in zip(port["frames"][0], ref["jframe"]):
            np.testing.assert_allclose(got, w, atol=LIGHT_ATOL)


def _within_one_step(got, want):
    got, want = np.asarray(got).astype(np.int32), np.asarray(want).astype(np.int32)
    assert np.abs(got[..., :3] - want[..., :3]).max() <= 1
    np.testing.assert_array_equal(got[..., 3], want[..., 3])


def test_relight_all_pass_sharded(runs):
    ref, port = runs
    st = ref["state"]
    _within_one_step(port["relight"], dense.relight_all_pass(st, dense.build_relight_ctx(st)).numpy())
    _within_one_step(port["relight"], ref["jlight"])
    assert port["ranks_agree"] and port["launches"] == 0  # the plain pass on the CPU


def test_entry_frame_matches_aic_tpu():
    fn, args = graft_entry.entry(device="cpu")
    jfn, jargs = jentry.entry()
    np.testing.assert_allclose(fn(*args).numpy(), np.asarray(jfn(*jargs)), atol=LIGHT_ATOL)


def test_dryrun_multichip_completes():
    counts = graft_entry.dryrun_multichip(RANKS, device="cpu", transport="gloo")
    assert len(counts) == RANKS and all(sum(c.values()) == 0 for c in counts)  # no kernel on the CPU


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        spawn(fail_on_rank_1, 2, "cpu", "gloo", timeout=RANKS_TIMEOUT)


def test_one_process_mesh_collectives():
    """Outside a group the mesh is of one, and its collectives are the
    identity; the halo past both ends is zeros."""
    from aic_tpu_torch.parallel import comm

    mesh = make_mesh(device="cpu")
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert (mesh.rank, mesh.world, mesh.transport) == (0, 1, None)
    assert torch.equal(comm.all_reduce(t, mesh), t)
    assert torch.equal(comm.all_gather(t, mesh), t[None])
    ext = comm.halo_exchange(t, 5, mesh)  # two hops of a 3-plane slab
    assert ext.shape == (13, 4) and torch.equal(ext[5:8], t)
    assert not ext[:5].any() and not ext[8:].any()
