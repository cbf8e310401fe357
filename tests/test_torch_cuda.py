"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests need a CUDA device and skip without one. They import no JAX
(the machine with the card has none), so they run there as

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances are those of chip_smoke.py: the relight kernels' packed light
within one step of the twin's with statuses equal (the two sum a cube's
rays in another order), for both variants of the volume pass and for the
listed kernel over a queue round's batch (which agrees with the volume
pass to f32 summation order, 1e-5 relative); the trace kernels'
(megakernel and v1 surface finder) integer fields equal and float fields
within 1e-5 relative (both round every multiply and add separately).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (jax-free scene builders)
from aic_tpu_torch import block  # noqa: E402
from aic_tpu_torch.content import atrium, cornell_box  # noqa: E402
from aic_tpu_torch.light import dense, relight_kernel  # noqa: E402
from aic_tpu_torch.light.refproc import fast_evaluate_seed  # noqa: E402
from aic_tpu_torch.main import default_camera  # noqa: E402
from aic_tpu_torch.math import lightpack  # noqa: E402
from aic_tpu_torch.math.grid import GridAab  # noqa: E402
from aic_tpu_torch.raytrace import GraphicsOptions, render, render_hdr  # noqa: E402
from aic_tpu_torch.raytrace import trace_kernel, trace_kernel_v1  # noqa: E402
from aic_tpu_torch.space import Sky, Space, SpacePhysics  # noqa: E402

PKG = (block, GridAab, Space, Sky, SpacePhysics)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("scene", ["mixed", "cornell16"])
def test_relight_kernel_matches_plain(cuda_device, scene):
    space = chip_smoke.relight_scene(PKG) if scene == "mixed" else cornell_box(16)
    st, _ = fast_evaluate_seed(space.snapshot(device=cuda_device))
    ctx = dense.build_relight_ctx(st)
    args = (st.contents, lightpack.decode_rgb(st.light).contiguous(),
            st.tables.light_face_rows, ctx)
    before = relight_kernel.LAUNCHES
    inc_k, tot_k = relight_kernel.relight_pass(*args)
    assert relight_kernel.LAUNCHES == before + 1
    inc_p, tot_p = relight_kernel.relight_pass_plain(*args)
    pk = dense._finish(ctx, inc_k + ctx.incoming0, tot_k).cpu().numpy().astype(np.int32)
    pp = dense._finish(ctx, inc_p + ctx.incoming0, tot_p).cpu().numpy().astype(np.int32)
    assert np.abs(pk[..., :3] - pp[..., :3]).max() <= 1
    np.testing.assert_array_equal(pk[..., 3], pp[..., 3])


def _packed(ctx, inc, tot):
    return dense._finish(ctx, inc + ctx.incoming0, tot).cpu().numpy().astype(np.int32)


@pytest.mark.parametrize("scene", ["mixed", "cornell16"])
def test_relight_light_only_variant(cuda_device, scene):
    """The light-only kernel against its twin, and full(ring only) +
    light-only(light) against the full kernel: within one packed step."""
    space = chip_smoke.relight_scene(PKG) if scene == "mixed" else cornell_box(16)
    st, _ = fast_evaluate_seed(space.snapshot(device=cuda_device))
    ctx = dense.build_relight_ctx(st)
    rows = st.tables.light_face_rows
    light = lightpack.decode_rgb(dense.relight_all_pass(st, ctx)).contiguous()
    zero = torch.zeros_like(light)
    before = relight_kernel.LAUNCHES_DYN
    inc_d, tot_d = relight_kernel.relight_pass(st.contents, light, rows, ctx, dyn=True)
    assert relight_kernel.LAUNCHES_DYN == before + 1
    inc_p, _ = relight_kernel.relight_pass_plain(st.contents, light, rows, ctx, dyn=True)
    assert not bool(tot_d.any())
    full_inc, full_tot = relight_kernel.relight_pass(st.contents, light, rows, ctx)
    st_inc, st_tot = relight_kernel.relight_pass(st.contents, zero, rows, ctx)
    assert torch.equal(st_tot, full_tot)
    a = _packed(ctx, inc_d + st_inc, st_tot)
    b = _packed(ctx, inc_p + st_inc, st_tot)
    c = _packed(ctx, full_inc, full_tot)
    for x in (a, b):
        assert np.abs(x[..., :3] - c[..., :3]).max() <= 1
        np.testing.assert_array_equal(x[..., 3], c[..., 3])


def test_overrelaxed_converge_matches_plain(cuda_device, monkeypatch):
    """`evaluate_light_dense` on the card (w = OVERRELAX) through the
    kernel and through the twin: within one pass and one packed step."""
    space = chip_smoke.relight_scene(PKG)
    got, passes = dense.evaluate_light_dense(space.snapshot(device=cuda_device))
    monkeypatch.setattr(dense, "relight_pass", relight_kernel.relight_pass_plain)
    want, want_passes = dense.evaluate_light_dense(space.snapshot(device=cuda_device))
    assert abs(passes - want_passes) <= 1
    a = got.light.cpu().numpy().astype(np.int32)
    b = want.light.cpu().numpy().astype(np.int32)
    assert np.abs(a[..., :3] - b[..., :3]).max() <= 1
    np.testing.assert_array_equal(a[..., 3], b[..., 3])


@pytest.mark.parametrize("scene", ["atoms", "voxels", "r32"])
def test_trace_kernel_matches_plain(cuda_device, scene):
    st = chip_smoke.trace_scenes(PKG)[scene].snapshot(device=cuda_device)
    o, d = chip_smoke.random_rays(2048, -4.0, 24.0, seed=1)
    ctx = trace_kernel.build_bitmask_ctx2(st)
    r, s, _ = trace_kernel.initial_state(
        st, torch.as_tensor(o, device=cuda_device), torch.as_tensor(d, device=cuda_device), ctx
    )
    before = trace_kernel.LAUNCHES
    got = trace_kernel.run_megakernel(r, s, ctx)
    assert trace_kernel.LAUNCHES == before + 1
    want = trace_kernel.megakernel_plain(r, s, ctx)
    assert bool((want["mode"] == trace_kernel.MODE_DONE).all())
    for k in trace_kernel.STATE_FIELDS:
        if k in trace_kernel.FLOAT_FIELDS:
            torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=0)
        else:
            assert torch.equal(got[k], want[k]), k


def _assert_k1_fields(got, want):
    for k in trace_kernel.STATE_FIELDS:
        if k in trace_kernel.FLOAT_FIELDS:
            torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=0)
        else:
            assert torch.equal(got[k], want[k]), k


def _k1_state(st, o, d, device):
    """K1's tables, packed rays and packed launch state for rays in world
    coordinates."""
    ctx = trace_kernel.get_bitmask_ctx2(st)
    lower = torch.as_tensor(st.lower, dtype=torch.float32, device=device)
    o = (torch.as_tensor(o, device=device).reshape(-1, 3) - lower).contiguous()
    d = torch.as_tensor(d, device=device).reshape(-1, 3).contiguous()
    r, s, _ = trace_kernel.initial_state(st, o, d, ctx)
    return ctx, trace_kernel.PackedRays.pack(r), trace_kernel.pack_fields(
        s, trace_kernel.STATE_FIELDS, trace_kernel.FLOAT_FIELDS)


def _check_listed_launch(ctx, rays, buf, idx):
    """K1 over the list `idx`, in place on a copy of `buf`: the listed
    columns equal the twin's on those rays, the others are untouched.
    Returns the launched copy."""
    out = buf.clone()
    before = trace_kernel.LAUNCHES
    trace_kernel.launch_megakernel(rays, out, ctx, idx)
    assert trace_kernel.LAUNCHES == before + 1
    off = torch.ones(buf.shape[1], dtype=torch.bool, device=buf.device)
    off[idx] = False
    assert torch.equal(out[:, off], buf[:, off])
    unpack = lambda b: trace_kernel.unpack_fields(b, trace_kernel.STATE_FIELDS, trace_kernel.FLOAT_FIELDS)  # noqa: E731
    want = trace_kernel.megakernel_plain(rays.take(idx).fields(), unpack(buf[:, idx]), ctx)
    assert bool((want["mode"] == trace_kernel.MODE_DONE).all())
    _assert_k1_fields(unpack(out[:, idx]), want)
    return out


def _k1_scene_state(scene, device):
    st = chip_smoke.trace_scenes(PKG)[scene].snapshot(device=device)
    return _k1_state(st, *chip_smoke.random_rays(2048, -4.0, 24.0, seed=1), device)


@pytest.mark.parametrize("scene", ["atoms", "voxels", "r32"])
def test_trace_kernel_listed_in_place_matches_plain(cuda_device, scene):
    """K1 over every third walking ray, in place: the listed rays agree
    with the twin, the columns off the list are untouched."""
    ctx, rays, buf = _k1_scene_state(scene, cuda_device)
    walking = torch.nonzero(buf[trace_kernel.MODE_ROW] == trace_kernel.MODE_WALK).squeeze(1)
    assert walking.numel() > 300
    _check_listed_launch(ctx, rays, buf, walking[::3].contiguous())


def test_trace_kernel_two_launches_bit_equal(cuda_device):
    """Two launches from the same state give the same bits, over a list
    and over all rays."""
    ctx, rays, buf = _k1_scene_state("r32", cuda_device)
    idx = torch.nonzero(buf[trace_kernel.MODE_ROW] == trace_kernel.MODE_WALK).squeeze(1)
    for lst in (idx, None):
        a, b = buf.clone(), buf.clone()
        trace_kernel.launch_megakernel(rays, a, ctx, lst)
        trace_kernel.launch_megakernel(rays, b, ctx, lst)
        assert torch.equal(a, b) and not torch.equal(a, buf)


def test_trace_kernel_empty_phase_launches_nothing(cuda_device):
    """An empty list launches nothing and changes no column; a frame whose
    rays all miss the volume launches nothing."""
    ctx, rays, buf = _k1_scene_state("voxels", cuda_device)
    before_buf = buf.clone()
    before = trace_kernel.LAUNCHES
    trace_kernel.launch_megakernel(rays, buf, ctx, torch.zeros(0, dtype=torch.int64, device=cuda_device))
    torch.cuda.synchronize()
    assert trace_kernel.LAUNCHES == before and torch.equal(buf, before_buf)
    state = _voxel_scene_space().snapshot(device=cuda_device)
    o = torch.full((8, 3), -5.0, device=cuda_device)
    d = torch.tensor([[-1.0, 0.0, 0.0]], device=cuda_device).expand(8, 3).contiguous()
    opts = GraphicsOptions(lighting_display="smoothstep", fog="none")
    _l, t, unfinished = trace_kernel.trace_rays_kernel(state, o, d, opts, megakernel=True)
    assert trace_kernel.LAUNCHES == before and not unfinished


def test_trace_kernel_listed_frame_matches_all_rays(cuda_device, monkeypatch):
    """The small atrium's megakernel frame through the listed phase loop
    equals the all-ray loop's bit for bit, both through the kernel."""
    space = atrium(width=24, depth=16, floors=2)
    st = space.snapshot(device=cuda_device)
    opts = GraphicsOptions(lighting_display="smoothstep", fog="none")
    o, d = default_camera(space, 96, 64, opts).pixel_rays(device=cuda_device)
    before = trace_kernel.LAUNCHES
    a = trace_kernel.trace_rays_kernel(st, o, d, opts, megakernel=True)
    assert trace_kernel.LAUNCHES > before
    monkeypatch.setattr(trace_kernel, "_phases_v2", trace_kernel.phases_all_rays)
    b = trace_kernel.trace_rays_kernel(st, o, d, opts, megakernel=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2]


def _assert_v1_fields(got, want):
    for k in trace_kernel_v1.OUT_FIELDS:
        if k in trace_kernel_v1.FLOAT_FIELDS:
            torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=0)
        else:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("scene", ["atoms", "voxels"])
def test_trace_v1_kernel_matches_plain(cuda_device, scene):
    """The v1 surface finder against its twin: the first launch, and on
    the voxel scene the second (inner walks) after the round glue."""
    st = chip_smoke.trace_scenes(PKG)[scene].snapshot(device=cuda_device)
    o, d = chip_smoke.random_rays(2048, -4.0, 24.0, seed=1)
    ctx = trace_kernel_v1.build_bitmask_ctx(st)
    r, s2, entry = trace_kernel.initial_state(
        st, torch.as_tensor(o, device=cuda_device), torch.as_tensor(d, device=cuda_device), ctx
    )
    s = trace_kernel_v1.initial_state_v1(s2)
    before = trace_kernel_v1.LAUNCHES
    got = trace_kernel_v1.run_surface_finder(r, s, ctx)
    assert trace_kernel_v1.LAUNCHES == before + 1
    want = trace_kernel_v1.surface_finder_plain(r, s, ctx)
    assert not bool(want["walking"].any())
    _assert_v1_fields(got, want)
    if scene == "voxels":
        saved, hb = trace_kernel_v1.empty_buffers(o.shape[0], cuda_device)
        s, _, _ = trace_kernel_v1.advance(st, ctx, r, entry["d_len"], s, saved, hb, want)
        assert bool((s["resl"] > 0).any())
        _assert_v1_fields(
            trace_kernel_v1.run_surface_finder(r, s, ctx),
            trace_kernel_v1.surface_finder_plain(r, s, ctx),
        )


def test_small_atrium_v1_matches_megakernel(cuda_device):
    """The small atrium traced through both kernels on the card."""
    space = atrium(width=24, depth=16, floors=2)
    st = space.snapshot(device=cuda_device)
    opts = GraphicsOptions(lighting_display="smoothstep", fog="none")
    o, d = default_camera(space, 96, 64, opts).pixel_rays()
    before = trace_kernel_v1.LAUNCHES
    l1, t1, u1 = trace_kernel.trace_rays_kernel(st, o, d, opts, megakernel=False)
    assert trace_kernel_v1.LAUNCHES > before and not u1
    l2, t2, u2 = trace_kernel.trace_rays_kernel(st, o, d, opts, megakernel=True)
    assert not u2
    np.testing.assert_allclose(l1.cpu().numpy(), l2.cpu().numpy(), atol=2e-3)


def test_small_atrium_frame_matches_cpu(cuda_device):
    """One lit state, rendered through the kernels on the card and through
    the twins on the CPU."""
    space = atrium(width=24, depth=16, floors=2)
    lit, passes = dense.evaluate_light_dense(space.snapshot(device=cuda_device))
    assert passes >= 1 and relight_kernel.LAUNCHES > 0
    cam = default_camera(space, 96, 64, GraphicsOptions(lighting_display="smoothstep", fog="none"))
    before = trace_kernel.LAUNCHES
    gl, gt, stats = render_hdr(lit, cam, with_stats=True)
    assert trace_kernel.LAUNCHES > before and not stats["unfinished"]
    cl, ct = render_hdr(lit.to("cpu"), cam)
    np.testing.assert_allclose(gl.cpu().numpy(), cl.numpy(), atol=2e-3)
    np.testing.assert_allclose(gt.cpu().numpy(), ct.numpy(), atol=2e-3)
    frame = render(lit, cam)
    assert frame.flaws == () and (frame.data[..., 3] > 0).mean() > 0.5


def _relight_args(space, device):
    st, _ = fast_evaluate_seed(space.snapshot(device=device))
    ctx = dense.build_relight_ctx(st)
    return ctx, (st.contents, lightpack.decode_rgb(st.light).contiguous(), st.tables.light_face_rows, ctx)


@pytest.mark.parametrize("dyn", [False, True])
def test_relight_two_launches_bit_equal(cuda_device, dyn):
    """The warps' partial sums are added in a fixed order: two launches on
    the same inputs give the same bits."""
    _ctx, args = _relight_args(chip_smoke.relight_scene(PKG), cuda_device)
    a = relight_kernel.relight_pass_cuda(*args, dyn=dyn)
    b = relight_kernel.relight_pass_cuda(*args, dyn=dyn)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_relight_all_opaque_gives_zeros(cuda_device):
    """No listed cube: zeros in both variants, and no launch."""
    box = GridAab.from_lower_size((0, 0, 0), (9, 7, 5))
    space = Space(box)
    space.fill(box, block.from_color((0.5, 0.5, 0.5, 1.0)))
    ctx, args = _relight_args(space, cuda_device)
    assert ctx.kernel.cubes.numel() == 0
    before = (relight_kernel.LAUNCHES, relight_kernel.LAUNCHES_DYN)
    for dyn in (False, True):
        inc, tot = relight_kernel.relight_pass(*args, dyn=dyn)
        torch.cuda.synchronize()
        assert not bool(inc.any()) and not bool(tot.any())
    assert (relight_kernel.LAUNCHES, relight_kernel.LAUNCHES_DYN) == before


@pytest.mark.parametrize("dyn", [False, True])
def test_relight_long_open_rays_match_plain(cuda_device, dyn):
    """`light_max_distance` 40 in a 10³ volume: rays run to the volume's
    edge and end on the mask's padding. Within one packed step of the twin,
    statuses equal."""
    ctx, args = _relight_args(chip_smoke.relight_scene(PKG, size=(10, 10, 10), md=40), cuda_device)
    inc_k, tot_k = relight_kernel.relight_pass(*args, dyn=dyn)
    inc_p, tot_p = relight_kernel.relight_pass_plain(*args, dyn=dyn)
    if dyn:  # the light-only pass has no total: judge it beside the twin's static terms
        static, tot_p = relight_kernel.relight_pass_plain(args[0], torch.zeros_like(args[1]), *args[2:])
        inc_k, inc_p, tot_k = inc_k + static, inc_p + static, tot_p
    pk, pp = _packed(ctx, inc_k, tot_k), _packed(ctx, inc_p, tot_p)
    assert np.abs(pk[..., :3] - pp[..., :3]).max() <= 1
    np.testing.assert_array_equal(pk[..., 3], pp[..., 3])


def _v1_rounds(space, device, n=4096, rounds=3, seed=5):
    """The first `rounds` round states of a v1 frame on the card, for `n`
    seeded rays from inside the volume: per round (packed rays, packed
    state, walking list), after the rounds before it ran through the kernel
    over their walking lists."""
    st = space.snapshot(device=device)
    size = st.contents.shape
    o, d = chip_smoke.random_rays(n, 0.5, min(size) - 0.5, seed=seed)
    ctx = trace_kernel_v1.build_bitmask_ctx(st)
    r, s2, entry = trace_kernel.initial_state(
        st, torch.as_tensor(o, device=device), torch.as_tensor(d, device=device), ctx
    )
    packed = trace_kernel.PackedRays.pack(r)
    buf = trace_kernel_v1.pack_round(trace_kernel_v1.initial_state_v1(s2),
                                     *trace_kernel_v1.empty_buffers(n, device))
    n_st = len(trace_kernel_v1.STATE_FIELDS)
    idx = torch.nonzero(buf[trace_kernel_v1.WALKING_ROW] == 1).squeeze(1)
    out = []
    for _ in range(rounds):
        out.append((packed, buf[:n_st].clone(), idx.clone()))
        if idx.numel() == 0:
            break
        idx = trace_kernel_v1.walk_round(st, ctx, packed, entry["d_len"], buf, idx)
    return ctx, out


def _voxel_scene_space():
    return chip_smoke.trace_scenes(PKG)["voxels"]


@pytest.mark.parametrize("scene", ["voxels", "atrium_small"])
def test_trace_v1_walking_list_matches_plain(cuda_device, scene):
    """Rounds 2 and 3 of a frame (inner walks into voxel blocks, and the
    walks on after leaving them): the kernel over the walking list agrees
    with the twin on the listed rays."""
    space = atrium(width=24, depth=16, floors=2) if scene == "atrium_small" else _voxel_scene_space()
    ctx, rounds = _v1_rounds(space, cuda_device)
    assert len(rounds) == 3 and rounds[2][2].numel() > 0
    for packed, st, idx in rounds[1:]:
        before = trace_kernel_v1.LAUNCHES
        got = trace_kernel.unpack_fields(trace_kernel_v1.find_surfaces(packed, st, idx, ctx),
                                         trace_kernel_v1.OUT_FIELDS, trace_kernel_v1.FLOAT_FIELDS)
        assert trace_kernel_v1.LAUNCHES == before + 1
        want = trace_kernel_v1.surface_finder_plain(
            packed.take(idx).fields(),
            trace_kernel.unpack_fields(st[:, idx], trace_kernel_v1.STATE_FIELDS, trace_kernel_v1.FLOAT_FIELDS),
            ctx,
        )
        _assert_v1_fields(got, want)


def test_trace_v1_two_launches_bit_equal(cuda_device):
    """Two launches on the same inputs give the same bits, over a walking
    list and over all rays."""
    ctx, rounds = _v1_rounds(_voxel_scene_space(), cuda_device)
    for packed, st, idx in rounds[:2]:
        for lst in (idx, None):
            a = trace_kernel_v1.launch(packed, st, ctx, lst)
            b = trace_kernel_v1.launch(packed, st, ctx, lst)
            assert torch.equal(a, b)


def test_trace_v1_zero_walking_round_launches_nothing(cuda_device):
    """An empty walking list launches nothing and changes no buffer; a
    frame whose rays all miss the volume launches nothing."""
    ctx, rounds = _v1_rounds(_voxel_scene_space(), cuda_device, n=256, rounds=1)
    packed, st, _idx = rounds[0]
    m = st.shape[1]
    buf = torch.ones((trace_kernel_v1.ROUND_ROWS, m), dtype=torch.int32, device=cuda_device)
    buf[: st.shape[0]] = st
    before_buf = buf.clone()
    empty = torch.zeros(0, dtype=torch.int64, device=cuda_device)
    before = trace_kernel_v1.LAUNCHES
    state = _voxel_scene_space().snapshot(device=cuda_device)
    d_len = torch.ones(m, device=cuda_device)
    assert trace_kernel_v1.walk_round(state, ctx, packed, d_len, buf, empty).numel() == 0
    torch.cuda.synchronize()
    assert trace_kernel_v1.LAUNCHES == before
    assert torch.equal(buf, before_buf)
    o = torch.full((8, 3), -5.0, device=cuda_device)
    d = torch.tensor([[-1.0, 0.0, 0.0]], device=cuda_device).expand(8, 3).contiguous()
    opts = GraphicsOptions(lighting_display="smoothstep", fog="none")
    _l, _t, unfinished = trace_kernel.trace_rays_kernel(state, o, d, opts, megakernel=False)
    assert trace_kernel_v1.LAUNCHES == before and not unfinished


def test_trace_v1_walking_list_frame_matches_all_rays(cuda_device, monkeypatch):
    """The small atrium's v1 frame through walking lists equals the all-ray
    loop's bit for bit, both through the kernel."""
    space = atrium(width=24, depth=16, floors=2)
    st = space.snapshot(device=cuda_device)
    opts = GraphicsOptions(lighting_display="smoothstep", fog="none")
    o, d = default_camera(space, 96, 64, opts).pixel_rays(device=cuda_device)
    a = trace_kernel.trace_rays_kernel(st, o, d, opts, megakernel=False)
    monkeypatch.setattr(trace_kernel_v1, "trace_phases_v1", trace_kernel_v1.trace_phases_all_rays)
    b = trace_kernel.trace_rays_kernel(st, o, d, opts, megakernel=False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2]


# -- the step loop: K2 over a queue round's batch, the device tick ----------------


@pytest.mark.parametrize("scene", ["mixed", "cornell16"])
def test_relight_batch_listed_matches_plain(cuda_device, scene):
    """`relight_batch` on the card is one launch of K2's listed kernel;
    its packed light is within one step of the plain walk's on the valid
    rows, statuses equal, padding rows 0, for a first round's batch,
    random batches of 16 and 1024 rows and a one-row batch; a batch of
    padding only launches nothing."""
    from aic_tpu_torch.light import update
    from aic_tpu_torch.light.update import evaluate_light

    space = chip_smoke.relight_scene(PKG) if scene == "mixed" else cornell_box(16)
    st, _ = evaluate_light(space.snapshot(device=cuda_device))
    cases = chip_smoke.batch_cases(st)
    assert {"random 1024", "one row", "all padding"} <= set(cases)
    for label, (s2, cubes, valid) in cases.items():
        before = relight_kernel.LAUNCHES_LISTED
        got = update.relight_batch(s2, cubes, valid)
        assert relight_kernel.LAUNCHES_LISTED == before + int(bool(valid.any())), label
        want = update.relight_batch_plain(s2, cubes, valid)
        a, b = got.cpu().numpy().astype(np.int32), want.cpu().numpy().astype(np.int32)
        v = valid.cpu().numpy()
        assert np.abs(a[v, :3] - b[v, :3]).max(initial=0) <= 1, label
        np.testing.assert_array_equal(a[v, 3], b[v, 3], err_msg=label)
        assert not a[~v].any(), label


def test_relight_batch_two_launches_bit_equal(cuda_device):
    """The listed kernel sums each row in a fixed order: two launches on
    the same inputs give the same bits, its raw sums and the packed
    light."""
    from aic_tpu_torch.light import update

    st, _ = fast_evaluate_seed(cornell_box(16).snapshot(device=cuda_device))
    cubes = torch.as_tensor(np.stack(np.unravel_index(np.arange(0, 4096, 37), (16, 16, 16)), -1), device=cuda_device)
    valid = torch.ones(cubes.shape[0], dtype=torch.bool, device=cuda_device)
    assert torch.equal(update.relight_batch(st, cubes, valid), update.relight_batch(st, cubes, valid))
    args, _org = update.listed_inputs(st, cubes, valid)
    a = relight_kernel.relight_listed_cuda(*args)
    b = relight_kernel.relight_listed_cuda(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_listed_kernel_matches_volume_pass(cuda_device):
    """The listed kernel and the volume pass walk the same step over the
    same inputs: per walked row their sums agree to f32 summation order;
    rows that walk nothing give 0."""
    from aic_tpu_torch.light import update

    st, _ = fast_evaluate_seed(chip_smoke.relight_scene(PKG).snapshot(device=cuda_device))
    ctx = dense.build_relight_ctx(st)
    X, Y, Z = st.contents.shape
    flat = np.random.default_rng(5).choice(X * Y * Z, size=300, replace=False)
    cubes = torch.as_tensor(np.stack(np.unravel_index(flat, (X, Y, Z)), -1), device=cuda_device)
    valid = torch.ones(300, dtype=torch.bool, device=cuda_device)
    args, _org = update.listed_inputs(st, cubes, valid)
    inc_v, tot_v = relight_kernel.relight_pass_cuda(st.contents, lightpack.decode_rgb(st.light).contiguous(),
                                                    st.tables.light_face_rows, ctx)
    walked = args[6].any(-1)
    assert 0 < int(walked.sum()) < 300
    idx = torch.as_tensor(flat, device=cuda_device)
    inc, tot = relight_kernel.relight_listed_cuda(*args)
    torch.testing.assert_close(inc, inc_v.reshape(-1, 3)[idx], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(tot, tot_v.reshape(-1)[idx], rtol=1e-5, atol=1e-6)
    assert not inc[~walked].any() and not tot[~walked].any()


def test_relight_batch_all_padding_launches_nothing(cuda_device):
    from aic_tpu_torch.light import update

    st, _ = fast_evaluate_seed(cornell_box(16).snapshot(device=cuda_device))
    cubes = torch.as_tensor([[3, 1, 3], [8, 8, 8]], device=cuda_device)
    before = relight_kernel.LAUNCHES_LISTED
    out = update.relight_batch(st, cubes, torch.zeros(2, dtype=torch.bool, device=cuda_device))
    torch.cuda.synchronize()
    assert relight_kernel.LAUNCHES_LISTED == before and out.shape == (2, 4) and not out.any()


def test_decode_table_gives_decode_rgb_bits(cuda_device):
    """The listed kernel's light table, computed on the card, looked up
    per channel gives the bits of `lightpack.decode_rgb` on the card."""
    rng = np.random.default_rng(4)
    light = torch.as_tensor(rng.integers(0, 256, size=(9, 7, 5, 4), dtype=np.uint8), device=cuda_device)
    table = relight_kernel.decode_table(light.device)
    got = table[light[..., :3].long()]
    assert torch.equal(got.view(torch.int32), lightpack.decode_rgb(light).view(torch.int32))


def test_relight_batch_after_an_edit_equals_fresh_tables(cuda_device):
    """A batch relit after an edit, with the pre-edit state's mask and pair
    tables cached, equals the same batch relit with every cache emptied."""
    from aic_tpu_torch.light import dense, update
    from aic_tpu_torch.space.state import scatter_set_cubes

    st, _ = fast_evaluate_seed(cornell_box(16).snapshot(device=cuda_device))
    cubes = torch.as_tensor(np.stack(np.unravel_index(np.arange(0, 4096, 37), (16, 16, 16)), -1), device=cuda_device)
    valid = torch.ones(cubes.shape[0], dtype=torch.bool, device=cuda_device)
    update.relight_batch(st, cubes, valid)
    edited = scatter_set_cubes(st, torch.as_tensor([[8, 8, 8], [3, 1, 3]], device=cuda_device),
                               torch.as_tensor([0, int(st.contents[0, 0, 0])], dtype=torch.int32, device=cuda_device))
    got = update.relight_batch(edited, cubes, valid)
    update._FACE_MASKS.clear()
    dense._DEVICE_PAIRS.clear()
    assert torch.equal(got, update.relight_batch(edited, cubes, valid))


def test_universe_steps_on_the_card_like_the_cpu(cuda_device):
    """The same small world stepped 12 ticks on the card (device tick, K2
    over each round's batch) and on the CPU (the plain walk): contents
    and cells equal, packed light within one step, bodies within 1e-4."""
    from aic_tpu_torch.content import TemplateParameters, build_universe

    us = {}
    for dev in (cuda_device, torch.device("cpu")):
        u = build_universe("cornell-box", TemplateParameters(size=12), device=dev)
        chip_smoke.cycle_world(u.spaces["world"])
        u.resnapshot("world")
        u.add_behavior("world", chip_smoke.make_placer(chip_smoke.free_cubes(u.spaces["world"], 2), 3))
        for _ in range(12):
            u.step()
        us[dev.type] = u
    a, b = us["cuda"].states["world"], us["cpu"].states["world"]
    assert torch.equal(a.contents.cpu(), b.contents) and torch.equal(a.cells.cpu(), b.cells)
    la, lb = a.light.cpu().numpy().astype(np.int32), b.light.numpy().astype(np.int32)
    assert np.abs(la[..., :3] - lb[..., :3]).max() <= 1
    np.testing.assert_array_equal(la[..., 3], lb[..., 3])
    np.testing.assert_allclose(us["cuda"].bodies.position.cpu().numpy(), us["cpu"].bodies.position.numpy(), atol=1e-4)


def test_trace_kernel_matches_plain_on_demo_city(cuda_device):
    """K1 on full demo-city's state (R32 octant rows, wide classify pages)
    against its twin: a 320x180 sample of `main.default_camera`'s view and
    4096 rays from inside the city, every field; with every ray listed,
    and in place over the list of the walking rays."""
    from aic_tpu_torch.content import TemplateParameters, build_template_space

    sp = build_template_space("demo-city", TemplateParameters(seed=0, size=96))
    st = sp.snapshot(device=cuda_device)
    ctx = trace_kernel.get_bitmask_ctx2(st)
    assert ctx.has_r32 and ctx.wide_pages
    o, d = default_camera(sp, 320, 180, GraphicsOptions()).pixel_rays(device=cuda_device)
    ro, rd = chip_smoke.random_rays(4096, -40.0, 40.0, seed=3)
    lower = torch.as_tensor(st.lower, dtype=torch.float32, device=cuda_device)
    o = torch.cat([o.reshape(-1, 3), torch.as_tensor(ro, device=cuda_device)]) - lower
    d = torch.cat([d.reshape(-1, 3), torch.as_tensor(rd, device=cuda_device)])
    r, s, _ = trace_kernel.initial_state(st, o.contiguous(), d.contiguous(), ctx)
    before = trace_kernel.LAUNCHES
    got = trace_kernel.run_megakernel(r, s, ctx)
    assert trace_kernel.LAUNCHES == before + 1
    want = trace_kernel.megakernel_plain(r, s, ctx)
    assert bool((want["mode"] == trace_kernel.MODE_DONE).all())
    assert bool((want["hit"] == 2).any())  # some rays end inside voxel blocks
    for k in trace_kernel.STATE_FIELDS:
        if k in trace_kernel.FLOAT_FIELDS:
            torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=0)
        else:
            assert torch.equal(got[k], want[k]), k
    packed = trace_kernel.PackedRays.pack(r)
    buf = trace_kernel.pack_fields(s, trace_kernel.STATE_FIELDS, trace_kernel.FLOAT_FIELDS)
    walking = torch.nonzero(buf[trace_kernel.MODE_ROW] == trace_kernel.MODE_WALK).squeeze(1)
    assert 0 < walking.numel() < buf.shape[1]
    _check_listed_launch(ctx, packed, buf, walking)


def test_demo_city_steps_on_the_card_like_the_cpu(cuda_device):
    """Demo-city at size 48 from `build_universe` stepped 12 ticks on the
    card and on the CPU: contents and cells equal, packed light within one
    step, statuses equal, bodies within 1e-4."""
    from aic_tpu_torch.content import TemplateParameters, build_universe

    us = {}
    for dev in (cuda_device, torch.device("cpu")):
        u = build_universe("demo-city", TemplateParameters(seed=0, size=48), device=dev)
        for _ in range(12):
            u.step()
        us[dev.type] = u
    a, b = us["cuda"].states["world"], us["cpu"].states["world"]
    assert torch.equal(a.contents.cpu(), b.contents) and torch.equal(a.cells.cpu(), b.cells)
    la, lb = a.light.cpu().numpy().astype(np.int32), b.light.numpy().astype(np.int32)
    assert np.abs(la[..., :3] - lb[..., :3]).max() <= 1
    np.testing.assert_array_equal(la[..., 3], lb[..., 3])
    np.testing.assert_allclose(us["cuda"].bodies.position.cpu().numpy(), us["cpu"].bodies.position.numpy(), atol=1e-4)


# -- the general tracer and windowing (PyTorch, no kernel of their own) --------


def _r64_scene():
    inner = Space(GridAab.cube(64))
    inner.fill(GridAab.from_lower_size((0, 0, 0), (64, 8, 64)), block.from_color((0.9, 0.7, 0.2, 1.0)))
    for i in range(64):
        inner.set((i, i, 63 - i), block.from_color((0.2, 0.4, 0.9, 1.0)))
    inner.fill(GridAab.from_lower_size((8, 40, 8), (48, 1, 48)), block.from_color((0.9, 0.1, 0.1, 0.5)))
    sp = Space(GridAab.cube(12), physics=SpacePhysics(sky=Sky.uniform((0.3, 0.32, 0.4))))
    sp.set((5, 4, 5), block.Block(block.Recur(space=inner, resolution=64)))
    sp.fill(GridAab.from_lower_size((0, 0, 0), (12, 1, 12)), block.from_color((0.4, 0.6, 0.3, 1.0)))
    return sp


@pytest.mark.parametrize("scene", ["atrium_small", "r64"])
def test_general_tracer_on_the_card_like_the_cpu(cuda_device, scene):
    """`tracer.trace_rays` on the card against the same call on the CPU:
    hits, step counts and stats equal, hit t within 1e-5 relative, light
    within 2e-3; `render` dispatches the R64 state to it on both."""
    from aic_tpu_torch.raytrace import Camera, Viewport, trace_rays
    from aic_tpu_torch.raytrace.render import pick_tracer

    opts = GraphicsOptions(lighting_display="smoothstep", fog="none", transparency="volumetric")
    if scene == "atrium_small":
        sp = atrium(width=24, depth=16, floors=2)
        cam = default_camera(sp, 128, 96, opts)
    else:
        sp = _r64_scene()
        cam = Camera(opts, Viewport(128, 96))
        cam.look_at((14.0, 9.0, 16.0), (5.5, 4.5, 5.5))
    st, _ = fast_evaluate_seed(sp.snapshot(device=cuda_device))
    o, d = cam.pixel_rays(device=cuda_device)
    kw = dict(return_stats=True, return_hits=True, count_steps=True)
    gl, gt, gs, gh, gsteps = trace_rays(st, o, d, cam.options, **kw)
    cl, ct, cs, ch, csteps = trace_rays(st.to("cpu"), o.cpu(), d.cpu(), cam.options, **kw)
    assert (ch["hit_kind"] != 0).float().mean() > 0.1
    for k in ("iters", "walkers"):
        assert gs[k].tolist() == cs[k].tolist(), k
    assert bool(gs["unfinished"]) == bool(cs["unfinished"]) is False
    for p, (g, c) in enumerate(zip(gh["phases"], ch["phases"])):
        for k in ("hit_kind", "hit_idx", "hit_vflat", "hit_face", "hit_cube"):
            assert torch.equal(g[k].cpu(), c[k]), (p, k)
        np.testing.assert_allclose(g["hit_t"].cpu().numpy(), c["hit_t"].numpy(), rtol=1e-5, atol=0)
    assert torch.equal(gsteps.cpu(), csteps)
    np.testing.assert_allclose(gl.cpu().numpy(), cl.numpy(), atol=2e-3)
    np.testing.assert_allclose(gt.cpu().numpy(), ct.numpy(), atol=2e-3)
    want = "general" if scene == "r64" else "megakernel"  # R64: past both kernels
    assert pick_tracer(st) == pick_tracer(st.to("cpu")) == want


def test_window_state_on_the_card_like_the_cpu(cuda_device):
    """`window_state` rebuilds the window's cells on the card (the skip
    field's max pools) bit for bit as on the CPU."""
    from aic_tpu_torch.content import plaza
    from aic_tpu_torch.space.state import visible_light_volume, window_state

    st = plaza(160).snapshot(device=cuda_device)
    lo, hi = visible_light_volume(st, (80.0, 6.0, 100.0), 20.0)
    win = window_state(st, lo, hi)
    ref = window_state(st.to("cpu"), lo, hi)
    assert win.contents.shape[0] < st.contents.shape[0] and win.lower == ref.lower
    for k in ("contents", "light", "light_dirty", "cells"):
        assert torch.equal(getattr(win, k).cpu(), getattr(ref, k)), k


def _session(device, w=256, h=144):
    """A session on cornell-box 16 with its HUD at w x h on `device`."""
    from aic_tpu_torch.apps.session import Session
    from aic_tpu_torch.content import TemplateParameters, build_universe
    from aic_tpu_torch.raytrace import Viewport

    u = build_universe("cornell-box", TemplateParameters(size=16), device=device)
    s = Session(u, viewport=Viewport(w, h), options=GraphicsOptions(lighting_display="smoothstep", fog="none"))
    s.enable_ui()
    s.maybe_step(0.0)
    return s


def test_session_frame_k1_launches_match_plain(cuda_device):
    """Every K1 launch of a session frame, the world layer's and the UI
    layer's, against the twin on its listed rays (chip_smoke's check:
    28 fields, columns off the list untouched); the frame equals the
    CPU session's within ±1 on ≥ 99.9% of pixels."""
    s = _session(cuda_device)
    records = chip_smoke.k1_frame_launches(lambda: s.render_with_ui())
    assert len(records) >= 2  # both layers
    rows = chip_smoke.check_k1_launches(records, "session test")  # exits non-zero on a disagreement
    assert len(rows) == len(records)
    got = s.render_with_ui().data
    want = _session(torch.device("cpu")).render_with_ui().data
    close = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(-1) <= 1
    assert close.mean() >= 0.999


def test_encode_png_decodes_to_the_session_frame(cuda_device):
    from aic_tpu_torch.raytrace import decode_png, encode_png

    frame = _session(cuda_device).render_with_ui().data
    np.testing.assert_array_equal(decode_png(encode_png(frame)), frame)
