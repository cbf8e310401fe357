"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests need a CUDA device and skip without one. They import no JAX
(the machine with the card has none), so they run there as

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances are those of chip_smoke.py: the relight kernel's packed light
within one step of the twin's with statuses equal (the two sum a cube's
rays in another order); the megakernel's integer fields equal and float
fields within 1e-5 relative (both round every multiply and add
separately).
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
from aic_tpu_torch.raytrace import trace_kernel  # noqa: E402
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


def test_small_atrium_frame_matches_cpu(cuda_device):
    """One lit state, rendered through the kernels on the card and through
    the twins on the CPU."""
    space = atrium(width=24, depth=16, floors=2)
    lit, passes = dense.evaluate_light_dense(space.snapshot(device=cuda_device))
    assert passes >= 1 and relight_kernel.LAUNCHES > 0
    cam = default_camera(space, 96, 64, GraphicsOptions(lighting_display="smoothstep", fog="none"))
    before = trace_kernel.LAUNCHES
    gl, gt, unfinished = render_hdr(lit, cam)
    assert trace_kernel.LAUNCHES > before and not unfinished
    cl, ct, _ = render_hdr(lit.to("cpu"), cam)
    np.testing.assert_allclose(gl.cpu().numpy(), cl.numpy(), atol=2e-3)
    np.testing.assert_allclose(gt.cpu().numpy(), ct.numpy(), atol=2e-3)
    frame = render(lit, cam)
    assert frame.flaws == () and (frame.data[..., 3] > 0).mean() > 0.5
