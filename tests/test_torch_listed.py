"""What K2's listed kernel reads, built on the CPU and held against
`aic_tpu`: its lane deal over `aic_tpu`'s pair tables, its light decode
table, and the inputs `relight_batch` hands it.

The kernel itself (`csrc/relight.cu` `relight_listed_kernel`) runs only
on the card: tests/test_torch_cuda.py holds it against the plain walk
`relight_batch_plain`, which tests/test_torch_update.py holds against
`aic_tpu`. Everything here is exact, but for the numpy twin of the
decode table (one ulp).
"""

import numpy as np
import pytest
import torch

from aic_tpu.light import dense as jdense
from aic_tpu.light.refproc import fast_evaluate_seed as jseed
from aic_tpu_torch.light import dense as tdense
from aic_tpu_torch.light import relight_kernel
from aic_tpu_torch.light import update as tupdate
from aic_tpu_torch.math import lightpack
from test_pallas_relight import _scene
from test_torch_relight import _decode_words
from test_torch_state import to_port

CHARTS = [(6, (8, 8, 8)), (8, (12, 12, 12)), (30, (96, 28, 96)), (60, (60, 35, 40))]


@pytest.mark.parametrize("md,size", CHARTS)
def test_lane_deal_covers_every_chart_ray_once(md, size):
    """Every chart ray of `aic_tpu`'s pair tables has exactly one lane;
    within a warp of 32 lanes the rays go longest first, so the lanes end
    together, and only the last warp has empty lanes (-1), at its end;
    from each lane's first word the packed words decode to its chart
    ray's pairs, end flag last."""
    ch = jdense._pair_tables(md, size)
    dealt = tdense._dealt_pair_tables(md, size)
    lane_ray, lane_start = dealt["lane_ray"], dealt["lane_start"]
    n_rays = len(ch["cosines"])
    lanes = relight_kernel.LANES
    assert len(lane_ray) == -(-n_rays // lanes) * lanes and len(lane_start) == len(lane_ray)
    used = lane_ray[lane_ray >= 0]
    np.testing.assert_array_equal(np.sort(used), np.arange(n_rays))
    assert (lane_ray[: len(used)] >= 0).all()
    lengths = np.bincount(ch["ray_id"], minlength=n_rays)
    for warp in lane_ray.reshape(-1, lanes):
        live = warp[warp >= 0]
        assert (np.diff(lengths[live]) <= 0).all()
    assert (np.diff(lengths[used]) <= 0).all()
    off, face, is_end = _decode_words(dealt["words"])
    for slot in np.flatnonzero(lane_ray >= 0):
        chart = np.flatnonzero(ch["ray_id"] == lane_ray[slot])
        lo = lane_start[slot]
        hi = lo + len(chart)
        np.testing.assert_array_equal(off[lo:hi], ch["off"][chart])
        np.testing.assert_array_equal(face[lo:hi], ch["face"][chart])
        np.testing.assert_array_equal(is_end[lo:hi], ch["is_end"][chart])
        assert is_end[hi - 1] and not is_end[lo : hi - 1].any()


def test_device_pair_tables_carry_the_lane_deal():
    """The device tables hold the host deal as it is."""
    st = to_port(jseed(_scene((12, 12, 12), md=8))[0])
    pairs = tdense.device_pair_tables(st)
    dealt = tdense._dealt_pair_tables(st.light_max_distance, tuple(st.contents.shape))
    np.testing.assert_array_equal(pairs.lane_ray.numpy(), dealt["lane_ray"])
    np.testing.assert_array_equal(pairs.lane_start.numpy(), dealt["lane_start"])
    assert pairs.lane_ray.dtype == pairs.lane_start.dtype == torch.int32


def test_decode_table_matches_decode_scalar():
    """The kernel's table is `lightpack.decode_scalar` bit for bit on all
    256 codes, and within one f32 ulp of the numpy twin's table (PyTorch's
    and numpy's exp2 may round apart). That a lookup gives the bits of
    `decode_rgb` on a whole volume is held on the card
    (tests/test_torch_cuda.py): on the CPU PyTorch's exp2 may round a
    tensor's vectorized body and its scalar tail apart by one ulp."""
    table = relight_kernel.decode_table(torch.device("cpu"))
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    assert table.dtype == torch.float32 and table.shape == (256,) and table.is_contiguous()
    assert torch.equal(table.view(torch.int32), lightpack.decode_scalar(codes).view(torch.int32))
    ulps = np.abs(table.numpy().view(np.int32).astype(np.int64) - lightpack.DECODE_TABLE.view(np.int32))
    assert ulps.max() <= 1 and table[0] == 0


def test_listed_inputs_pass_the_packed_light():
    """`relight_batch` on the card hands the kernel the state's packed
    light as it is (no decoded volume), and the row tables per batch
    row: padding and opaque rows with zero ray weights."""
    st = to_port(jseed(_scene((12, 12, 12), md=8))[0])
    cubes = torch.as_tensor([[5, 5, 5], [0, 0, 0], [1, 2, 3]])
    valid = torch.as_tensor([True, True, False])
    args, org = tupdate.listed_inputs(st, cubes, valid)
    light = args[1]
    assert light.dtype == torch.uint8 and light.shape == st.light.shape
    assert light.data_ptr() == st.light.data_ptr()
    flat, dw, alpha0 = args[5:]
    np.testing.assert_array_equal(flat.numpy(), [(5 * 12 + 5) * 12 + 5, 0, (1 * 12 + 2) * 12 + 3])
    walked = valid & (org.alpha0 > 0) & ~org.origin_opaque
    assert torch.equal(dw.any(-1), walked & org.dir_weights.any(-1))
    assert dw.shape == (3, 6) and alpha0.shape == (3,)


def test_all_padding_batch_launches_nothing():
    """A batch whose every row is padding gives zeros on the card path
    before any launch (the kernel would refuse these CPU tensors); one
    valid row reaches the kernel."""
    st = to_port(jseed(_scene((12, 12, 12), md=8))[0])
    cubes = torch.as_tensor([[5, 5, 5], [1, 2, 3]])
    before = relight_kernel.LAUNCHES_LISTED
    out = tupdate.relight_batch_cuda(st, cubes, torch.zeros(2, dtype=torch.bool))
    assert out.dtype == torch.uint8 and out.shape == (2, 4) and not out.any()
    assert relight_kernel.LAUNCHES_LISTED == before
    with pytest.raises(ValueError, match="CUDA"):
        tupdate.relight_batch_cuda(st, cubes, torch.as_tensor([True, False]))
    assert relight_kernel.LAUNCHES_LISTED == before
