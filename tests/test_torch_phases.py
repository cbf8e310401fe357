"""The megakernel's phase loop over listed rays (`trace_kernel._phases_v2`)
against the all-ray loop (`trace_kernel.phases_all_rays`, one launch over
every ray per phase on per-field state, as `aic_tpu` runs it), on the CPU
through K1's plain twin.

The listed loop packs the rays and the state once, walks only the rays
that walk in each phase (those that meet the volume, then the resuming
ones) and scatters them back; its results must equal the all-ray loop's
bit for bit: every phase's hit buffers, the light, the transmittance and
`unfinished`. A stand-in shader that halves every hit ray's transmittance
makes hits resume phase after phase. Also here: a walk over a list leaves
the columns off it as they were, and `chip_smoke.k1_bound` counts the
bytes its docstring names.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aic_tpu_torch.raytrace import trace_kernel
from test_pallas_trace import OPTS_PLAIN
from test_torch_state import to_port, fresh_pallas_caches  # noqa: F401 (autouse)
from test_torch_trace import FIELD_CASES, torch_options

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (k1_bound)


def frame_both_ways(tst, o, d, opts, monkeypatch, halve=False):
    """One megakernel frame through the listed loop and through the
    all-ray loop: (light, transmittance, unfinished, each phase's hit
    buffers) of each, and the length of each phase's list in the listed
    loop. `halve` shades with a stand-in that halves every hit ray's
    transmittance."""
    results = []
    real_shader, real_loop, real_walk = trace_kernel.make_phase_shader, trace_kernel._phases_v2, trace_kernel.walk_phase
    listed = []

    def recording_walk(rays, buf, ctx, idx):
        listed.append(idx.numel())
        return real_walk(rays, buf, ctx, idx)

    monkeypatch.setattr(trace_kernel, "walk_phase", recording_walk)
    for loop in (real_loop, trace_kernel.phases_all_rays):
        hits = []

        def recording_shader(*args, hits=hits):
            shade = real_shader(*args)

            def f(hb, la, ta):
                hits.append({k: v.clone() for k, v in hb.items()})
                if halve:
                    hit = hb["hit_kind"] != 0
                    return la + hb["hit_t"][:, None] * hit[:, None], torch.where(hit, ta * 0.5, ta)
                return shade(hb, la, ta)
            return f

        monkeypatch.setattr(trace_kernel, "make_phase_shader", recording_shader)
        monkeypatch.setattr(trace_kernel, "_phases_v2", loop)
        before = trace_kernel.LAUNCHES
        light, trans, unfinished = trace_kernel.trace_rays_kernel(
            tst, torch.as_tensor(o), torch.as_tensor(d), opts, megakernel=True
        )
        assert trace_kernel.LAUNCHES == before  # CPU tensors: plain version
        results.append((light, trans, unfinished, hits))
    return results, listed


def assert_bit_equal(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] == want[2]
    assert len(got[3]) == len(want[3]) >= 1
    for a, b in zip(got[3], want[3]):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", sorted(FIELD_CASES))
def test_listed_loop_matches_all_ray_loop(name, monkeypatch):
    """Hits resumed by the halving shader: the second phase walks the
    resuming rays only, and every phase equals the all-ray loop's."""
    build, rays = FIELD_CASES[name]
    tst = to_port(build())
    o, d = rays()
    (got, want), listed = frame_both_ways(tst, o.reshape(-1, 3), d.reshape(-1, 3), torch_options(OPTS_PLAIN),
                                          monkeypatch, halve=True)
    assert_bit_equal(got, want)
    assert len(listed) > 1 and 0 < listed[1] < listed[0]  # hit rays resumed, and only they walked


def _launch_state(name, n=2048, seed=3):
    """Packed rays and launch state of `n` seeded rays from inside one of
    FIELD_CASES' scenes."""
    build, _ = FIELD_CASES[name]
    tst = to_port(build())
    ctx = trace_kernel.build_bitmask_ctx2(tst)
    rng = np.random.RandomState(seed)
    o = rng.uniform(0.5, 19.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r, s, _ = trace_kernel.initial_state(tst, torch.as_tensor(o), torch.as_tensor(d), ctx)
    return ctx, trace_kernel.PackedRays.pack(r), trace_kernel.pack_fields(s, trace_kernel.STATE_FIELDS,
                                                                          trace_kernel.FLOAT_FIELDS)


@pytest.mark.parametrize("name", ["voxels", "r32"])
def test_walk_over_a_list_leaves_other_columns(name):
    """The twin over a list, scattered back in place: the listed columns
    are the twin's on those rays, every other column is its input."""
    ctx, rays, buf = _launch_state(name)
    before = buf.clone()
    idx = torch.arange(0, buf.shape[1], 3)
    trace_kernel.walk_phase(rays, buf, ctx, idx)
    off = torch.ones(buf.shape[1], dtype=torch.bool)
    off[idx] = False
    assert torch.equal(buf[:, off], before[:, off])
    want = trace_kernel.megakernel_plain(
        rays.take(idx).fields(),
        trace_kernel.unpack_fields(before[:, idx], trace_kernel.STATE_FIELDS, trace_kernel.FLOAT_FIELDS),
        ctx,
    )
    assert torch.equal(buf[:, idx], trace_kernel.pack_fields(want, trace_kernel.STATE_FIELDS,
                                                             trace_kernel.FLOAT_FIELDS))
    assert bool((want["hit"] != 0).any()) and bool((buf[trace_kernel.MODE_ROW, idx] == 0).all())


def test_k1_bound_counts_the_bytes_it_names():
    """A hand-made `work` on hand-made tables: 10 walking rays of 84 B
    (step and inverse direction 24, walk state in and out 56, mode 4), 4
    hit records of 32 B, 3 rays reading origin and direction (24 B), 2 in
    a grid (48 B), tables 2 rows × 512 B + the 512 B L1 row + 64 B of
    page_idx + 1024 B of pages. With no operation counted, bytes bound."""

    class Ctx:
        rows = torch.zeros((2, 128), dtype=torch.int32)
        l1 = torch.zeros((1, 128), dtype=torch.int32)
        page_idx = torch.zeros((2, 8), dtype=torch.int32)
        pages = torch.zeros((2, 128), dtype=torch.int32)

    work = {"walking": 10, "hit_rays": 4, "macro_rays": 3, "grid_rays": 2}
    moved = 10 * 84 + 4 * 32 + 3 * 24 + 2 * 48 + 1024 + 512 + 64 + 1024
    ms, by = chip_smoke.k1_bound(Ctx, work)
    assert by == "bytes" and ms == moved / chip_smoke.HBM_BYTES_PER_S * 1e3
    # Operations bound once the branch counts outweigh the bytes.
    steps = 10**9
    ms, by = chip_smoke.k1_bound(Ctx, dict(work, steps=steps))
    ops = chip_smoke.OPS["trace_megakernel"]["steps"] * steps
    assert by == "operations" and ms == pytest.approx(ops / chip_smoke.F32_OPS_PER_S * 1e3)
