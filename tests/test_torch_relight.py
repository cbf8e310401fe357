"""The port's relight (aic_tpu_torch.light) against `aic_tpu`'s XLA pass.

On the CPU the port's pass is the plain PyTorch twin of the CUDA kernel
(`relight_kernel.relight_pass_plain`). It works in f32 where the XLA pass
rounds face rows to bf16 (aic_tpu dense.py:135), so a pass may differ by
one packed light step in a few cubes: the tolerance of
tests/test_pallas_relight.py:60, with statuses equal.

Convergence on the CPU is plain Jacobi in both packages, stopped when no
cube moves by more than one packed step. That stop is a threshold on
packed values: even in f32 the two packages sum a cube's rays in
another order, and each pass a handful of cubes (4-12 of 5832 on
cornell-box 16) land one step apart, which can move the stop by one pass
(cornell-box 16: 12 XLA passes against 11 here). The check below
therefore holds the port against the XLA loop on f32 face rows
(`_f32_ctx`, the same algorithm in the same precision) to within one
pass and one packed step; tests/test_torch_slice.py holds the slice's
atrium to the same pass count. The over-relaxed loop that a CUDA state
runs is held against `converge_pallas` to the same tolerance.

`converge` runs the full pass once over ring-only light and the
light-only (`dyn`) pass per iteration, as `converge_pallas` does; the
split is checked against the full pass to f32 summation tolerance.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aic_tpu.light import dense as jdense
from aic_tpu.light import pallas_relight
from aic_tpu.light.refproc import fast_evaluate_seed as jseed
from aic_tpu_torch.light import dense as tdense
from aic_tpu_torch.light import relight_kernel
from aic_tpu_torch.light.refproc import fast_evaluate_seed as tseed
from aic_tpu_torch.math import faces, lightpack
from test_pallas_relight import _scene
from test_torch_state import PKGS, to_port

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the critical path of the kernel designs)

SCENES = {
    "mixed12": lambda: _scene((12, 12, 12), md=8),
    "non_pow2": lambda: _scene((6, 30, 38), md=6),
    "md_exceeds_volume": lambda: _scene((10, 10, 10), md=40),
    "cornell16": lambda: PKGS["jax"].cornell_box(16).snapshot(),
    "atrium_small": lambda: PKGS["jax"].atrium(width=24, depth=16, floors=2).snapshot(),
}


def _packed_diff(a, b):
    a, b = np.asarray(a).astype(np.int32), np.asarray(b).astype(np.int32)
    return int(np.abs(a[..., :3] - b[..., :3]).max()), bool(np.array_equal(a[..., 3], b[..., 3]))


@functools.lru_cache(maxsize=None)
def _seeded(name):
    """(seeded aic_tpu state, its XLA relight ctx, the port's state)."""
    st, _ = jseed(SCENES[name]())
    return st, jdense.build_relight_ctx(st), to_port(st)


@pytest.fixture(scope="module", params=sorted(SCENES))
def seeded(request):
    return (request.param,) + _seeded(request.param)


def _f32_ctx(ctx):
    """The XLA relight ctx with its face rows kept in f32."""
    return dataclasses.replace(ctx, face_vol=ctx.face_vol.astype(np.float32))


class TestPass:
    def test_pass_matches_xla(self, seeded):
        _name, st, ctx, tst = seeded
        want = jdense.relight_all_pass(st, ctx)
        before = relight_kernel.LAUNCHES
        got = tdense.relight_all_pass(tst, tdense.build_relight_ctx(tst))
        assert relight_kernel.LAUNCHES == before  # CPU tensors: plain version
        step, status_equal = _packed_diff(got, want)
        assert step <= 1, f"max packed diff {step}"
        assert status_equal

    def test_ctx_matches_xla(self, seeded):
        _name, st, ctx, tst = seeded
        tctx = tdense.build_relight_ctx(tst)
        np.testing.assert_array_equal(tctx.dir_weights.numpy(), np.asarray(ctx.dir_weights))
        np.testing.assert_array_equal(tctx.alpha0.numpy(), np.asarray(ctx.alpha0))
        np.testing.assert_array_equal(tctx.origin_opaque.numpy(), np.asarray(ctx.origin_opaque))
        np.testing.assert_allclose(
            tctx.incoming0.numpy(), np.asarray(ctx.incoming0), rtol=1e-6, atol=1e-6
        )


@pytest.mark.parametrize("name", ["cornell16", "md_exceeds_volume", "mixed12", "non_pow2"])
def test_converge_matches_xla(name):
    """Plain Jacobi to the diff ≤ 1 stop against `_converge_xla` on f32
    face rows: within one pass, field within one packed step."""
    st, ctx, tst = _seeded(name)
    want, want_passes = jdense._converge_xla(st, _f32_ctx(ctx))
    got, passes = tdense.converge(tst, tdense.build_relight_ctx(tst))
    assert abs(passes - int(want_passes)) <= 1
    step, status_equal = _packed_diff(got, want)
    assert step <= 1 and status_equal


def test_seed_matches():
    st = PKGS["jax"].atrium(width=24, depth=16, floors=2).snapshot()
    want, want_prio = jseed(st)
    got, prio = tseed(to_port(st))
    np.testing.assert_array_equal(got.light.numpy(), np.asarray(want.light))
    np.testing.assert_array_equal(prio, want_prio)


def test_pair_tables_layouts_agree():
    """The plain version's per-(ray, step) tables hold the chart's pairs
    ray by ray, and the kernel's packed words with per-ray ranges hold the
    same pairs, each dealt ray those of the chart ray `ray_id` names."""
    tst = to_port(_scene((10, 10, 10), md=8))
    p = tdense.build_relight_ctx(tst).pairs
    ch = tdense._pair_tables(8, (10, 10, 10))
    starts = p.ray_start.numpy()
    assert starts[-1] == len(ch["face"]) and (np.diff(starts) >= 1).all()
    off, face, is_end = _decode_words(p.words.numpy())
    for r in (0, 17, len(starts) - 2):
        rc = int(p.ray_id[r])
        chart = np.flatnonzero(ch["ray_id"] == rc)
        lo, hi, n = starts[r], starts[r + 1], len(chart)
        assert hi - lo == n
        np.testing.assert_array_equal(p.cosines[rc].numpy(), ch["cosines"][rc])
        for got in (off[lo:hi], p.step_off[rc, :n].numpy()):
            np.testing.assert_array_equal(got, ch["off"][chart])
        for got in (face[lo:hi], p.step_face[rc, :n].numpy()):
            np.testing.assert_array_equal(got, ch["face"][chart])
        for got in (is_end[lo:hi], p.step_end[rc, :n].numpy()):
            np.testing.assert_array_equal(got, ch["is_end"][chart])
        assert ch["is_end"][chart[-1]] and ch["ray_new"][chart[0]]


def test_evaluate_light_dense_matches():
    """The entry point: seed + convergence, dirty marks cleared."""
    st = _scene((8, 8, 8), md=6)
    want, want_passes = jdense.evaluate_light_dense(st)
    got, passes = tdense.evaluate_light_dense(to_port(st))
    assert passes == want_passes
    step, status_equal = _packed_diff(got.light, want.light)
    assert step <= 1 and status_equal
    assert not bool((got.light_dirty > 0).any())


@pytest.mark.parametrize("name", ["atrium_small", "cornell16", "mixed12"])
def test_light_only_split_matches_full_pass(name):
    """The full pass over ring-only light (interior zero, sky on the
    ring) plus the light-only pass over a light field equals the full
    pass over that field: total weights bit for bit (they read no light),
    incoming light to f32 summation order; the light-only pass leaves the
    total at 0. The field is random, from a numpy seed."""
    _st, _ctx, tst = _seeded(name)
    ctx = tdense.build_relight_ctx(tst)
    rows = tst.tables.light_face_rows
    rng = np.random.default_rng(3)
    light_rgb = torch.as_tensor(rng.uniform(0.0, 2.0, tuple(tst.contents.shape) + (3,)).astype(np.float32))
    zero = torch.zeros_like(light_rgb)
    full_inc, full_tot = relight_kernel.relight_pass(tst.contents, light_rgb, rows, ctx)
    static_inc, static_tot = relight_kernel.relight_pass(tst.contents, zero, rows, ctx)
    dyn_inc, dyn_tot = relight_kernel.relight_pass(tst.contents, light_rgb, rows, ctx, dyn=True)
    assert torch.equal(static_tot, full_tot)
    assert not bool(dyn_tot.any())
    assert bool(dyn_inc.any()) and bool(static_inc.any())
    scale = float(full_inc.abs().max())
    torch.testing.assert_close(static_inc + dyn_inc, full_inc, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("dyn", [False, True])
def test_plain_pass_in_slabs_matches_one_slab(monkeypatch, dyn):
    """The plain pass walks the cubes in slabs of at most `PLAIN_PAIRS`
    (cube, ray) pairs, so that it holds plaza640's 115 M pairs on the
    card. The pass is independent per cube: slabs that cut the volume
    anywhere give the one-slab result bit for bit, and the same work
    counts."""
    _st, _ctx, tst = _seeded("mixed12")
    ctx = tdense.build_relight_ctx(tst)
    args = (tst.contents, lightpack.decode_rgb(tst.light).contiguous(), tst.tables.light_face_rows, ctx)
    work_one, work_slabs = {}, {}
    want = relight_kernel.relight_pass_plain(*args, dyn=dyn, work=work_one)
    n_rays = ctx.pairs.cosines.shape[0]
    monkeypatch.setattr(relight_kernel, "PLAIN_PAIRS", 97 * n_rays + 5)  # 97 cubes a slab
    got = relight_kernel.relight_pass_plain(*args, dyn=dyn, work=work_slabs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert work_slabs == work_one
    assert work_one["steps"] > work_one["rays"] > 0 and work_one["struck"] > 0


def test_overrelaxed_converge_matches_pallas(monkeypatch):
    """The loop a CUDA state converges with (w = OVERRELAX) against
    `converge_pallas`, its Pallas kernel run in interpret mode: within one
    pass, field within one packed step, statuses equal. The first pass
    moves some cube by more than 4 steps, so it is extrapolated: held
    alone, it must be within 2 steps of `converge_pallas`'s and further
    than that from the plain pass."""
    monkeypatch.setattr(
        pallas_relight, "_kernel_pass_planes",
        functools.partial(pallas_relight._kernel_pass_planes, interpret=True),
    )
    w = tdense.OVERRELAX
    st, _ = jseed(_scene((8, 8, 8), md=4))
    jctx = jdense.build_relight_ctx(st)
    tst = to_port(st)
    ctx = tdense.build_relight_ctx(tst)

    plain = tdense.relight_all_pass(tst, ctx)
    assert int(lightpack.difference_priority(tst.light, plain).max()) > 4
    want1, _ = pallas_relight.converge_pallas(st, jctx, max_passes=1, overrelax=w)
    got1, _ = tdense.converge(tst, ctx, max_passes=1, overrelax=w)
    # A one-step difference of the plain passes comes out of the
    # extrapolation scaled by w: up to 2 steps.
    step, status_equal = _packed_diff(got1, want1)
    assert step <= 2 and status_equal
    assert _packed_diff(got1, plain)[0] > 2

    want, want_passes = pallas_relight.converge_pallas(st, jctx, overrelax=w)
    got, passes = tdense.converge(tst, ctx, overrelax=w)
    assert abs(passes - int(want_passes)) <= 1
    step, status_equal = _packed_diff(got, want)
    assert step <= 1 and status_equal


def test_overrelax_keeps_plain_output_near_convergence():
    """converge_pallas's safeguard: with the plain pass moving no cube by
    more than 4 steps, the extrapolated field is the plain one."""
    tst, _ = tseed(to_port(_scene((8, 8, 8), md=6)))
    ctx = tdense.build_relight_ctx(tst)
    new = tdense.relight_all_pass(tst, ctx)
    assert torch.equal(tdense._overrelax(tst.light, new, 4, 1.3), new)
    far = tdense._overrelax(tst.light, new, 5, 1.3)
    assert torch.equal(far[..., 3], new[..., 3])


# -- the CUDA kernel's tables, held against what they replace ----------------
#
# The kernel walks a work list of cubes, reads a one-byte visibility mask
# where the one-thread-per-cube kernel read contents and a face row and
# tested the volume's bounds, and reads one packed word per pair where it
# read three tables.


def _decode_words(words):
    """(off i64[N,3], face i64[N], is_end bool[N]) of `pack_pair_words`,
    whose last two words are pads of 0."""
    assert not words[-2:].any()
    w = np.asarray(words[:-2]).astype(np.int64)
    off = np.stack([(((w >> s) & 0xFF) ^ 0x80) - 0x80 for s in (0, 8, 16)], -1)
    return off, (w >> 24) & 7, ((w >> 27) & 1).astype(bool)


@pytest.mark.parametrize("name", ["atrium_small", "md_exceeds_volume", "mixed12", "non_pow2"])
def test_work_list_is_walked_cubes_with_weight(name):
    """The listed cubes are the cubes `_run_pairs` walks (alpha0 > 0, not
    an opaque origin) that have any direction weight, in index order."""
    _st, jctx, tst = _seeded(name)
    want = np.flatnonzero(
        (np.asarray(jctx.alpha0) > 0) & ~np.asarray(jctx.origin_opaque)
        & (np.asarray(jctx.dir_weights) > 0).any(-1)
    )
    kt = tdense.build_relight_ctx(tst).kernel
    np.testing.assert_array_equal(kt.cubes.numpy(), want)


@pytest.mark.parametrize("name", ["atrium_small", "mixed12", "non_pow2"])
def test_face_mask_is_face_visibility(name):
    """Inside the one-cube padding, bit f of the mask is face_rows[6 *
    contents + f, 4] >= 2 of `aic_tpu`'s tables; the padding carries only
    MASK_OUTSIDE."""
    st, _jctx, tst = _seeded(name)
    rows = np.asarray(st.tables.light_face_rows)
    contents = np.asarray(st.contents).astype(np.int64)
    X, Y, Z = contents.shape
    mask = tdense.build_relight_ctx(tst).kernel.face_mask.numpy()
    assert mask.shape == (X + 2, Y + 2, Z + 2)
    inner = mask[1:-1, 1:-1, 1:-1]
    for f in range(6):
        np.testing.assert_array_equal((inner >> f) & 1, rows[6 * contents + f, 4] >= 2.0)
    assert not (inner & relight_kernel.MASK_OUTSIDE).any()
    pad = np.ones(mask.shape, bool)
    pad[1:-1, 1:-1, 1:-1] = False
    assert (mask[pad] == relight_kernel.MASK_OUTSIDE).all()


@pytest.mark.parametrize("md,size", [(6, (8, 8, 8)), (8, (12, 12, 12)), (40, (10, 10, 10)), (60, (60, 35, 40))])
def test_pair_words_decode_to_pair_tables(md, size):
    """The packed words decode to `aic_tpu`'s pair offsets, faces and end
    flags exactly, ray by ray in the order the kernel's warps walk them
    (`ray_id`); the deal gives every ray to one warp, in chart order
    within a warp, the warps' chart lengths within one longest ray."""
    ch = jdense._pair_tables(md, size)
    dealt = tdense._dealt_pair_tables(md, size)
    ray_id, starts = dealt["ray_id"], dealt["warp_start"]
    chart = np.concatenate([np.flatnonzero(ch["ray_id"] == r) for r in ray_id])
    off, face, is_end = _decode_words(dealt["words"])
    np.testing.assert_array_equal(off, ch["off"][chart])
    np.testing.assert_array_equal(face, ch["face"][chart])
    np.testing.assert_array_equal(is_end, ch["is_end"][chart])
    n_rays = len(ch["cosines"])
    np.testing.assert_array_equal(np.sort(ray_id), np.arange(n_rays))
    assert starts[0] == 0 and starts[-1] == n_rays and len(starts) == relight_kernel.WARPS + 1
    lengths = np.diff(dealt["ray_start"])
    np.testing.assert_array_equal(lengths, np.bincount(ch["ray_id"], minlength=n_rays)[ray_id])
    loads = [lengths[a:b].sum() for a, b in zip(starts[:-1], starts[1:])]
    assert max(loads) - min(loads) <= lengths.max()
    for a, b in zip(starts[:-1], starts[1:]):
        assert (np.diff(ray_id[a:b]) > 0).all()


@pytest.mark.parametrize("md,size", [(6, (8, 8, 8)), (8, (12, 12, 12)), (40, (10, 10, 10)), (60, (60, 35, 40))])
def test_chart_rays_step_one_cube_through_their_face(md, size):
    """What the kernel's walk rests on, held on `aic_tpu`'s pair tables:
    every pair that does not end its ray lies one cube from the previous
    pair of its ray (or the origin), entered through its face, so a ray
    leaving the volume lands on the mask's one-cube padding; every ray
    ends at its last pair and at no pair before; offsets fit in i8."""
    ch = jdense._pair_tables(md, size)
    normals = np.asarray(faces.FACE_NORMALS[:6], np.int64)
    assert np.abs(ch["off"]).max() <= 127
    for r in range(len(ch["cosines"])):
        pairs = np.flatnonzero(ch["ray_id"] == r)
        assert (np.diff(pairs) == 1).all() and ch["ray_new"][pairs[0]]
        end = ch["is_end"][pairs]
        assert end[-1] and not end[:-1].any()
        off = ch["off"][pairs].astype(np.int64)
        prev = np.concatenate([np.zeros((1, 3), np.int64), off[:-1]])
        np.testing.assert_array_equal((off - prev)[:-1], -normals[ch["face"][pairs]][:-1])


def _bad_tables(case):
    ch = dict(jdense._pair_tables(6, (8, 8, 8)))
    ch["off"], ch["face"], ch["is_end"] = ch["off"].copy(), ch["face"].copy(), ch["is_end"].copy()
    if case == "wrong_face":
        ch["face"][0] = (ch["face"][0] + 1) % 6
    elif case == "offset_past_i8":
        ch["off"][0, 0] = 128
    else:  # "ray_without_end"
        ch["is_end"][np.flatnonzero(ch["ray_id"] == 3)[-1]] = False
    return ch


@pytest.mark.parametrize("case", ["wrong_face", "offset_past_i8", "ray_without_end"])
def test_kernel_tables_refuse_a_chart_they_cannot_walk(case):
    """Building the kernel's tables checks the chart properties the walk
    needs and raises where one fails."""
    with pytest.raises(ValueError):
        relight_kernel.deal_pair_tables(_bad_tables(case))


@pytest.mark.parametrize("dyn", [False, True])
def test_plain_pass_does_not_follow_the_deal(monkeypatch, dyn):
    """The plain pass reads the chart-order tables only: dealing the rays
    over another number of warps leaves its result bit for bit."""
    _st, _jctx, tst = _seeded("mixed12")
    ctx = tdense.build_relight_ctx(tst)
    md, size = tst.light_max_distance, tuple(tst.contents.shape)
    ch = tdense._pair_tables(md, size)
    monkeypatch.setattr(relight_kernel, "WARPS", 3)
    other = dataclasses.replace(ctx, pairs=relight_kernel.PairTables.from_numpy(
        ch, relight_kernel.deal_pair_tables(ch), ctx.pairs.sky_faces))
    assert not torch.equal(other.pairs.ray_id, ctx.pairs.ray_id)
    args = (tst.contents, lightpack.decode_rgb(tst.light).contiguous(), tst.tables.light_face_rows)
    a = relight_kernel.relight_pass_plain(*args, ctx, dyn=dyn)
    b = relight_kernel.relight_pass_plain(*args, other, dyn=dyn)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_all_opaque_state_lists_no_cube():
    """A state whose every cube is opaque walks no cube: an empty work
    list; the pass gives zeros."""
    jx = PKGS["jax"]
    sp = jx.Space(jx.GridAab.from_lower_size((0, 0, 0), (6, 5, 7)))
    sp.fill(jx.GridAab.from_lower_size((0, 0, 0), (6, 5, 7)), jx.block.from_color((0.5, 0.5, 0.5, 1.0)))
    tst = to_port(sp.snapshot())
    ctx = tdense.build_relight_ctx(tst)
    assert ctx.kernel.cubes.numel() == 0
    inc, tot = relight_kernel.relight_pass(tst.contents, lightpack.decode_rgb(tst.light), tst.tables.light_face_rows, ctx)
    assert not bool(inc.any()) and not bool(tot.any())


def test_critical_path_counts():
    """The plain pass reports each live (cube, ray)'s pair steps, which
    add up to its step count; from them, the serial chains of both kernel
    designs: the longest cube's pair steps, and the longest warp share
    (each ray as long as the longest of its block's 32 lanes), which the
    split across warps makes shorter."""
    _st, _jctx, tst = _seeded("mixed12")
    ctx = tdense.build_relight_ctx(tst)
    work: dict = {}
    lengths: list = []
    relight_kernel.relight_pass_plain(tst.contents, lightpack.decode_rgb(tst.light), tst.tables.light_face_rows,
                                      ctx, work=work, lengths=lengths)
    cube, ray, steps = (torch.cat(col) for col in zip(*lengths))
    assert len(cube) == len(ray) == work["rays"] and int(steps.sum()) == work["steps"]
    max_cube, max_warp = chip_smoke.critical_path(ctx, lengths)
    assert 0 < max_warp < max_cube <= work["steps"]
