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

import numpy as np
import pytest
import torch

from aic_tpu.light import dense as jdense
from aic_tpu.light import pallas_relight
from aic_tpu.light.refproc import fast_evaluate_seed as jseed
from aic_tpu_torch.light import dense as tdense
from aic_tpu_torch.light import relight_kernel
from aic_tpu_torch.light.refproc import fast_evaluate_seed as tseed
from aic_tpu_torch.math import lightpack
from test_pallas_relight import _scene
from test_torch_state import PKGS, to_port

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
    """The kernel's flat pair list with per-ray ranges and the plain
    version's per-(ray, step) tables hold the same pairs."""
    tst = to_port(_scene((10, 10, 10), md=8))
    p = tdense.build_relight_ctx(tst).pairs
    ch = tdense._pair_tables(8, (10, 10, 10))
    starts = p.ray_start.numpy()
    assert starts[-1] == len(ch["face"]) and (np.diff(starts) >= 1).all()
    for r in (0, 17, len(starts) - 2):
        lo, hi = starts[r], starts[r + 1]
        n = hi - lo
        np.testing.assert_array_equal(p.step_off[r, :n].numpy(), ch["off"][lo:hi])
        np.testing.assert_array_equal(p.step_face[r, :n].numpy(), ch["face"][lo:hi])
        np.testing.assert_array_equal(p.step_end[r, :n].numpy(), ch["is_end"][lo:hi])
        assert ch["is_end"][hi - 1] and ch["ray_new"][lo]


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
