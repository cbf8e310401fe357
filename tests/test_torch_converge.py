"""The over-relaxed relight loop (aic_tpu_torch.light.dense.converge), a
repair of the port (ROADMAP §C).

At w = 1.3 the loop diverges on cornell-box 16: the plain pass's largest
change falls to 9 packed steps, then grows to 127, and the loop stopped
at 32 passes without a word. It now runs plain Jacobi from the first
pass whose change grows, says so with `OverrelaxFellBack`, and warns
`LightNotConverged` when it stops at its pass limit.

Plain Jacobi stops when no cube moves by more than one step; that stop
lies up to 4 steps from plain Jacobi's fixpoint on cornell-box 16 (the
last steps of one creep for 19 more passes before nothing moves). So the
repaired loop's light is held within one step of `aic_tpu`'s fixpoint:
its dense relight pass (`relight_all_pass`, bf16 face rows, 33 passes
from the seed) run on the same seeded state until no cube's packed light
changes.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

from aic_tpu.light import dense as jdense
from aic_tpu.light.refproc import fast_evaluate_seed as jseed
from aic_tpu.math import lightpack as jlightpack
from aic_tpu_torch.light import dense as tdense
from aic_tpu_torch.light.refproc import fast_evaluate_seed as tseed
from test_torch_state import PKGS, to_port


def _seeded(size):
    st, _ = tseed(PKGS["torch"].cornell_box(size).snapshot(device="cpu"))
    return st, tdense.build_relight_ctx(st)


def _aic_tpu_fixpoint(st, max_passes=60):
    """`aic_tpu`'s dense relight passes from a seeded state until no
    cube's packed light changes."""
    ctx = jdense.build_relight_ctx(st)
    light = st.light
    for _ in range(max_passes):
        new = jdense.relight_all_pass(dataclasses.replace(st, light=light), ctx)
        if not bool(jnp.any(jlightpack.difference_priority(light, new) > 0)):
            return np.asarray(new)
        light = new
    raise AssertionError("aic_tpu's relight did not reach its fixpoint")


def test_overrelaxed_loop_converges_on_cornell16():
    """w = 1.3 on cornell-box 16 falls back to plain Jacobi, says so, and
    converges without a `LightNotConverged` warning to within one packed
    step of `aic_tpu`'s fixpoint from the same seeded state, statuses
    equal."""
    st, _ = jseed(PKGS["jax"].cornell_box(16).snapshot())
    tst = to_port(st)
    with warnings.catch_warnings():
        warnings.simplefilter("error", tdense.LightNotConverged)
        with pytest.warns(tdense.OverrelaxFellBack):
            got, passes = tdense.converge(tst, tdense.build_relight_ctx(tst), overrelax=1.3)
    assert passes < 32
    want = _aic_tpu_fixpoint(st)
    a, b = got.numpy().astype(np.int32), want.astype(np.int32)
    assert int(np.abs(a[..., :3] - b[..., :3]).max()) <= 1
    np.testing.assert_array_equal(a[..., 3], b[..., 3])


def test_loop_capped_short_reports_it():
    """A loop stopped at its pass limit with cubes still moving warns
    `LightNotConverged` (a warning, so it reaches `evaluate_light_dense`'s
    caller as well)."""
    st, ctx = _seeded(8)
    with pytest.warns(tdense.LightNotConverged):
        _light, passes = tdense.converge(st, ctx, max_passes=2)
    assert passes == 2
