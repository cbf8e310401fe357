"""Checks of two repairs of the port (ROADMAP §C; the third, the
over-relaxed relight loop, is tests/test_torch_converge.py): `render`
under the pixel-cost debug option returns `aic_tpu`'s pixel-cost image
(it once refused the option, having no general tracer to count steps
with), and the v1 round loop's state is held against `aic_tpu`'s round
by round, not only through images.

The round-by-round check records every round of `aic_tpu`'s
`_trace_pallas_impl` (its kernel in interpret mode, the function run
without jit, its round loop run as a Python loop) at the port's
per-launch budget (`kernel_iters=v1.ITERS`: the port gives a launch
48 × 48 iterations where `aic_tpu`'s default is 48, so that a launch
finishes what a group's waits would cut short) and every round of the
port's `trace_phases_v1` (the kernel's plain twin on the CPU) on the
same rays: each round's walking rays, the kernel's 15 output fields for
them, and after the glue the 9 state fields, the saved outer registers
and the hit buffers of every ray. Integer fields are equal, float fields
within 1e-5 relative (tests/test_torch_trace_v1.py's tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aic_tpu.raytrace import pallas_trace
from aic_tpu_torch.raytrace import Camera, GraphicsOptions, Viewport, render
from aic_tpu_torch.raytrace import trace_kernel
from aic_tpu_torch.raytrace import trace_kernel_v1 as v1
from test_pallas_trace import OPTS_PLAIN
from test_torch_state import PKGS, fresh_pallas_caches, to_port  # noqa: F401 (autouse)
from test_torch_trace import torch_options
from test_torch_trace_v1 import FIELD_CASES

# -- C1: the pixel-cost debug render --------------------------------------------


def test_render_refuses_debug_pixel_cost():
    """`render` with `debug_pixel_cost` returns the pixel-cost heatmap of
    the general tracer's step counts, equal to `aic_tpu`'s
    `render_pixel_cost` (the name is the test's from before the general
    tracer was ported, when the port refused the option)."""
    from aic_tpu.raytrace import Camera as JCamera
    from aic_tpu.raytrace import GraphicsOptions as JOptions
    from aic_tpu.raytrace import Viewport as JViewport
    from aic_tpu.raytrace.render import render_pixel_cost

    eye, target = np.array([4.0, 4.0, 14.0]), np.array([4.0, 4.0, 4.0])
    jcam = JCamera(JOptions(debug_pixel_cost=True), JViewport(16, 8))
    jcam.look_at(eye, target)
    cam = Camera(GraphicsOptions(debug_pixel_cost=True), Viewport(16, 8))
    cam.look_at(eye, target)
    want = render_pixel_cost(PKGS["jax"].cornell_box(8).snapshot(), jcam)
    got = render(PKGS["torch"].cornell_box(8).snapshot(device="cpu"), cam)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.flaws == want.flaws == ()
    assert got.data[..., 0].max() == 255 and (got.data[..., 3] == 255).all()


# -- C3: the v1 round loop against aic_tpu's, round by round -------------------------


def _aic_rounds(st, o, d, monkeypatch):
    """Every round of `aic_tpu`'s v1 loop: (walking before, kernel out,
    state, saved registers, hit buffers after), numpy."""
    rounds, outs = [], []
    real_while = jax.lax.while_loop
    real_kernel = pallas_trace._run_kernel

    def kernel(*a, **kw):
        out = real_kernel(*a, **kw)
        outs.append({k: np.asarray(v) for k, v in out.items()})
        return out

    def while_loop(cond, body, init):
        if not (isinstance(init, tuple) and len(init) == 4 and isinstance(init[0], dict) and "walking" in init[0]):
            return real_while(cond, body, init)
        carry = init
        while bool(cond(carry)):
            before = np.asarray(carry[0]["walking"]) == 1
            carry = body(carry)
            np_ = lambda dct: {k: np.asarray(v) for k, v in dct.items()}  # noqa: E731
            rounds.append((before, outs[-1], np_(carry[0]), np_(carry[1]), np_(carry[2])))
        return carry

    monkeypatch.setattr(pallas_trace, "_run_kernel", kernel)
    monkeypatch.setattr(jax.lax, "while_loop", while_loop)
    ctx = pallas_trace.build_bitmask_ctx(st)
    lower = np.asarray(st.lower, np.float32)
    pallas_trace._trace_pallas_impl.__wrapped__(
        st, jnp.asarray(o - lower), jnp.asarray(d), ctx.l1, ctx.rows, rdims=ctx.rdims,
        n_regions=ctx.n_regions, options=OPTS_PLAIN, include_sky=True, phases=v1.PHASES,
        kernel_iters=v1.ITERS, substeps=v1.SUBSTEPS, max_rounds=v1.ROUNDS, interpret=True,
    )
    monkeypatch.undo()
    return rounds


def _port_rounds(tst, o, d, monkeypatch):
    """Every round of the port's `trace_phases_v1`: (walking rays, kernel
    out of those rays, round buffer after), as tensors."""
    rounds = []
    real_find, real_walk = v1.find_surfaces, v1.walk_round

    def find(rays, st_buf, idx, ctx):
        out = real_find(rays, st_buf, idx, ctx)
        rounds.append([idx.clone(), out.clone()])
        return out

    def walk(state, ctx, rays, d_len, buf, idx):
        nxt = real_walk(state, ctx, rays, d_len, buf, idx)
        rounds[-1].append(buf.clone())
        return nxt

    monkeypatch.setattr(v1, "find_surfaces", find)
    monkeypatch.setattr(v1, "walk_round", walk)
    trace_kernel.trace_rays_kernel(tst, torch.as_tensor(o), torch.as_tensor(d), torch_options(OPTS_PLAIN),
                                   megakernel=False)
    monkeypatch.undo()
    return rounds


def _fields_equal(got: dict, want: dict, float_fields, what):
    for k, w in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        if k in float_fields:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", sorted(FIELD_CASES))
def test_v1_rounds_match_aic_tpu(name, monkeypatch):
    build, rays = FIELD_CASES[name]
    st = build()
    o, d = (a.reshape(-1, 3).astype(np.float32) for a in rays())
    want = _aic_rounds(st, o, d, monkeypatch)
    got = _port_rounds(to_port(st), o, d, monkeypatch)
    assert len(got) == len(want) > 1
    floats = v1.ROUND_FLOAT | v1.FLOAT_FIELDS
    for r, ((idx, out, buf), (walking, jout, jst, jsaved, jhb)) in enumerate(zip(got, want)):
        what = f"{name} round {r}"
        np.testing.assert_array_equal(idx.numpy(), np.flatnonzero(walking), err_msg=what)
        kout = trace_kernel.unpack_fields(out, v1.OUT_FIELDS, v1.FLOAT_FIELDS)
        _fields_equal(kout, {k: v[walking] for k, v in jout.items()}, floats, f"{what} kernel")
        st2, saved, hb = v1.unpack_round(buf)
        _fields_equal(st2, jst, floats, f"{what} state")
        _fields_equal(saved, jsaved, floats, f"{what} saved")
        _fields_equal(hb, jhb, floats, f"{what} hits")
