"""`plaza640`, the world whose megakernel tables exceed their budget, in
both packages: the auto dispatch of each picks its v1 kernel, and the
port's image there equals `aic_tpu`'s (`trace_rays_pallas` with its v1
Pallas kernel in interpret mode) at atol=2e-3
(tests/test_pallas_trace.py:30).

`aic_tpu` has no plaza template, so `jax_plaza` builds the same world
from `aic_tpu`'s own atrium blocks; the two snapshots are held equal
field for field, the packed cells included. One 32×32 grid of rays looks
down on the column at (37, 1, 259) and the floor around it from inside
the volume, so the Pallas interpreter walks few domains.
"""

import functools
import importlib

import numpy as np
import torch

import jax.numpy as jnp

from aic_tpu.raytrace import GraphicsOptions
from aic_tpu.raytrace import pallas_trace
from aic_tpu_torch.content import plaza
from aic_tpu_torch.raytrace import trace_kernel, trace_kernel_v1
from test_torch_state import PKGS, jax_fields, to_port, fresh_pallas_caches  # noqa: F401 (autouse)
from test_torch_trace import torch_options

SMOOTH = GraphicsOptions(lighting_display="smoothstep", fog="none", transparency="volumetric")


def jax_plaza(size=640):
    """`aic_tpu_torch.content.plaza` built with `aic_tpu`."""
    p = PKGS["jax"]
    # (`aic_tpu.content.atrium` names the template function; the module
    # is imported by name.)
    blocks = importlib.import_module("aic_tpu.content.atrium")._atrium_blocks(16)
    sp = p.Space(
        p.GridAab.from_lower_size((0, 0, 0), (size, 8, size)),
        physics=p.SpacePhysics(sky=p.Sky.uniform((0.6, 0.7, 0.9))),
    )
    sp.fill(p.GridAab.from_lower_size((0, 0, 0), (size, 1, size)), blocks["floor"])
    for i in range(0, size, 37):
        sp.set((i, 1, (7 * i) % size), blocks["column"])
    sp.fast_evaluate_light()
    return sp


@functools.lru_cache(maxsize=None)
def _states():
    jst = jax_plaza().snapshot()
    return jst, to_port(jst)


def _rays():
    """32×32 rays from (31.5, 7.5, 252.5) fanning down towards the column."""
    u, v = np.meshgrid(np.linspace(-0.35, 0.35, 32), np.linspace(-0.35, 0.35, 32), indexing="ij")
    d = np.stack([0.45 + u, np.full_like(u, -0.6), 0.5 + v], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.asarray([31.5, 7.5, 252.5], np.float32), d.shape).copy()
    return o, d


def test_port_snapshot_equals_aic_tpu():
    jst, _ = _states()
    fields, _static = jax_fields(jst)
    got = plaza().snapshot(device="cpu")
    assert tuple(got.contents.shape) == (640, 8, 640)
    for k, want in fields.items():
        g = getattr(got, k) if hasattr(got, k) else getattr(got.tables, k)
        np.testing.assert_array_equal(g.numpy(), want.astype(g.numpy().dtype), err_msg=k)


def test_both_packages_send_it_to_v1():
    """13.3 MiB of megakernel tables (1600 narrow pages): over the 10 MiB
    budget in both packages; the v1 tables equal `aic_tpu`'s."""
    jst, tst = _states()
    assert not pallas_trace._megakernel_fits(jst)
    assert not trace_kernel.megakernel_fits(tst)
    ctx2 = trace_kernel.get_bitmask_ctx2(tst)
    assert tuple(ctx2.pages.shape) == (1600 * 16, 128)
    want = pallas_trace.build_bitmask_ctx(jst)
    got = trace_kernel_v1.get_bitmask_ctx(tst)
    assert got.rows.shape[0] == 1602 and got.n_regions == 1600
    np.testing.assert_array_equal(got.rows.numpy().view(np.uint32), np.asarray(want.rows))
    np.testing.assert_array_equal(got.l1.numpy().view(np.uint32), np.asarray(want.l1))


def test_image_matches_pallas_auto_dispatch(monkeypatch):
    """Auto dispatch in both packages: the port's v1 path against
    `trace_rays_pallas`'s, smooth lighting through direct texel fetches
    (the plaza is above the interpolation-row table's volume)."""
    jst, tst = _states()
    o, d = _rays()
    want_l, want_t, stats = pallas_trace.trace_rays_pallas(
        jst, jnp.asarray(o), jnp.asarray(d), SMOOTH, interpret=True, return_stats=True
    )
    assert not bool(stats["unfinished"])
    calls = []
    real = trace_kernel_v1.trace_phases_v1
    monkeypatch.setattr(trace_kernel_v1, "trace_phases_v1", lambda *a: calls.append(1) or real(*a))
    got_l, got_t, unfinished = trace_kernel.trace_rays_kernel(
        tst, torch.as_tensor(o), torch.as_tensor(d), torch_options(SMOOTH)
    )
    assert calls == [1] and not unfinished
    assert float(got_l.max()) > 0.05  # lit floor and column, not only black
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=2e-3)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=2e-3)
