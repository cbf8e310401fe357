"""The port's general tracer and bounce lighting
(`aic_tpu_torch.raytrace.tracer.trace_rays`, `trace_rays_bounce`) against
`aic_tpu`'s XLA `trace_rays` and `trace_rays_bounce`, run on the CPU as
`aic_tpu`'s own tests run them (plain XLA; no Pallas kernel is reached).

Each case feeds both tracers the same rays on the same state (`to_port`)
and asks for everything at once: the stats, the hit buffers and the step
counts. Hit kind, palette index, voxel index, face and cube must be
equal for every ray and phase, hit t within 1e-5 relative, the step
counts and the stats (per-phase loop iterations and walkers, unfinished)
equal, light and transmittance within 2e-3 (tests/test_pallas_trace.py's
tolerance). One `aic_tpu` compile per case: the cases share nothing
that would let them share one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aic_tpu import block
from aic_tpu.content.cornell import cornell_box
from aic_tpu.math import lightpack as jlightpack
from aic_tpu.math.grid import GridAab
from aic_tpu.raytrace import Camera, GraphicsOptions, Viewport
from aic_tpu.raytrace import tracer as jtracer
from aic_tpu.space import Sky, Space, SpacePhysics
from aic_tpu_torch.raytrace import tracer as ttracer
from test_torch_state import fresh_pallas_caches, to_port  # noqa: F401 (autouse)
from test_torch_trace import torch_options

LIGHT_ATOL = 2e-3
T_RTOL = 1e-5
HIT_INT_KEYS = ("hit_kind", "hit_idx", "hit_vflat", "hit_face", "hit_cube")


def with_random_light(st, seed=0):
    """The state with a seeded random light field: texels uniform over
    the codes of light 1/16..4, status OPAQUE in visible cubes and
    VISIBLE elsewhere, so that smooth and flat shading read varied light
    everywhere."""
    rng = np.random.RandomState(seed)
    lo, hi = (int(jlightpack.LOG_OFFSET + jlightpack.LOG_SCALE * e) for e in (-4, 2))
    light = rng.randint(lo, hi + 1, st.light.shape).astype(np.uint8)
    visible = np.asarray(st.tables.visible)[np.asarray(st.contents)]
    light[..., 3] = np.where(visible, jlightpack.STATUS_OPAQUE, jlightpack.STATUS_VISIBLE)
    return dataclasses.replace(st, light=jnp.asarray(light))


def scene_cornell():
    return with_random_light(cornell_box(16).snapshot(), seed=1)


def scene_glass():
    """Rows of half-transparent and emissive blocks in front of an opaque
    wall, over a floor: up to four surfaces along a ray."""
    sp = Space(GridAab.cube(16), physics=SpacePhysics(sky=Sky.uniform((0.5, 0.6, 0.7))))
    sp.fill(GridAab.from_lower_size((0, 0, 0), (16, 1, 16)), block.from_color((0.4, 0.6, 0.3, 1.0)))
    sp.fill(GridAab.from_lower_size((0, 1, 0), (16, 12, 1)), block.from_color((0.8, 0.8, 0.8, 1.0)))
    for z, color in ((4, (0.9, 0.2, 0.2, 0.4)), (8, (0.2, 0.9, 0.2, 0.6)), (12, (0.2, 0.2, 0.9, 0.3))):
        sp.fill(GridAab.from_lower_size((2, 1, z), (12, 9, 1)), block.from_color(color))
    sp.set((7, 5, 6), block.Block(block.Atom(color=(0, 0, 0, 0.5), emission=(2.0, 1.0, 0.5))))
    return with_random_light(sp.snapshot(), seed=2)


def scene_r64():
    """An R64 voxel block (no kernel holds it) beside atoms, and a
    thin, half-transparent shelf inside the block."""
    inner = Space(GridAab.cube(64))
    inner.fill(GridAab.from_lower_size((0, 0, 0), (64, 8, 64)), block.from_color((0.9, 0.7, 0.2, 1.0)))
    for i in range(64):
        inner.set((i, i, 63 - i), block.from_color((0.2, 0.4, 0.9, 1.0)))
    inner.fill(GridAab.from_lower_size((8, 40, 8), (48, 1, 48)), block.from_color((0.9, 0.1, 0.1, 0.5)))
    sp = Space(GridAab.cube(12), physics=SpacePhysics(sky=Sky.uniform((0.3, 0.32, 0.4))))
    sp.set((5, 4, 5), block.Block(block.Recur(space=inner, resolution=64)))
    sp.set((2, 4, 5), block.from_color((0.8, 0.2, 0.2, 1.0)))
    sp.fill(GridAab.from_lower_size((0, 0, 0), (12, 1, 12)), block.from_color((0.4, 0.6, 0.3, 1.0)))
    return with_random_light(sp.snapshot(), seed=3)


def camera_rays(opts, eye, target, w=64, h=48):
    cam = Camera(opts, Viewport(w, h))
    cam.look_at(eye, target)
    o, d = cam.pixel_rays()
    return cam.options, np.asarray(o), np.asarray(d)


def inside_rays(h=48, w=64, seed=4):
    """Rays from points inside and around the R64 block, in every
    direction: the origin-inside-a-voxel-block descent. Shaped as the
    camera case's rays, so that both R64 cases share one `aic_tpu`
    compile."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(4.6, 6.4, (h, w, 3)).astype(np.float32)
    d = rng.normal(size=(h, w, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


SMOOTH = GraphicsOptions(lighting_display="smoothstep", fog="none")
VOLUMETRIC = GraphicsOptions(lighting_display="smoothstep", fog="abrupt", transparency="volumetric")
FLAT = GraphicsOptions(lighting_display="flat", fog="none")

#: name → (scene, (options, origins, directions) maker, trace_rays keywords)
CASES = {
    "cornell16 beam phases4": (
        "cornell", lambda: camera_rays(SMOOTH, (8.0, 8.0, 28.0), (8.0, 7.0, 8.0)),
        dict(beam_tile=8, phases=4),
    ),
    "transparent volumetric beam phases4": (
        "glass", lambda: camera_rays(VOLUMETRIC, (8.0, 8.0, 24.0), (8.0, 5.0, 4.0)),
        dict(beam_tile=8, phases=4),
    ),
    "transparent no-beam phases1 override max_steps": (
        "glass", lambda: camera_rays(VOLUMETRIC, (20.0, 10.0, 20.0), (8.0, 5.0, 6.0), 32, 24),
        dict(beam_tile=0, phases=1, max_steps=6, illum_override=True),
    ),
    "r64 beam phases4": (
        "r64", lambda: camera_rays(FLAT, (14.0, 9.0, 16.0), (5.5, 4.5, 5.5)),
        dict(beam_tile=8, phases=4),
    ),
    "r64 origins inside phases4": ("r64", lambda: (FLAT,) + inside_rays(), dict(beam_tile=8, phases=4)),
}


@pytest.fixture(scope="module")
def scenes():
    return {"cornell": scene_cornell(), "glass": scene_glass(), "r64": scene_r64()}


def _both(st, opts, o, d, kw):
    kw = dict(kw)
    override = kw.pop("illum_override", False)
    jo = to = None
    if override:
        rng = np.random.RandomState(11)
        ov = rng.uniform(0.0, 2.0, o.shape).astype(np.float32)
        jo, to = jnp.asarray(ov), torch.as_tensor(ov)
    common = dict(return_stats=True, return_hits=True, count_steps=True, **kw)
    want = jtracer.trace_rays(st, jnp.asarray(o), jnp.asarray(d), opts, illum_override=jo, **common)
    got = ttracer.trace_rays(to_port(st), torch.as_tensor(o), torch.as_tensor(d), torch_options(opts),
                             illum_override=to, **common)
    return want, got


def assert_hits_equal(got: dict, want: dict, what: str):
    for k in HIT_INT_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=f"{what} {k}")
    np.testing.assert_allclose(got["hit_t"].numpy(), np.asarray(want["hit_t"]), rtol=T_RTOL, atol=0,
                               err_msg=f"{what} hit_t")


@pytest.mark.parametrize("name", list(CASES))
def test_trace_rays_matches_aic_tpu(scenes, name):
    scene, rays, kw = CASES[name]
    opts, o, d = rays()
    (wl, wt, wstats, whits, wsteps), (gl, gt, gstats, ghits, gsteps) = _both(scenes[scene], opts, o, d, kw)
    for k in ("iters", "walkers"):
        np.testing.assert_array_equal(gstats[k].numpy(), np.asarray(wstats[k]), err_msg=k)
    assert bool(gstats["unfinished"]) == bool(wstats["unfinished"])
    assert bool(gstats["unfinished"]) == (kw.get("max_steps") is not None)
    assert len(ghits["phases"]) == len(whits["phases"]) == kw["phases"]
    for p, (g, w) in enumerate(zip(ghits["phases"], whits["phases"])):
        assert_hits_equal(g, w, f"phase {p}")
    np.testing.assert_array_equal(gsteps.numpy(), np.asarray(wsteps))
    if kw["phases"] > 1 and name.startswith("transparent"):
        assert int(gstats["walkers"][1]) > 0  # rays resume past a transparent hit
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=LIGHT_ATOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=LIGHT_ATOL)
    assert (ghits["hit_kind"].numpy() != 0).mean() > 0.1  # the case sees something
    assert gl.shape == tuple(o.shape)


def test_bounce_matches_aic_tpu(scenes):
    """`trace_rays_bounce` on cornell-box 16, the port fed `aic_tpu`'s own
    draws (`jax.random.split` of the key, one `normal` per sample)."""
    st = scenes["cornell"]
    opts = dataclasses.replace(SMOOTH, lighting_display="bounce", bounce_samples=3)
    opts, o, d = camera_rays(opts, (8.0, 8.0, 28.0), (8.0, 7.0, 8.0), 24, 16)
    key = jax.random.PRNGKey(5)
    want_l, want_t = jtracer.trace_rays_bounce(st, jnp.asarray(o), jnp.asarray(d), opts, key)
    keys = jax.random.split(key, opts.bounce_samples)
    draws = np.stack([np.asarray(jax.random.normal(k, (o.size // 3, 3))) for k in keys])
    got_l, got_t = ttracer.bounce_from_samples(
        to_port(st), torch.as_tensor(o), torch.as_tensor(d), torch_options(opts), torch.as_tensor(draws)
    )
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=LIGHT_ATOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=LIGHT_ATOL)
    # The sampled illumination differs from Flat shading's.
    flat_l, _ = ttracer.trace_rays(to_port(st), torch.as_tensor(o), torch.as_tensor(d),
                                   torch_options(dataclasses.replace(opts, lighting_display="flat")),
                                   beam_tile=0)
    assert float((flat_l - got_l).abs().max()) > 1e-2


def test_bounce_draws_from_the_generator(scenes):
    """`trace_rays_bounce` draws its samples from the generator it is
    given: the same seed, the same frame."""
    tst = to_port(scenes["cornell"])
    opts = torch_options(dataclasses.replace(SMOOTH, lighting_display="bounce", bounce_samples=2))
    _, o, d = camera_rays(SMOOTH, (8.0, 8.0, 28.0), (8.0, 7.0, 8.0), 8, 8)
    assert tst.light.float().mean() > 0
    o, d = torch.as_tensor(o), torch.as_tensor(d)

    def frame(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        return ttracer.trace_rays_bounce(tst, o, d, opts, gen)[0]

    a, b = frame(3), frame(3)
    assert torch.equal(a, b) and a.shape == (8, 8, 3)
    assert not torch.equal(a, frame(4))
