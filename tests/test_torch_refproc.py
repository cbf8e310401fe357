"""The port's reference-procedure relight, its whole-volume round and its
last small public functions, against `aic_tpu`'s on the CPU.

- `refproc._deps_scatter` equals `aic_tpu`'s bit for bit on the same
  state, cubes and priorities (the walk's branches read the contents
  only).
- `evaluate_light_reference` on tests/test_light.py's 6³ scene and on
  cornell-box 4: statuses equal, packed light within 4 steps and a mean
  decoded difference under 0.01 where visible (tests/test_ref_relight.py's
  criteria: the port's plain batch walk sums a cube's rays in another
  order than XLA, so a bucket can differ by a step and the draws follow).
- `dense.relight_all`: light within one packed step, statuses equal (the
  dense pass's tolerance elsewhere); its commit (`_apply_pass`) of the
  same new light equals `aic_tpu`'s bit for bit, dirty marks and stats.
- The colour, light-codec and cell helpers, `SpaceState.size` and
  `cube_to_index`, `SpacePhysics.default_for_light_test`,
  `SlabSharded.n_devices`, `native_available`, `main.build_template`,
  `profiling.device_trace` and the `light` and `space` exports, each
  against its `aic_tpu` counterpart: exact, but the colour curves within
  1e-6 relative (`pow` differs in the last ulp between the libraries).

`aic_tpu`'s results are computed once per module.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aic_tpu.light as jlight
import aic_tpu.space as jspace
import aic_tpu_torch.light as tlight
import aic_tpu_torch.space as tspace
from aic_tpu.light import dense as jdense
from aic_tpu.light import refproc as jref
from aic_tpu.math import color as jcolor
from aic_tpu.math import lightpack as jlp
from aic_tpu.raytrace import accel as jaccel
from aic_tpu_torch.light import dense as tdense
from aic_tpu_torch.light import refproc as tref
from aic_tpu_torch.math import color as tcolor
from aic_tpu_torch.math import lightpack as tlp
from aic_tpu_torch.raytrace import accel as taccel
from test_torch_state import PKGS, fresh_pallas_caches, to_port  # noqa: F401 (autouse)

#: tests/test_ref_relight.py's criteria.
REF_MAX_STEPS = 4
REF_MEAN_DECODED = 0.01
#: The dense pass's tolerance (one packed step).
PASS_MAX_STEPS = 1
#: `pow` in the sRGB curves, relative.
COLOR_RTOL = 1e-6


def scene_6(p):
    """tests/test_light.py:297's scene: a floor, one red cube, a sky."""
    sp = p.Space(p.GridAab.from_lower_size((0, 0, 0), (6, 6, 6)),
                 physics=p.SpacePhysics(sky=p.Sky.uniform((0.8, 0.8, 0.9))))
    sp.fill(p.GridAab.from_lower_size((0, 0, 0), (6, 1, 6)), p.block.from_color((0.5, 0.5, 0.5, 1.0)))
    sp.set((2, 1, 2), p.block.from_color((0.9, 0.2, 0.2, 1.0)))
    return sp


SCENES = {"6^3": scene_6, "cornell-box 4": lambda p: p.cornell_box(4)}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    """(name, `aic_tpu`'s state, the port's state holding the same arrays,
    `aic_tpu`'s reference-procedure light)."""
    js = SCENES[request.param](PKGS["jax"]).snapshot()
    ref = np.asarray(jref.evaluate_light_reference(js).light)
    return request.param, js, to_port(js), ref


@pytest.mark.parametrize("seed", [0, 1])
def test_deps_scatter_matches_aic_tpu(scene, seed):
    _name, js, ts, _ref = scene
    rng = np.random.default_rng(seed)
    size = js.contents.shape
    cubes = np.stack([rng.integers(0, n, 64) for n in size], -1).astype(np.int32)
    prios = np.where(rng.random(64) < 0.75, rng.integers(2, 129, 64), 0).astype(np.uint8)
    want = np.asarray(jref._deps_scatter(js, jnp.asarray(cubes), jnp.asarray(prios)))
    got = tref._deps_scatter(ts, torch.as_tensor(cubes), torch.as_tensor(prios))
    assert got.dtype == torch.uint8 and tuple(got.shape) == size
    assert (want > 0).any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_evaluate_light_reference_matches_aic_tpu(scene):
    _name, _js, ts, want = scene
    got = tref.evaluate_light_reference(ts)
    assert got.device == ts.device
    got = got.light.numpy()
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    vis = want[..., 3] == jlp.STATUS_VISIBLE
    assert vis.any()
    diff = np.abs(got[..., :3].astype(int) - want[..., :3].astype(int))[vis]
    assert diff.max() <= REF_MAX_STEPS, diff.max()
    a = jlp.DECODE_TABLE[got[..., :3]][vis]
    b = jlp.DECODE_TABLE[want[..., :3]][vis]
    assert np.abs(a - b).mean() < REF_MEAN_DECODED


def test_relight_all_matches_aic_tpu(scene):
    _name, js, ts, _ref = scene
    jst, jstats = jdense.relight_all(js)
    tst, tstats = tdense.relight_all(ts)
    want, got = np.asarray(jst.light), tst.light.numpy()
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    assert np.abs(got[..., :3].astype(int) - want[..., :3].astype(int)).max() <= PASS_MAX_STEPS
    assert tstats["updated"] == int(jstats["updated"])
    # The commit of the same new light: bit for bit.
    new = np.array(jst.light)
    jc, jcs = jdense._apply_pass(js, jnp.asarray(new))
    tc, tcs = tdense._apply_pass(ts, torch.as_tensor(new))
    np.testing.assert_array_equal(tc.light_dirty.numpy(), np.asarray(jc.light_dirty))
    assert (int(tcs["max_diff"]), int(tcs["queue_remaining"])) == (int(jcs["max_diff"]), int(jcs["queue_remaining"]))


def test_color_and_light_helpers_match_aic_tpu():
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.5, 1.5, (64, 4)).astype(np.float32)
    illum = rng.uniform(0, 4, (64, 3)).astype(np.float32)
    for name in ("nonneg", "clamp01"):
        np.testing.assert_array_equal(getattr(tcolor, name)(torch.as_tensor(x)).numpy(),
                                      np.asarray(getattr(jcolor, name)(jnp.asarray(x))))
    np.testing.assert_array_equal(tcolor.reflect(torch.as_tensor(x), torch.as_tensor(illum)).numpy(),
                                  np.asarray(jcolor.reflect(jnp.asarray(x), jnp.asarray(illum))))
    np.testing.assert_allclose(tcolor.srgb_decode(torch.as_tensor(x)).numpy(),
                               np.asarray(jcolor.srgb_decode(jnp.asarray(x))), rtol=COLOR_RTOL)
    rgb8 = np.arange(256, dtype=np.uint8)
    np.testing.assert_allclose(tcolor.srgb8_to_linear(torch.as_tensor(rgb8)).numpy(),
                               np.asarray(jcolor.srgb8_to_linear(jnp.asarray(rgb8))), rtol=COLOR_RTOL)

    texels = rng.integers(0, 256, (256, 4)).astype(np.uint8)
    texels[:, 3] = rng.integers(0, 5, 256)
    np.testing.assert_array_equal(tlp.valid(torch.as_tensor(texels)).numpy(),
                                  np.asarray(jlp.valid(jnp.asarray(texels))))
    got = tlp.decode_with_ao(torch.as_tensor(texels)).numpy()
    want = np.asarray(jlp.decode_with_ao(jnp.asarray(texels)))
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    np.testing.assert_array_equal(got[..., :3], tlp.decode_rgb(torch.as_tensor(texels)).numpy())
    np.testing.assert_allclose(got[..., :3], want[..., :3], rtol=COLOR_RTOL)


def test_state_helpers_match_aic_tpu(scene):
    _name, js, ts, _ref = scene
    for got, want in zip(taccel.unpack_cell(ts.cells), jaccel.unpack_cell(js.cells)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ts.size == tuple(js.size)
    cubes = np.random.default_rng(4).integers(-8, 8, (16, 3)).astype(np.int32)
    moved = dataclasses.replace(ts, lower=(3, -2, 5))
    np.testing.assert_array_equal(
        moved.cube_to_index(torch.as_tensor(cubes)).numpy(),
        np.asarray(dataclasses.replace(js, lower=(3, -2, 5)).cube_to_index(jnp.asarray(cubes))))
    np.testing.assert_equal(dataclasses.asdict(PKGS["torch"].SpacePhysics.default_for_light_test()),
                            dataclasses.asdict(PKGS["jax"].SpacePhysics.default_for_light_test()))


def test_slab_n_devices_is_the_world_size():
    from aic_tpu.parallel.mesh import make_mesh as jmake_mesh
    from aic_tpu.parallel.slab import shard_space as jshard
    from aic_tpu_torch.parallel import make_mesh
    from aic_tpu_torch.parallel.slab import shard_space

    js = scene_6(PKGS["jax"]).snapshot()
    sh = shard_space(to_port(js), make_mesh(1, device="cpu"))
    assert sh.n_devices == sh.mesh.world == jshard(js, jmake_mesh(1, axis="slab")).n_devices == 1


def test_native_available_and_a_failed_build_still_raises(monkeypatch, tmp_path):
    from aic_tpu_torch import native

    assert native.native_available()

    def no_compiler():
        raise RuntimeError("g++ not found: the native mesher and reference relight need a C++ compiler")

    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "_cxx", no_compiler)
    monkeypatch.setattr(native, "library_path", lambda name: tmp_path / f"lib{name}.so")
    assert not native.native_available()
    state = to_port(scene_6(PKGS["jax"]).snapshot())
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.ref_relight_state(state)


def test_build_template_matches_aic_tpu():
    from aic_tpu.main import build_template as jbuild
    from aic_tpu_torch.main import build_template as tbuild

    js, ts = jbuild("cornell-box", seed=0, size=4), tbuild("cornell-box", seed=0, size=4)
    np.testing.assert_array_equal(ts.contents, js.contents)
    with pytest.raises(SystemExit) as want:
        jbuild("no-such-template")
    with pytest.raises(SystemExit) as got:
        tbuild("no-such-template")
    # The same text, each package naming its own templates (the port
    # also builds plaza640 by name).
    from aic_tpu.content import TEMPLATE_NAMES as JNAMES
    from aic_tpu_torch.content import TEMPLATE_NAMES as TNAMES

    assert str(got.value) == str(want.value).replace(", ".join(JNAMES), ", ".join(TNAMES))
    assert set(JNAMES) <= set(TNAMES)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    from aic_tpu_torch.profiling import device_trace

    with device_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    assert sorted(os.listdir(tmp_path / "trace")) == ["idle_by_span.json", "trace.json"]


def test_light_and_space_export_what_aic_tpu_exports():
    assert set(jlight.__all__) <= set(tlight.__all__)
    assert set(jspace.__all__) <= set(tspace.__all__)
    for pkg, names in ((tlight, jlight.__all__), (tspace, jspace.__all__)):
        for name in names:
            assert hasattr(pkg, name), name
