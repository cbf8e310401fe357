"""The PyTorch port's codecs, snapshot tables and megakernel tables
against `aic_tpu` (aic_tpu_torch.math / space / raytrace.trace_kernel).

Scenes are built twice, once with each package's own host content code,
from the same seeds; the port's snapshot must equal `aic_tpu`'s field for
field, the packed brick cells included. The helpers
here (`jax_fields`, `to_port`, the scene builders) are shared by the
other `test_torch_*` files. The port's public functions run on the card
unless asked for the CPU, so every call here asks for it.
"""

import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aic_tpu.block
import aic_tpu.content
import aic_tpu.math.grid
import aic_tpu.space
import aic_tpu_torch.block
import aic_tpu_torch.content
import aic_tpu_torch.math.grid
import aic_tpu_torch.space
from aic_tpu.math import color as jcolor
from aic_tpu.math import lightpack as jlp
from aic_tpu.raytrace import pallas_trace
from aic_tpu_torch.math import color as tcolor
from aic_tpu_torch.math import lightpack as tlp
from aic_tpu_torch.raytrace import trace_kernel
from aic_tpu_torch.space.state import state_from_numpy, state_to_numpy

ROOT = Path(__file__).resolve().parents[1]

# The suite runs several worker processes, each with XLA's CPU thread
# pool; a full-width torch pool beside it oversubscribes the cores.
torch.set_num_threads(2)

PKGS = {
    name: SimpleNamespace(
        block=m.block, GridAab=m.math.grid.GridAab, Space=m.space.Space,
        Sky=m.space.Sky, SpacePhysics=m.space.SpacePhysics,
        atrium=m.content.atrium, cornell_box=m.content.cornell_box,
    )
    for name, m in (("jax", aic_tpu), ("torch", aic_tpu_torch))
}

STATE_KEYS = ("contents", "light", "light_dirty", "cells", "sky_faces", "sky_octants", "sky_mean")


def jax_fields(st):
    """numpy arrays + static metadata of an `aic_tpu` SpaceState, in the
    flat form `state_from_numpy` takes."""
    fields = {k: np.asarray(getattr(st, k)) for k in STATE_KEYS}
    for k in st.tables.__dataclass_fields__:
        fields[k] = np.asarray(getattr(st.tables, k))
    static = dict(
        lower=st.lower, light_max_distance=st.light_max_distance,
        light_enabled=st.light_enabled,
    )
    return fields, static


def to_port(st):
    """The port's CPU SpaceState holding the same arrays as `st`."""
    fields, static = jax_fields(st)
    return state_from_numpy(fields, **static, device="cpu")


@pytest.fixture(autouse=True)
def fresh_pallas_caches(monkeypatch):
    """`aic_tpu` caches its trace tables under `id(state.cells)` without
    checking that the state is still alive, so a new state can be handed
    a dead one's tables (ROADMAP §C). Every test of the port starts with
    empty caches; the modules that import this fixture get it too."""
    monkeypatch.setattr(pallas_trace, "_CTX_CACHE", {})
    monkeypatch.setattr(pallas_trace, "_CTX2_CACHE", {})


# -- scenes, buildable with either package (tests/test_pallas_trace.py) ------


def scene_atoms(p, n=24):
    """24³ → 2×2×2 regions: opaque, transparent and emissive atoms."""
    sp = p.Space(p.GridAab.cube(n), physics=p.SpacePhysics(sky=p.Sky.uniform((0.4, 0.5, 0.6))))
    rng = np.random.RandomState(7)
    colors = [(1.0, 0.1, 0.1, 1.0), (0.1, 1.0, 0.1, 0.45), (0.2, 0.2, 1.0, 1.0)]
    for i in range(40):
        sp.set(tuple(int(v) for v in rng.randint(0, n, 3)), p.block.from_color(colors[i % 3]))
    sp.set((15, 16, 15), p.block.Block(p.block.Atom(color=(0, 0, 0, 1.0), emission=(2.0, 1.0, 0.5))))
    return sp


def _inner8(p):
    inner8 = p.Space(p.GridAab.cube(8))
    inner8.fill(p.GridAab.from_lower_size((0, 0, 0), (8, 4, 8)), p.block.from_color((1.0, 1.0, 0.0, 1.0)))
    inner8.set((3, 6, 3), p.block.from_color((1.0, 0.0, 1.0, 0.5)))
    return inner8


def scene_voxels(p):
    """R8 and R4 voxel blocks + an atom in one 20³ space."""
    inner4 = p.Space(p.GridAab.cube(4))
    for x in range(4):
        for z in range(4):
            if (x + z) % 2 == 0:
                inner4.set((x, 0, z), p.block.from_color((0.0, 0.8, 0.8, 1.0)))
    sp = p.Space(p.GridAab.cube(20), physics=p.SpacePhysics(sky=p.Sky.uniform((0.3, 0.3, 0.35))))
    b8 = p.block.Block(p.block.Recur(space=_inner8(p), resolution=8))
    b4 = p.block.Block(p.block.Recur(space=inner4, resolution=4))
    for c in [(2, 2, 2), (9, 2, 9), (17, 3, 5), (5, 10, 15)]:
        sp.set(c, b8)
    for c in [(4, 2, 7), (12, 5, 12), (16, 16, 16)]:
        sp.set(c, b4)
    sp.set((7, 2, 2), p.block.from_color((0.9, 0.2, 0.2, 1.0)))
    return sp


def scene_r32(p):
    """R32 voxel blocks (walked as 8 octant rows) + an R8 block + an atom."""
    inner32 = p.Space(p.GridAab.cube(32))
    inner32.fill(p.GridAab.from_lower_size((0, 0, 0), (32, 6, 32)), p.block.from_color((0.9, 0.7, 0.2, 1.0)))
    for i in range(32):
        inner32.set((i, min(i, 31), i), p.block.from_color((0.2, 0.4, 0.9, 1.0)))
    inner32.set((20, 20, 8), p.block.from_color((0.9, 0.1, 0.1, 0.5)))
    inner8 = p.Space(p.GridAab.cube(8))
    inner8.fill(p.GridAab.from_lower_size((0, 0, 0), (8, 8, 4)), p.block.from_color((0.1, 0.8, 0.4, 1.0)))
    sp = p.Space(p.GridAab.cube(20), physics=p.SpacePhysics(sky=p.Sky.uniform((0.3, 0.32, 0.4))))
    b32 = p.block.Block(p.block.Recur(space=inner32, resolution=32))
    for c in [(3, 2, 3), (10, 2, 12), (16, 8, 6)]:
        sp.set(c, b32)
    sp.set((8, 2, 5), p.block.Block(p.block.Recur(space=inner8, resolution=8)))
    sp.set((13, 2, 8), p.block.from_color((0.8, 0.2, 0.2, 1.0)))
    return sp


SCENES = {
    "atoms": scene_atoms,
    "voxels": scene_voxels,
    "r32": scene_r32,
    "cornell16": lambda p: p.cornell_box(16),
    "atrium_small": lambda p: p.atrium(width=24, depth=16, floors=2),
}


# -- codecs -------------------------------------------------------------------


class TestCodecs:
    def test_packed_light_u8_bit_exact(self):
        """Every u8 code decodes and re-encodes to itself, and encodes the
        JAX package's decoded values to the JAX package's codes."""
        u = np.arange(256, dtype=np.uint8)
        jdec = np.asarray(jlp.decode_scalar(jnp.asarray(u)))
        tdec = tlp.decode_scalar(torch.as_tensor(u))
        np.testing.assert_array_equal(tlp.encode_scalar(tdec).numpy(), u)
        np.testing.assert_array_equal(
            tlp.encode_scalar(torch.tensor(jdec)).numpy(),
            np.asarray(jlp.encode_scalar(jnp.asarray(jdec))),
        )
        # Decoded floats: XLA's and torch's exp2 differ in the last ulps.
        np.testing.assert_allclose(tdec.numpy(), jdec, rtol=1e-6, atol=0)
        assert tdec[0] == 0.0

    def test_encode_edge_values(self):
        v = np.array([0.0, -1.0, np.inf, np.nan, 1e-30, 1e30, 1.0], np.float32)
        np.testing.assert_array_equal(
            tlp.encode_scalar(torch.as_tensor(v)).numpy(),
            np.asarray(jlp.encode_scalar(jnp.asarray(v))),
        )

    def test_difference_priority(self):
        rng = np.random.default_rng(0)
        a = rng.integers(0, 256, (500, 4), dtype=np.uint8)
        b = a.copy()
        b[::3, :3] = rng.integers(0, 256, (len(b[::3]), 3), dtype=np.uint8)
        b[::7, 3] ^= 1
        np.testing.assert_array_equal(
            tlp.difference_priority(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
            np.asarray(jlp.difference_priority(jnp.asarray(a), jnp.asarray(b))),
        )

    def test_linear_to_srgb8_bit_exact(self):
        rng = np.random.default_rng(1)
        lin = np.concatenate(
            [jcolor.np_srgb8_to_linear(np.arange(256)), rng.uniform(-0.1, 2.0, 20000)]
        ).astype(np.float32)
        np.testing.assert_array_equal(
            tcolor.linear_to_srgb8(torch.as_tensor(lin)).numpy(),
            np.asarray(jcolor.linear_to_srgb8(jnp.asarray(lin))),
        )
        np.testing.assert_array_equal(
            tcolor.linear_to_srgb8(torch.as_tensor(jcolor.np_srgb8_to_linear(np.arange(256)))).numpy(),
            np.arange(256),
        )


# -- snapshot tables ------------------------------------------------------------


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene_pair(request):
    build = SCENES[request.param]
    return request.param, build(PKGS["jax"]).snapshot(), build(PKGS["torch"]).snapshot(device="cpu")


class TestSnapshot:
    def test_tables_equal(self, scene_pair):
        """Recursive R4/R8/R16/R32 evaluation and the snapshot give the
        same arrays in both packages."""
        _name, jst, tst = scene_pair
        fields, static = jax_fields(jst)
        tfields, tstatic = state_to_numpy(tst)
        assert tstatic == dict(static, lower=tuple(static["lower"]))
        for k, want in fields.items():
            got = tfields[k]
            assert got.shape == want.shape, k
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)

    def test_numpy_round_trip(self, scene_pair):
        _name, jst, _tst = scene_pair
        fields, static = jax_fields(jst)
        st = state_from_numpy(fields, **static, device="cpu")
        assert st.contents.dtype == torch.int32
        back, back_static = state_to_numpy(st)
        assert back_static["lower"] == tuple(static["lower"])
        for k in back:
            np.testing.assert_array_equal(back[k], fields[k], err_msg=k)

    def test_bitmask_ctx2_equal(self, scene_pair):
        """Megakernel tables (both page formats) equal `aic_tpu`'s."""
        name, jst, tst = scene_pair
        want = pallas_trace.build_bitmask_ctx2(jst)
        got = trace_kernel.build_bitmask_ctx2(tst)
        for k in ("rdims", "size", "n_regions", "n_ventries", "has_r32", "wide_pages"):
            assert getattr(got, k) == getattr(want, k), k
        for k in ("rows", "l1", "page_idx", "pages"):
            w, g = getattr(want, k), getattr(got, k)
            assert (w is None) == (g is None), k
            if w is not None:
                w = np.asarray(w)
                np.testing.assert_array_equal(g.numpy().view(w.dtype), w, err_msg=k)
        if name == "atrium_small":
            assert got.pages is not None and not got.wide_pages
        if name == "r32":
            assert got.wide_pages and got.has_r32
        if name == "cornell16":
            assert got.pages is None


def test_full_atrium_tables():
    """The north-star scene: 60×35×40 cubes, 36 regions + 9 R16 rows,
    512 rows of narrow pages, no R32 (host numpy only)."""
    st = aic_tpu_torch.content.atrium().snapshot(device="cpu")
    assert tuple(st.contents.shape) == (60, 35, 40)
    assert st.light_max_distance == 60
    ctx = trace_kernel.build_bitmask_ctx2(st)
    assert ctx.n_regions == 36 and ctx.rows.shape[0] == 45
    assert tuple(ctx.pages.shape) == (512, 128)
    assert not ctx.wide_pages and not ctx.has_r32
    assert trace_kernel.megakernel_fits(st)


def test_device_defaults_are_the_card():
    """`Space.snapshot`, `Camera.pixel_rays` and `state_from_numpy` run on
    CUDA unless the caller asks for the CPU; asked for CUDA where there is
    no card, they raise rather than fall back."""
    import inspect

    from aic_tpu_torch.raytrace import Camera, GraphicsOptions, Viewport

    for fn in (aic_tpu_torch.space.Space.snapshot, Camera.pixel_rays, state_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        p = PKGS["torch"]
        with pytest.raises((RuntimeError, AssertionError)):
            p.Space(p.GridAab.cube(2)).snapshot()
        with pytest.raises((RuntimeError, AssertionError)):
            Camera(GraphicsOptions(), Viewport(4, 2)).pixel_rays()
        fields, static = jax_fields(scene_atoms(PKGS["jax"]).snapshot())
        with pytest.raises((RuntimeError, AssertionError)):
            state_from_numpy(fields, **static)


def test_import_leaves_out_jax():
    """The port (every module, `aic_tpu_torch.testing` included) and
    `chip_smoke.py` import no JAX, not even through `aic_tpu` (the card's
    machine has none), and no PIL, at import or inside a function: the
    port reads and writes its images itself. `tools/pil_glyph_table.py`,
    which writes the glyph table from PIL's font, is the one module that
    imports PIL, and is left out."""
    pil = re.compile(r"^\s*(from|import)\s+PIL\b", re.M)
    users = [str(f.relative_to(ROOT)) for f in sorted((ROOT / "aic_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             if pil.search(f.read_text())]
    assert users == ["aic_tpu_torch/tools/pil_glyph_table.py"], users
    code = (
        "import importlib, pkgutil, sys; import aic_tpu_torch, chip_smoke; "
        "[importlib.import_module(m.name) for m in pkgutil.walk_packages(aic_tpu_torch.__path__, "
        "'aic_tpu_torch.') if m.name != 'aic_tpu_torch.tools.pil_glyph_table']; "
        "bad = [m for m in sys.modules if m in ('jax', 'aic_tpu', 'PIL')"
        " or m.startswith(('jax.', 'aic_tpu.', 'PIL.'))]; print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr
