"""The port's mesher (aic_tpu_torch.mesh, .native) and the Space edit
journal against `aic_tpu`, on the CPU.

Scenes are built with each package's own content code from the same
seeds (tests/test_mesh_ref.py's, test_mesh_io.py's, test_native.py's and
test_mesh_atlas.py's scenes, cornell-box 8, a numpy-seeded 12³ mixed
scene with voxel blocks, tests/test_torch_state.py's voxel scene, and
the atrium for the atlas). Every mesh is compared bit for bit:
positions, colors, indices (dtype included), UVs, the atlas image and
the opaque and transparent ranges. Both packages take the native C++
path (`aic_tpu` does where g++ builds it, as here); the port's native
code is also held against the plain versions it replaces, and a build
that fails raises.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import aic_tpu.mesh as jmesh
import aic_tpu.native as jnative
import aic_tpu.universe as jU
import aic_tpu_torch.mesh as tmesh
import aic_tpu_torch.native as tnative
import aic_tpu_torch.universe as tU
from aic_tpu.mesh import atlas as jatlas
from aic_tpu.mesh import mesher as jmesher
from aic_tpu_torch.mesh import atlas as tatlas
from aic_tpu_torch.mesh import mesher as tmesher
from test_torch_state import PKGS, scene_voxels
from test_torch_universe import _placer, _world

MOD = {"jax": (jmesh, jmesher, jatlas, jnative, jU), "torch": (tmesh, tmesher, tatlas, tnative, tU)}


def assert_mesh_equal(j, t, what=""):
    for k in ("positions", "colors", "indices", "uvs", "texture"):
        a, b = getattr(j, k), getattr(t, k)
        if a is None:
            assert b is None, (what, k)
            continue
        assert b.dtype == a.dtype, (what, k, b.dtype, a.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f"{what} {k}")
    assert t.opaque_range == j.opaque_range, what
    assert t.transparent_range == j.transparent_range, what


# -- scenes -------------------------------------------------------------------


def _checker_block(p, r=4):
    """test_mesh_atlas.py's checker block: red and blue voxels."""
    b = p.block
    vox = p.Space(p.GridAab.from_lower_size((0, 0, 0), (r, r, r)))
    red, blue = b.from_color((1.0, 0.0, 0.0, 1.0)), b.from_color((0.0, 0.0, 1.0, 1.0))
    for x in range(r):
        for y in range(r):
            for z in range(r):
                vox.set((x, y, z), red if (x + y + z) % 2 == 0 else blue)
    return b.Block(b.Recur(space=vox, resolution=r))


def _halves_block(p):
    """test_native.py's R4 block: a red and a blue half of one layer."""
    b = p.block
    inner = p.Space(p.GridAab.cube(4))
    red, blue = b.from_color((0.9, 0.1, 0.1, 1.0)), b.from_color((0.1, 0.1, 0.9, 1.0))
    for x in range(4):
        for z in range(4):
            inner.set((x, 0, z), red if x < 2 else blue)
    return b.Block(b.Recur(inner, resolution=4))


def _sparse_block(p):
    """test_native.py's R4 checker of solid voxels with air between."""
    b = p.block
    inner = p.Space(p.GridAab.cube(4))
    solid = b.from_color((0.5, 0.8, 0.3, 1.0))
    for x in range(4):
        for y in range(4):
            for z in range(4):
                if (x + y + z) % 2 == 0:
                    inner.set((x, y, z), solid)
    return b.Block(b.Recur(inner, resolution=4))


def scene_mixed12(p, seed=5):
    """12³ under a sky, numpy-seeded: a floor, opaque, transparent and
    emissive atoms, an R4 block with a transparent voxel and an R8 one."""
    b = p.block
    rng = np.random.default_rng(seed)
    sp = p.Space(p.GridAab.from_lower_size((-3, 0, -5), (12, 12, 12)),
                 physics=p.SpacePhysics(sky=p.Sky.uniform((0.4, 0.5, 0.6))))
    sp.fill(p.GridAab.from_lower_size((-3, 0, -5), (12, 1, 12)), b.from_color((0.5, 0.5, 0.5, 1.0)))
    colors = [(0.9, 0.2, 0.1, 1.0), (0.1, 0.8, 0.3, 0.4), (0.2, 0.3, 0.9, 1.0), (1.0, 1.0, 0.2, 0.7)]
    for i in range(70):
        cube = (int(rng.integers(-3, 9)), int(rng.integers(1, 12)), int(rng.integers(-5, 7)))
        sp.set(cube, b.from_color(colors[i % 4]))
    sp.set((2, 6, 1), b.Block(b.Atom(color=(0, 0, 0, 1.0), emission=(2.0, 1.0, 0.5))))
    inner = p.Space(p.GridAab.cube(4))
    inner.fill(p.GridAab.from_lower_size((0, 0, 0), (4, 2, 4)), b.from_color((0.9, 0.8, 0.1, 1.0)))
    inner.set((1, 3, 1), b.from_color((0.2, 0.3, 0.9, 0.5)))
    r4 = b.Block(b.Recur(inner, resolution=4))
    inner8 = p.Space(p.GridAab.cube(8))
    inner8.fill(p.GridAab.from_lower_size((0, 0, 0), (8, 4, 8)), b.from_color((1.0, 1.0, 0.0, 1.0)))
    inner8.set((3, 6, 3), b.from_color((1.0, 0.0, 1.0, 0.5)))
    r8 = b.Block(b.Recur(inner8, resolution=8))
    for i, cube in enumerate([(0, 1, 0), (4, 1, 3), (-2, 5, 2), (6, 9, -4)]):
        sp.set(cube, r4 if i % 2 == 0 else r8)
    return sp


def _one(p, size, cubes):
    sp = p.Space(p.GridAab.from_lower_size((0, 0, 0), size))
    for cube, blk in cubes:
        sp.set(cube, blk)
    return sp


def _build(name, p):
    b = p.block
    white, red = b.from_color((1, 1, 1, 1)), b.from_color((1, 0, 0, 1))
    if name == "empty":
        return p.Space(p.GridAab.from_lower_size((0, 0, 0), (2, 2, 2)))
    if name == "one cube":
        return _one(p, (1, 1, 1), [((0, 0, 0), white)])
    if name == "two cubes":
        return _one(p, (2, 1, 1), [((0, 0, 0), white), ((1, 0, 0), white)])
    if name == "opaque + transparent":
        return _one(p, (3, 1, 1), [((0, 0, 0), white), ((2, 0, 0), b.from_color((0.2, 0.4, 1.0, 0.5)))])
    if name == "atom alpha":
        return _one(p, (4, 4, 4), [((0, 0, 0), red), ((2, 0, 0), b.Block(b.Atom(color=(0, 0, 1, 0.5))))])
    if name == "single block":
        return _one(p, (3, 3, 3), [((1, 1, 1), red)])
    if name in ("buried", "slab", "floor12"):
        n, h = {"buried": (3, 3), "slab": (4, 2), "floor12": (12, 1)}[name]
        sp = p.Space(p.GridAab.cube(n))
        sp.fill(p.GridAab.from_lower_size((0, 0, 0), (n, h, n)), b.from_color((0.6, 0.6, 0.6, 1.0)))
        return sp
    if name == "random8":  # test_native.py's native-mesher scene
        rng = np.random.default_rng(3)
        sp = p.Space(p.GridAab.cube(8))
        blocks = [b.from_color((1, 0, 0, 1)), b.from_color((0, 1, 0, 1)), b.from_color((0, 0.5, 1, 0.5))]
        for _ in range(60):
            sp.set(tuple(int(v) for v in rng.integers(0, 8, 3)), blocks[int(rng.integers(0, 3))])
        return sp
    if name == "voxel detail":
        return _one(p, (4, 4, 4), [((1, 1, 1), _sparse_block(p)), ((2, 1, 1), white)])
    if name in ("checker4", "checker8"):
        return _one(p, (1, 1, 1), [((0, 0, 0), _checker_block(p, int(name[-1])))])
    if name == "cornell-box 8":
        return p.cornell_box(8)
    if name == "mixed 12^3":
        return scene_mixed12(p)
    if name == "voxels 20^3":
        return scene_voxels(p)
    if name == "atrium":
        return p.atrium()
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def spaces(name):
    """Both packages' Space of a scene, built once per module (meshing
    reads a Space and never writes it)."""
    return _build(name, PKGS["jax"]), _build(name, PKGS["torch"])


SCENES = ["empty", "one cube", "two cubes", "opaque + transparent", "atom alpha", "single block", "buried", "slab",
          "floor12", "random8", "voxel detail", "checker4", "cornell-box 8", "mixed 12^3", "voxels 20^3"]
VOXEL_SCENES = ["voxel detail", "checker4", "checker8", "mixed 12^3", "voxels 20^3"]


# -- 1. the edit journal --------------------------------------------------------


def _journal_script(pkg):
    """Sets, fills, a committed transaction and a burst of sets past the
    journal's 4,096-entry limit; the journal drained after each."""
    p = PKGS[pkg]
    U = MOD[pkg][4]
    b = p.block
    rng = np.random.default_rng(11)
    sp = p.Space(p.GridAab.from_lower_size((-2, 0, -2), (20, 18, 20)))
    drains = [sp.drain_edits()]
    red, green = b.from_color((0.9, 0.1, 0.1, 1.0), "red"), b.from_color((0.1, 0.9, 0.1, 1.0), "green")
    for _ in range(40):
        sp.set((int(rng.integers(-2, 18)), int(rng.integers(0, 18)), int(rng.integers(-2, 18))),
               red if rng.random() < 0.5 else green)
    sp.set((0, 0, 0), b.AIR)  # no change: no entry
    drains.append(sp.drain_edits())
    drains.append(sp.drain_edits())  # drained: empty
    txn = U.SpaceTransaction.set_cube((1, 2, 3), old=sp.block_at((1, 2, 3)), new=red)
    txn = txn.merge(U.SpaceTransaction.set_cube((4, 4, 4), old=sp.block_at((4, 4, 4)), new=green))
    txn.execute(sp)
    drains.append(sp.drain_edits())
    sp.fill(p.GridAab.from_lower_size((0, 0, 0), (3, 3, 3)), red)
    sp.set((5, 5, 5), green)
    drains.append(sp.drain_edits())
    for i in range(4200):
        sp.set((i % 20 - 2, (i // 20) % 18, (i // 360) - 2), red if (i // 7) % 2 else green)
    drains.append(sp.drain_edits())
    sp.set((0, 17, 0), red)
    drains.append(sp.drain_edits())
    return drains


def test_drain_edits_matches_aic_tpu():
    j, t = _journal_script("jax"), _journal_script("torch")
    assert t == j
    assert j[3] == {(3, 2, 5), (6, 4, 6)} and j[4] == "all" and j[5] == "all"


def test_become_remap_writes_no_journal_in_either_package():
    """The device tick's palette remap (`_apply_plan_host`) rewrites the
    host contents of the Become cubes without a journal entry, in both
    packages; the placer behavior's committed transactions are journaled
    in both."""
    out = {}
    for pkg in ("jax", "torch"):
        U = MOD[pkg][4]
        u = U.Universe(device="cpu") if pkg == "torch" else U.Universe()
        u.insert_space("world", _world(pkg, period=1))
        u.add_behavior("world", _placer(pkg, every=2))
        u.light_rounds_per_tick = 0
        sp = u.spaces["world"]
        log = [sp.drain_edits()]
        remapped = 0
        for _ in range(6):
            before = sp.contents.copy()
            u.step()
            edits = sp.drain_edits()
            changed = {tuple(int(v) for v in c) for c in np.argwhere(before != sp.contents)}
            remapped += len(changed - set(edits))
            log.append(edits)
        out[pkg] = (log, remapped)
    assert out["torch"] == out["jax"]
    log, remapped = out["jax"]
    assert remapped == 12  # both Become cubes, every tick
    assert (3, 1, 3) in log[1] and (4, 2, 4) not in set().union(*log[1:])


# -- 2. the native components ----------------------------------------------------


def _l_mask():
    """test_native.py's plane: an L of id 1 and a 2x2 of id 2."""
    mask = np.zeros((8, 8), bool)
    ids = np.zeros((8, 8), np.uint16)
    mask[1:6, 1:3] = True
    ids[1:6, 1:3] = 1
    mask[1:3, 3:6] = True
    ids[1:3, 3:6] = 1
    mask[5:7, 5:7] = True
    ids[5:7, 5:7] = 2
    return mask, ids


def _planes():
    rng = np.random.default_rng(2)
    out = [_l_mask(), (np.ones((16, 16), bool), np.ones((16, 16), np.uint16)),
           (np.zeros((5, 3), bool), np.zeros((5, 3), np.uint16))]
    for shape, p, k in (((9, 7), 0.6, 3), ((1, 12), 0.8, 2), ((13, 11), 0.9, 1), ((16, 16), 0.5, 4)):
        out.append((rng.random(shape) < p, rng.integers(0, k, shape).astype(np.uint16)))
    return out


@pytest.mark.parametrize("case", range(7))
def test_triangulate_plane_matches_aic_tpu_and_plain(case):
    mask, ids = _planes()[case]
    j = jnative.triangulate_plane(mask, ids)
    t = tnative.triangulate_plane(mask, ids)
    plain = tnative._triangulate_py(mask.astype(np.uint8), ids)
    for a, b, c in zip(j, t, plain):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, b)


@pytest.mark.parametrize("name", ["random8", "mixed 12^3", "cornell-box 8", "opaque + transparent"])
def test_mesh_space_greedy_matches_aic_tpu_and_plain(name):
    js, ts = spaces(name)
    tables = []
    for sp in (js, ts):
        n = sp.palette_len()
        tables.append((
            np.array([sp.evaluated(i).visible_or_animated() for i in range(n)], np.uint8),
            np.stack([sp.evaluated(i).opaque for i in range(n)]).astype(np.uint8),
            np.stack([sp.evaluated(i).face_colors for i in range(n)]),
        ))
    j_rows = jnative.mesh_space_greedy(js.contents, *tables[0][:2])
    t_rows = tnative.mesh_space_greedy(ts.contents, *tables[1][:2])
    np.testing.assert_array_equal(t_rows, j_rows)
    # The native path's mesh equals the plain greedy loop's.
    lower = np.asarray(ts.bounds.lower, np.float32)
    native = tmesher._mesh_arrays_native(ts.contents, *tables[1], lower)
    plain = tmesher._mesh_arrays(ts.contents, tmesh.visible_faces(ts), tables[1][2], lower, True)
    for k in ("positions", "colors"):
        np.testing.assert_array_equal(getattr(native, k), getattr(plain, k))
    np.testing.assert_array_equal(native.indices.astype(np.uint32), plain.indices)
    assert (native.opaque_range, native.transparent_range) == (plain.opaque_range, plain.transparent_range)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s output; nothing
    falls back."""
    (tmp_path / "triangulate.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "HERE", tmp_path)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_LIBS", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on triangulate.cpp"):
        tnative.triangulate_plane(*_l_mask())
    assert not list((tmp_path / "_build").glob("*.so"))


def test_native_builds_under_the_port():
    for name in ("triangulate", "space_mesher", "ref_relight"):
        tnative.load(name)
        path = tnative.library_path(name)
        assert path.exists() and path.parent.name == "_build" and path.parent.parent.name == "aic_tpu_torch"


# -- 3. the mesher ----------------------------------------------------------------


@pytest.mark.parametrize("name", SCENES)
def test_mesh_space_matches_aic_tpu(name):
    js, ts = spaces(name)
    np.testing.assert_array_equal(tmesh.visible_faces(ts), jmesh.visible_faces(js))
    for kw in ({}, {"greedy": False}, {"style": "unit"}, {"style": "no_t_junction"}):
        assert_mesh_equal(jmesh.mesh_space(js, **kw), tmesh.mesh_space(ts, **kw), f"{name} {kw}")


@pytest.mark.parametrize("name", VOXEL_SCENES + ["cornell-box 8", "opaque + transparent"])
def test_voxel_detail_and_textured_match_aic_tpu(name):
    js, ts = spaces(name)
    for style in ("no_t_junction", "greedy", "unit"):
        assert_mesh_equal(jmesh.mesh_space_voxel_detail(js, style=style),
                          tmesh.mesh_space_voxel_detail(ts, style=style), f"{name} voxel detail {style}")
    assert_mesh_equal(jmesh.mesh_space_textured(js), tmesh.mesh_space_textured(ts), f"{name} textured")


def test_depth_sort_and_block_meshes_match_aic_tpu():
    for name in ("opaque + transparent", "mixed 12^3"):
        js, ts = spaces(name)
        j, t = jmesh.mesh_space(js, greedy=False), tmesh.mesh_space(ts, greedy=False)
        j.depth_sort_for_view((10.0, 5.0, 5.0))
        t.depth_sort_for_view((10.0, 5.0, 5.0))
        assert_mesh_equal(j, t, f"{name} depth sorted")
    for make in (_halves_block, _sparse_block, _checker_block):
        jb, tb = (make(PKGS[k]) for k in ("jax", "torch"))
        jev, tev = PKGS["jax"].block.evaluate(jb), PKGS["torch"].block.evaluate(tb)
        assert_mesh_equal(jmesh.block_mesh(jev), tmesh.block_mesh(tev), make.__name__)
        ja, ta = jatlas.PlaneAtlas(), tatlas.PlaneAtlas()
        for a, b in zip(jatlas.block_mesh_textured(jev, ja), tatlas.block_mesh_textured(tev, ta)):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        for a, b in zip(ja.pack(), ta.pack()):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


# -- 4. the atlas -----------------------------------------------------------------


def test_plane_atlas_pack_matches_aic_tpu():
    rng = np.random.default_rng(0)
    planes = [rng.integers(0, 255, (h, w, 4), dtype=np.uint8) for h, w in [(4, 4), (8, 8), (2, 2), (16, 16), (4, 8)]]
    ja, ta = jatlas.PlaneAtlas(), tatlas.PlaneAtlas()
    ids = [(ja.add_plane(pl), ta.add_plane(pl)) for pl in planes + planes[:2]]
    assert [t for _, t in ids] == [j for j, _ in ids]
    for a, b in zip(ja.pack(), ta.pack()):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    uv = np.array([[2.5, 3.5], [0.0, 7.0]], np.float32)
    image, origins, _ = ta.pack()
    np.testing.assert_array_equal(tatlas.resolve_uvs(uv, np.array([1, 3]), origins, image.shape),
                                  jatlas.resolve_uvs(uv, np.array([1, 3]), origins, image.shape))
    np.testing.assert_array_equal(tatlas.white_uv(image.shape), jatlas.white_uv(image.shape))
    lin = rng.random((5, 7, 4)).astype(np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(tatlas.srgb8_from_linear(lin), jatlas.srgb8_from_linear(lin))


@pytest.mark.parametrize("name", ["checker8", "atrium"])
def test_textured_atlas_matches_aic_tpu(name):
    js, ts = spaces(name)
    j, t = jmesh.mesh_space_textured(js), tmesh.mesh_space_textured(ts)
    assert j.texture.shape[0] > 1
    assert_mesh_equal(j, t, name)


# -- 5. the chunked mesh ----------------------------------------------------------


def _floor(p, n):
    sp = p.Space(p.GridAab.cube(n))
    sp.fill(p.GridAab.from_lower_size((0, 0, 0), (n, 1, n)), p.block.from_color((0.5, 0.5, 0.5, 1.0)))
    return sp


def assert_csm_equal(j, t, what):
    assert list(t.meshes) == list(j.meshes), what
    assert t.dirty == j.dirty, what
    for c in j.meshes:
        assert_mesh_equal(j.meshes[c], t.meshes[c], f"{what} chunk {c}")


def _csm_pair(p_space):
    js, ts = p_space(PKGS["jax"]), p_space(PKGS["torch"])
    return js, ts, jmesh.ChunkedSpaceMesh(js), tmesh.ChunkedSpaceMesh(ts)


def test_chunked_mesh_budgeted_update_matches_aic_tpu():
    """TestChunkedMesh's cases: a budgeted first update near to far, an
    update to convergence, then an edit that dirties its neighbours."""
    js, ts, j, t = _csm_pair(lambda p: _floor(p, 40))
    ij, it = j.update(view_position=(1, 1, 1), budget_chunks=4), t.update(view_position=(1, 1, 1), budget_chunks=4)
    assert dataclasses.astuple(it) == dataclasses.astuple(ij) and ij.chunks_updated == 4
    assert_csm_equal(j, t, "first update")
    while j.update((0, 0, 0), budget_chunks=64).chunks_remaining:
        pass
    while t.update((0, 0, 0), budget_chunks=64).chunks_remaining:
        pass
    assert_csm_equal(j, t, "converged")
    assert_mesh_equal(j.combined(), t.combined(), "combined")
    js.set((20, 0, 20), PKGS["jax"].block.AIR)  # the middle chunk
    ts.set((20, 0, 20), PKGS["torch"].block.AIR)
    j.absorb_edits()
    t.absorb_edits()
    assert t.dirty == j.dirty and 1 <= len(j.dirty) <= 7
    it, ij = t.update((0, 0, 0), budget_chunks=64), j.update((0, 0, 0), budget_chunks=64)
    assert dataclasses.astuple(it) == dataclasses.astuple(ij)
    assert_csm_equal(j, t, "after the edit")
    assert_mesh_equal(j.combined(), t.combined(), "combined after the edit")


def test_chunked_mesh_edits_and_views_match_aic_tpu():
    """The mixed scene, chunk size 4, seeded edits (sets, a committed
    transaction, a fill) between updates of budget 3 from moving views;
    each update re-meshes the same chunks in the same order."""
    out = {}
    for pkg in ("jax", "torch"):
        p, (mesh, _m, _a, _n, U) = PKGS[pkg], MOD[pkg]
        sp = scene_mixed12(p)
        csm = mesh.ChunkedSpaceMesh(sp, chunk_size=4)
        rng = np.random.default_rng(4)
        blocks = [p.block.AIR, p.block.from_color((0.3, 0.9, 0.9, 1.0)), p.block.from_color((0.9, 0.3, 0.9, 0.5))]
        trace = []
        for step in range(12):
            for _ in range(int(rng.integers(0, 4))):
                cube = (int(rng.integers(-3, 9)), int(rng.integers(0, 12)), int(rng.integers(-5, 7)))
                sp.set(cube, blocks[int(rng.integers(0, 3))])
            if step == 5:
                U.SpaceTransaction.set_cube((0, 11, 0), old=sp.block_at((0, 11, 0)), new=blocks[1]).execute(sp)
            if step == 8:
                sp.fill(p.GridAab.from_lower_size((4, 8, 3), (2, 2, 2)), blocks[2])
            view = tuple(float(v) for v in rng.uniform(-3, 9, 3))
            before = {c: id(m) for c, m in csm.meshes.items()}
            info = csm.update(view, budget_chunks=3)
            remeshed = [c for c, m in csm.meshes.items() if before.get(c) != id(m)]
            trace.append((dataclasses.astuple(info), remeshed, sorted(csm.dirty)))
        out[pkg] = (trace, csm)
    assert [t[:2] for t in out["torch"][0]] == [t[:2] for t in out["jax"][0]]
    assert [t[2] for t in out["torch"][0]] == [t[2] for t in out["jax"][0]]
    assert_csm_equal(out["jax"][1], out["torch"][1], "after 12 updates")
    assert_mesh_equal(out["jax"][1].combined(), out["torch"][1].combined(), "combined")


def test_chunked_mesh_executor_matches_aic_tpu():
    js, ts, j, t = _csm_pair(lambda p: _floor(p, 33))
    with ThreadPoolExecutor(4) as ex:
        while j.update((0, 0, 0), budget_chunks=16, executor=ex).chunks_remaining:
            pass
        while t.update((0, 0, 0), budget_chunks=16, executor=ex).chunks_remaining:
            pass
    assert_csm_equal(j, t, "executor")
    assert_mesh_equal(j.combined(), t.combined(), "combined")
    whole = tmesh.mesh_space(ts, greedy=False)
    area = [float(np.linalg.norm(np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=1).sum() / 2.0)
            for v in (m.positions[m.indices.reshape(-1, 3)] for m in (t.combined(), whole))]
    assert abs(area[0] - area[1]) < 1e-3
