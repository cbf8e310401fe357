"""The port's content (aic_tpu_torch.content, space.drawing, math.chunking,
universe.cursor, vui.widgets, Space.extract/absorb/distinct_blocks)
against `aic_tpu`.

Every template of `aic_tpu` but `menu` (which tests/test_torch_vui.py
holds) and `demo-city` (tests/test_torch_city.py), and every exhibit's standalone space, is
built at its default size by each package's own content code: the
spaces must be equal — contents, light and dirty marks after the fast
light seed, the spawn point, the palette in the same order with each
entry evaluated the same, and the snapshot field for field. The port
builds them with PIL unusable, so its text masks come from the vendored
table alone. The R128 "Smallest" exhibit is held by its contents only: the
port's kernels refuse R128 (ROADMAP A8), and its snapshot pads a 128³
voxel table.
"""

import numpy as np
import pytest

import aic_tpu.content as jc
import aic_tpu.universe as jU
import aic_tpu_torch.content as tc
import aic_tpu_torch.universe as tU
from aic_tpu.content import exhibits as jex
from aic_tpu_torch.content import exhibits as tex
from aic_tpu_torch.text import font as tfont
from test_torch_state import PKGS, jax_fields, fresh_pallas_caches  # noqa: F401 (autouse)

TEMPLATES = [n for n in jc.TEMPLATE_NAMES if n not in ("menu", "demo-city", "fail")]
EXHIBITS = [e.name for e in jex.EXHIBITS]


@pytest.fixture
def table_only(monkeypatch):
    """The port cannot draw text with PIL: every mask from its table."""

    def refuse(text):
        raise AssertionError(f"the port drew {text!r} with PIL")

    monkeypatch.setattr(tfont, "rasterize_pil", refuse)
    tfont.rasterize_text.cache_clear()
    yield
    tfont.rasterize_text.cache_clear()


def _attrs(ev):
    a = ev.attributes
    return (a.display_name, a.animated, a.tick_period, a.selectable,
            type(a.tick_action).__name__, type(a.activation_action).__name__)


def assert_evaluated_equal(jev, tev, what):
    assert tev.resolution == jev.resolution, what
    for k in ("color", "face_colors", "light_emission", "opaque"):
        np.testing.assert_array_equal(np.asarray(getattr(tev, k)), np.asarray(getattr(jev, k)), err_msg=f"{what} {k}")
    for k in ("color", "emission", "collision", "selectable"):
        np.testing.assert_array_equal(getattr(tev.voxels, k), getattr(jev.voxels, k), err_msg=f"{what} voxels.{k}")
    assert (tev.visible, tev.uniform_collision) == (jev.visible, jev.uniform_collision), what
    assert _attrs(tev) == _attrs(jev), what


def assert_spaces_equal(js, ts, snapshot=True, palette=True):
    assert (tuple(ts.bounds.lower), tuple(ts.bounds.upper)) == (tuple(js.bounds.lower), tuple(js.bounds.upper))
    np.testing.assert_array_equal(ts.contents, js.contents)
    np.testing.assert_array_equal(ts.light, js.light)
    np.testing.assert_array_equal(ts.light_dirty, js.light_dirty)
    if js.spawn_position is None:
        assert ts.spawn_position is None
    else:
        np.testing.assert_array_equal(np.asarray(ts.spawn_position), np.asarray(js.spawn_position))
    if not palette:
        return
    assert ts.palette_len() == js.palette_len()
    for i in range(js.palette_len()):
        assert_evaluated_equal(js.evaluated(i), ts.evaluated(i), f"palette entry {i}")
    if snapshot:
        fields, static = jax_fields(js.snapshot())
        got = ts.snapshot(device="cpu")
        assert (got.lower, got.light_max_distance, got.light_enabled) == (
            static["lower"], static["light_max_distance"], static["light_enabled"])
        for k, want in fields.items():
            g = getattr(got, k) if hasattr(got, k) else getattr(got.tables, k)
            np.testing.assert_array_equal(g.numpy(), want.astype(g.numpy().dtype), err_msg=k)


def test_template_names_follow_aic_tpu():
    """`aic_tpu`'s order, `menu` included, with the port's `plaza640`
    before `fail`."""
    want = list(jc.TEMPLATE_NAMES)
    want.insert(want.index("fail"), "plaza640")
    assert tc.TEMPLATE_NAMES == want


@pytest.mark.parametrize("name", TEMPLATES)
def test_template_space_matches_aic_tpu(table_only, name):
    js = jc.build_template_space(name, jc.TemplateParameters())
    ts = tc.build_template_space(name, tc.TemplateParameters())
    assert_spaces_equal(js, ts)


def test_template_seed_and_size_follow_params(table_only):
    js = jc.build_template_space("random", jc.TemplateParameters(seed=7, size=12))
    ts = tc.build_template_space("random", tc.TemplateParameters(seed=7, size=12))
    assert_spaces_equal(js, ts)


def test_fail_raises_in_both():
    with pytest.raises(RuntimeError, match="intentional"):
        jc.build_template_space("fail")
    with pytest.raises(RuntimeError, match="intentional"):
        tc.build_template_space("fail")
    with pytest.raises(KeyError):
        tc.build_template_space("no-such-template")


@pytest.mark.parametrize("name", EXHIBITS)
def test_exhibit_space_matches_aic_tpu(table_only, name):
    je = next(e for e in jex.EXHIBITS if e.name == name)
    te = next(e for e in tex.EXHIBITS if e.name == name)
    assert (te.subtitle, te.heavy) == (je.subtitle, je.heavy)
    js, ts = je.factory(), te.factory()
    assert_spaces_equal(js, ts, snapshot=not je.heavy, palette=not je.heavy)


def test_place_exhibit_matches_aic_tpu(table_only):
    """An exhibit copied onto a pedestal with its name sign."""
    pj, pt = PKGS["jax"], PKGS["torch"]
    out = []
    for p, ex in ((pj, jex), (pt, tex)):
        sp = p.Space(p.GridAab.from_lower_size((0, 0, 0), (12, 6, 8)))
        e = next(e for e in ex.EXHIBITS if e.name == "Transparency")
        ex.place_exhibit(sp, e, (1, 0, 2), p.block.from_color((0.4, 0.4, 0.4, 1.0), "pedestal"))
        out.append(sp)
    assert_spaces_equal(*out, snapshot=True)


# -- math.chunking, content.alg, space.drawing, content.testing -----------------


@pytest.mark.parametrize("view", [0.0, 1.5, 16 * 4.99, 40.0])
def test_chunk_chart_matches_aic_tpu(view):
    from aic_tpu.math import chunking as jch
    from aic_tpu_torch.math import chunking as tch

    jcc, tcc = jch.ChunkChart(view, chunk_size=16), tch.ChunkChart(view, chunk_size=16)
    np.testing.assert_array_equal(tcc.chunks(), jcc.chunks())
    assert tcc.count_all() == jcc.count_all()
    for mask in (0x01, 0x0F, 0xA5):
        np.testing.assert_array_equal(tcc.chunks((3, -1, 2), mask=mask), jcc.chunks((3, -1, 2), mask=mask))
    np.testing.assert_array_equal(np.asarray(list(tch.chunks_near((1, 0, -2), 37.0))),
                                  np.asarray(list(jch.chunks_near((1, 0, -2), 37.0))))
    np.testing.assert_array_equal(tch.point_to_chunk((17.5, -0.5, 33.0)), jch.point_to_chunk((17.5, -0.5, 33.0)))


def test_octant_masks_match_aic_tpu():
    from aic_tpu.math import octant as jo
    from aic_tpu_torch.math import octant as to

    rng = np.random.default_rng(3)
    for v in rng.normal(size=(16, 3)):
        assert to.octant_from_vector(v) == jo.octant_from_vector(v)
    for mask in (0, 1, 0x5A, 0xFF):
        for face in range(6):
            assert to.mask_shift(mask, face) == jo.mask_shift(mask, face)
        np.testing.assert_array_equal(to.mask_octants(mask), jo.mask_octants(mask))
    dirs = rng.normal(size=(4, 3))
    assert to.view_direction_mask(dirs) == jo.view_direction_mask(dirs)


def test_alg_matches_aic_tpu(table_only):
    from aic_tpu.content import alg as ja
    from aic_tpu_torch.content import alg as ta

    rng = np.random.default_rng(5)
    pts = [(tuple(p), i % 3) for i, p in enumerate(rng.random((9, 3)))]
    for wrap in (True, False):
        np.testing.assert_array_equal(ta.voronoi_pattern(8, pts, wrap=wrap), ja.voronoi_pattern(8, pts, wrap=wrap))
    pj, pt = PKGS["jax"], PKGS["torch"]
    bounds = ((-2, 0, 1), (7, 3, 5))
    assert ta.four_walls(pt.GridAab.from_lower_size(*bounds)) == ja.four_walls(pj.GridAab.from_lower_size(*bounds))
    spaces = []
    for p, a in ((pj, ja), (pt, ta)):
        sp = p.Space(p.GridAab.from_lower_size((0, 0, 0), (14, 16, 14)))
        a.make_tree(sp, (4, 0, 4), height=6, rng=np.random.default_rng(1))
        a.make_tree(sp, (10, 2, 9), height=3)
        a.clouds(sp, p.GridAab.from_lower_size((0, 12, 0), (14, 2, 14)), density=0.3, seed=4)
        src = p.Space(p.GridAab.from_lower_size((0, 0, 0), (3, 2, 3)))
        src.set((1, 1, 1), p.block.from_color((0.2, 0.3, 0.9, 1.0), "copied"))
        a.space_to_space_copy(src, src.bounds, sp, (10, 8, 1))
        spaces.append(sp)
    assert_spaces_equal(*spaces)
    img = (rng.random((8, 8, 4)) * 255).astype(np.uint8)
    img[..., 3][img[..., 3] < 60] = 0
    for rot in (0, 5, 17, 40):
        assert_spaces_equal(ja.space_from_image(img, rot), ta.space_from_image(img, rot))
    jb = ja.block_from_image(img, 3, display_name="img")
    tb = ta.block_from_image(img, 3, display_name="img")
    assert_evaluated_equal(pj.block.evaluate(jb), pt.block.evaluate(tb), "block_from_image")
    gray = pt.block.from_color((0.5, 0.4, 0.3, 1.0))
    assert ta.scale_color(gray, 1.7).primitive.color == ja.scale_color(
        pj.block.from_color((0.5, 0.4, 0.3, 1.0)), 1.7).primitive.color


def test_drawing_matches_aic_tpu(table_only):
    from aic_tpu.space import drawing as jd
    from aic_tpu_torch.space import drawing as td

    spaces = []
    for p, d in ((PKGS["jax"], jd), (PKGS["torch"], td)):
        sp = p.Space(p.GridAab.from_lower_size((-2, 0, -1), (12, 9, 4)))
        red = p.block.from_color((0.9, 0.1, 0.1, 1.0), "red")
        brush = d.VoxelBrush.column(red, 2).translated((0, 0, 1))
        n = d.draw_points(sp, d.VoxelBrush.single(red), [(0, 0, 0), (9, 8, 2), (20, 0, 0)])
        n += d.draw_rect(sp, brush, (-2, 1), (8, 5), plane_z=0)
        n += d.draw_text_line(sp, "OK", (1, 7, 2), color=(0.2, 0.9, 0.3, 1.0))
        spaces.append((sp, n))
    assert spaces[0][1] == spaces[1][1]
    assert_spaces_equal(spaces[0][0], spaces[1][0])


def test_ref_rng_and_test_blocks_match_aic_tpu(table_only):
    from aic_tpu.content import testing as jt
    from aic_tpu_torch.content import testing as tt

    a, b = jt.RefRng(0x1234_5678_9ABC), tt.RefRng(0x1234_5678_9ABC)
    for _ in range(40):
        assert b.next_u64() == a.next_u64()
        assert b.random_f32_01_inclusive() == a.random_f32_01_inclusive()
        assert b.random_bool(0.3) == a.random_bool(0.3)
        assert b.random_range_u32(7) == a.random_range_u32(7)
    pj, pt = PKGS["jax"], PKGS["torch"]
    for jbl, tbl in ((jt.make_some_blocks(4), tt.make_some_blocks(4)),
                     (jt.make_some_voxel_blocks(3), tt.make_some_voxel_blocks(3))):
        for i, (jb, tb) in enumerate(zip(jbl, tbl)):
            assert_evaluated_equal(pj.block.evaluate(jb), pt.block.evaluate(tb), f"block {i}")
    assert_spaces_equal(jt.light_bench_space((24, 10, 24)), tt.light_bench_space((24, 10, 24)))


def test_menger_sponge_levels_match_aic_tpu():
    from aic_tpu.content.fractal import menger_sponge as jm
    from aic_tpu_torch.content.fractal import menger_sponge as tm

    assert_spaces_equal(jm(2, 1, (0.3, 0.5, 0.7, 1.0)), tm(2, 1, (0.3, 0.5, 0.7, 1.0)))


def test_demo_blocks_and_heightfield_match_aic_tpu():
    from aic_tpu.content.landscape import demo_blocks as jdb
    from aic_tpu.content.landscape import heightfield as jh
    from aic_tpu_torch.content.landscape import demo_blocks as tdb
    from aic_tpu_torch.content.landscape import heightfield as th

    jb, tb = jdb(3, 4), tdb(3, 4)
    assert list(tb) == list(jb)
    for k in jb:
        assert_evaluated_equal(PKGS["jax"].block.evaluate(jb[k]), PKGS["torch"].block.evaluate(tb[k]), k)
    np.testing.assert_array_equal(th((20, 12), 9, 3.0), jh((20, 12), 9, 3.0))


def test_block_provider_matches_aic_tpu():
    from aic_tpu.content.linking import BlockProvider as JP
    from aic_tpu.content.linking import ProviderError as JErr
    from aic_tpu_torch.content.linking import BlockProvider as TP
    from aic_tpu_torch.content.linking import ProviderError as TErr

    out = []
    for p, P, Err, U in ((PKGS["jax"], JP, JErr, jU), (PKGS["torch"], TP, TErr, tU)):
        u = U.Universe(device="cpu") if U is tU else U.Universe()
        prov = P.new("demo", lambda k, p=p: p.block.from_color((len(k) / 8, 0.5, 0.5, 1.0), k), ["ab", "cdef"])
        inst = prov.install(u)
        again = P.using(u, "demo", ["ab", "cdef"])
        with pytest.raises(Err) as e:
            P.using(u, "demo", ["ab", "zz", "yy"])
        assert e.value.missing == ("demo/zz", "demo/yy")
        ev = [p.block.evaluate(inst[k]) for k in ("ab", "cdef")] + [p.block.evaluate(again["cdef"])]
        out.append((sorted(u.block_defs), ev))
    assert out[0][0] == out[1][0] == ["demo/ab", "demo/cdef"]
    for i, (a, b) in enumerate(zip(out[0][1], out[1][1])):
        assert_evaluated_equal(a, b, f"provided block {i}")


# -- vui widgets ----------------------------------------------------------------


def test_widgets_match_aic_tpu(table_only):
    from aic_tpu import vui as jv
    from aic_tpu_torch import vui as tv

    spaces = []
    for p, v, U in ((PKGS["jax"], jv, jU), (PKGS["torch"], tv, tU)):
        sp = p.Space(p.GridAab.from_lower_size((0, 0, 0), (12, 8, 3)))
        v.Label("OK").draw(sp, (0, 0, 0))
        v.Frame(width=4, height=2).draw(sp, (0, 1, 0))
        v.Button(text="OK").draw(sp, (5, 1, 0))
        v.Crosshair().draw(sp, (10, 1, 0))
        v.ProgressBar(fraction=0.4, width=6).draw(sp, (0, 3, 0))
        inv = U.Inventory(slots=[U.PlaceBlock(p.block.from_color((0.8, 0.2, 0.2, 1.0), "red")),
                                 U.RemoveBlock(), U.Activate(), U.CopyFromSpace()], selected=1)
        v.Toolbar(inv, slots=6).draw(sp, (0, 5, 0))
        v.Tooltip(inv, width=8).draw(sp, (0, 6, 2))
        spaces.append(sp)
    assert_spaces_equal(*spaces)


# -- the tools, Space.extract / absorb / distinct_blocks ------------------------


def _tool_universes():
    out = []
    for p, U in ((PKGS["jax"], jU), (PKGS["torch"], tU)):
        b = p.block
        sp = p.Space(p.GridAab.from_lower_size((0, 0, 0), (8, 6, 8)),
                     physics=p.SpacePhysics(sky=p.Sky.uniform((0.5, 0.6, 0.8))))
        sp.fill(p.GridAab.from_lower_size((0, 0, 0), (8, 1, 8)), b.from_color((0.5, 0.5, 0.5, 1.0), "floor"))
        off = b.from_color((0.2, 0.2, 0.2, 1.0), "switch-off")
        on = b.from_color((0.9, 0.9, 0.2, 1.0), "switch-on")
        sp.set((5, 1, 5), off.with_attributes(activation_action=U.Become(on)))
        sp.set((2, 1, 2), b.from_color((0.1, 0.6, 0.9, 1.0), "crate"))
        u = U.Universe(device="cpu") if U is tU else U.Universe()
        u.insert_space("world", sp)
        u.insert_character("player", "world", (4.5, 3.0, 7.5))
        out.append((u, U, p))
    return out


def test_click_tools_match_aic_tpu():
    """`cursor_raycast` + `click` with PlaceBlock, RemoveBlock and
    Activate: the same cursors, edits, device contents and inventories."""
    clicks = [((2.5, 4.5, 2.5), (0, -1, 0), 0), ((5.5, 4.5, 5.5), (0, -1, 0), 1),
              ((6.5, 3.5, 3.5), (0, -1, 0), 0), ((2.5, 4.5, 2.5), (0, -1, 0), 0)]
    results = []
    for u, U, p in _tool_universes():
        ch = u.characters["player"]
        ch.inventory_obj = U.Inventory(slots=[U.RemoveBlock(), U.Stack(U.PlaceBlock(
            p.block.from_color((0.8, 0.3, 0.1, 1.0), "brick")), 2)])
        log = []
        for i, (origin, direction, button) in enumerate(clicks):
            ch.inventory_obj.selected = 1 if i == 2 else 0
            cur = U.cursor_raycast(u.spaces["world"], origin, direction)
            log.append((cur.cube, cur.face, round(cur.t_distance, 6), U.click(u, ch, cur, button=button)))
        slots = [(type(s).__name__, getattr(s, "count", None)) for s in ch.inventory_obj.slots]
        results.append((u, log, slots))
    (uj, lj, sj), (ut, lt, st) = results
    assert lt == lj and st == sj
    assert all(done for *_, done in lt)
    np.testing.assert_array_equal(ut.spaces["world"].contents, uj.spaces["world"].contents)
    np.testing.assert_array_equal(ut.states["world"].contents.numpy(), np.asarray(uj.states["world"].contents))
    assert ut.spaces["world"].block_at((5, 1, 5)).primitive.color == uj.spaces["world"].block_at((5, 1, 5)).primitive.color


def test_tool_icons_match_aic_tpu():
    from aic_tpu.universe.cursor import tool_icon as j_icon
    from aic_tpu_torch.universe.cursor import tool_icon as t_icon

    pj, pt = PKGS["jax"], PKGS["torch"]
    jr, tr = pj.block.from_color((0.8, 0.2, 0.2, 1.0), "red"), pt.block.from_color((0.8, 0.2, 0.2, 1.0), "red")
    assert_evaluated_equal(pj.block.evaluate(j_icon(jU.Stack(jU.PlaceBlock(jr), 3))),
                           pt.block.evaluate(t_icon(tU.Stack(tU.PlaceBlock(tr), 3))), "icon")
    assert t_icon(tU.Stack(tU.PlaceBlock(tr), 0)) is None is j_icon(jU.Stack(jU.PlaceBlock(jr), 0))
    assert t_icon(tU.RemoveBlock()) is None is j_icon(jU.RemoveBlock())


def test_extract_absorb_distinct_blocks_match_aic_tpu():
    spaces = []
    for p in (PKGS["jax"], PKGS["torch"]):
        sp = p.Space(p.GridAab.from_lower_size((-3, 0, -3), (9, 5, 9)),
                     physics=p.SpacePhysics(sky=p.Sky.uniform((0.5, 0.6, 0.8))))
        blocks = [p.block.from_color(c, f"b{i}") for i, c in enumerate(
            [(0.9, 0.1, 0.1, 1.0), (0.1, 0.9, 0.1, 1.0), (0.1, 0.1, 0.9, 0.5)])]
        rng = np.random.default_rng(11)
        for _ in range(40):
            sp.set(tuple(int(v) for v in rng.integers((-3, 0, -3), (6, 5, 6))), blocks[int(rng.integers(3))])
        sp.set((0, 0, 0), blocks[0])
        sp.set((0, 0, 0), p.block.AIR)
        sp.fast_evaluate_light()
        spaces.append(sp)
    js, ts = spaces
    jd, td = js.distinct_blocks(), ts.distinct_blocks()
    assert len(td) == len(jd) == 4  # air and the three colours
    for i, (a, b) in enumerate(zip(jd, td)):
        assert_evaluated_equal(PKGS["jax"].block.evaluate(a), PKGS["torch"].block.evaluate(b), f"distinct {i}")
    region = ((-1, 1, -2), (4, 3, 5))
    assert_spaces_equal(js.extract(PKGS["jax"].GridAab.from_lower_size(*region)),
                        ts.extract(PKGS["torch"].GridAab.from_lower_size(*region)))
    with pytest.raises(IndexError):
        ts.extract(PKGS["torch"].GridAab.from_lower_size((4, 0, 0), (4, 1, 1)))
    # absorb: a state edited on the device comes back into the host mirror.
    from aic_tpu_torch.space.state import scatter_set_cubes
    import torch

    st = ts.snapshot(device="cpu")
    edited = scatter_set_cubes(st, torch.tensor([[1, 1, 1]]), torch.tensor([0], dtype=torch.int32))
    js.absorb(PKGS["jax"].Space.snapshot(js))
    ts.absorb(edited)
    assert ts.contents.dtype == js.contents.dtype
    assert ts.contents[1, 1, 1] == 0
    np.testing.assert_array_equal(ts.contents, edited.contents.numpy())
    np.testing.assert_array_equal(ts.light_dirty, edited.light_dirty.numpy())
