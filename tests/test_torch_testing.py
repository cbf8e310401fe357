"""The port's test apparatus (aic_tpu_torch.testing) and PNG decoder
against `aic_tpu`'s and PIL.

- `imagecmp`: `diff_images`, `images_match`, `Threshold` and
  `compare_to_golden` give `aic_tpu`'s numbers on seeded image pairs
  (noise, one-pixel edge shifts, unrelated images), and read and record
  goldens as `aic_tpu`'s PIL path does.
- `raytrace.render.decode_png` equals PIL on every checked-in golden, on
  seeded images PIL saves in modes L, LA, RGB and RGBA, on rows filtered
  with each of PNG's five filters and on `encode_png`'s own output.
- `refmath`: both oracle functions equal `aic_tpu`'s bit for bit (f64)
  on seeded samples of a lit cornell-box 8 and a sky-lit scene.
- `txn_tester`: the port's `TransactionTester` gives the outcomes of
  `aic_tpu`'s on tests/test_txn_laws.py's cases and raises where
  `aic_tpu`'s raises on law-breaking transactions.
- The six public names `aic_tpu` has beside these modules.
"""

import glob
import io
import os
import struct
import sys
import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import aic_tpu.testing as jtesting  # noqa: E402
import aic_tpu.testing.refmath as jrefmath  # noqa: E402
import aic_tpu.testing.txn_tester as jtxn  # noqa: E402
import aic_tpu.universe as jU  # noqa: E402
import aic_tpu.universe.cursor as jcursor  # noqa: E402
import aic_tpu_torch.testing as ttesting  # noqa: E402
import aic_tpu_torch.testing.refmath as trefmath  # noqa: E402
import aic_tpu_torch.testing.txn_tester as ttxn  # noqa: E402
import aic_tpu_torch.universe as tU  # noqa: E402
import aic_tpu_torch.universe.cursor as tcursor  # noqa: E402
import chip_smoke  # noqa: E402
from aic_tpu_torch.raytrace.render import PNG_SIGNATURE, _png_chunk, decode_png, encode_png  # noqa: E402
from test_torch_state import PKGS  # noqa: E402

GOLDENS = Path(__file__).resolve().parent / "goldens"


# -- imagecmp ------------------------------------------------------------------


def _pair(kind, seed, channels):
    """A seeded image pair of one kind: noise, a one-pixel edge shift,
    two unrelated images, or equal images."""
    rng = np.random.default_rng(seed)
    h, w = 24, 32
    a = np.zeros((h, w, channels), np.uint8)
    a[:, : w // 2] = rng.integers(0, 256, channels)
    a[:, w // 2 :] = rng.integers(0, 256, channels)
    a[h // 3 : 2 * h // 3, w // 4 : 3 * w // 4] = rng.integers(0, 256, channels)
    if kind == "noise":
        b = np.clip(a.astype(np.int32) + rng.integers(-7, 8, a.shape), 0, 255).astype(np.uint8)
    elif kind == "shift":
        b = np.roll(a, (rng.integers(-1, 2), rng.integers(-1, 2)), axis=(0, 1))
        b[rng.integers(0, h), rng.integers(0, w)] = rng.integers(0, 256, channels)
    elif kind == "unrelated":
        b = rng.integers(0, 256, a.shape).astype(np.uint8)
    else:
        b = a.copy()
    return a, b


THRESHOLDS = [
    ("strict", lambda m: m.Threshold.strict()),
    ("default", lambda m: m.Threshold()),
    ("goldens", lambda m: m.Threshold(0.02, 6)),
    ("trace", lambda m: m.Threshold(0.001, 2)),
    ("loose", lambda m: m.Threshold(0.5, 40)),
]


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("kind", ["noise", "shift", "unrelated", "equal"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_diff_images_matches_aic_tpu(kind, seed, channels):
    a, b = _pair(kind, seed, channels)
    got, want = ttesting.diff_images(a, b), jtesting.diff_images(a, b)
    assert got.keys() == want.keys()
    assert (got["max_delta"], got["mean_delta"]) == (want["max_delta"], want["mean_delta"])
    np.testing.assert_array_equal(got["histogram"], want["histogram"])
    np.testing.assert_array_equal(got["deltas"], want["deltas"])
    for _, make in THRESHOLDS:
        assert ttesting.images_match(a, b, make(ttesting)) == jtesting.images_match(a, b, make(jtesting))


def test_threshold_matches_aic_tpu():
    for _, make in THRESHOLDS:
        t, j = make(ttesting), make(jtesting)
        assert (t.max_differing_fraction, t.delta) == (j.max_differing_fraction, j.delta)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
@pytest.mark.parametrize("channels", [3, 4])
def test_compare_to_golden_matches_aic_tpu(tmp_path, monkeypatch, mode, channels):
    """A golden in any of PIL's modes is read as `aic_tpu` converts it; a
    missing golden is recorded (the record decodes to the image) and then
    compared with the same result."""
    monkeypatch.delenv("AIC_RECORD_GOLDENS", raising=False)
    a, b = _pair("noise", 3, channels)
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    golden = _pair("shift", 4, 4)[0][..., :c]
    path = str(tmp_path / f"golden_{mode}.png")
    Image.fromarray(golden[..., 0] if c == 1 else golden, mode).save(path)
    for _, make in THRESHOLDS:
        assert ttesting.compare_to_golden(a, path, make(ttesting)) == \
            jtesting.compare_to_golden(a, path, make(jtesting))
    recorded = {}
    for name, m in (("torch", ttesting), ("jax", jtesting)):
        recorded[name] = str(tmp_path / name / "new.png")
        ok, msg = m.compare_to_golden(b, recorded[name])
        assert ok and msg == f"recorded golden {recorded[name]}"
        np.testing.assert_array_equal(decode_png(open(recorded[name], "rb").read()), b)
    for name in recorded:
        assert ttesting.compare_to_golden(a, recorded[name], ttesting.Threshold(0.02, 6)) == \
            jtesting.compare_to_golden(a, recorded[name], jtesting.Threshold(0.02, 6))


# -- decode_png ----------------------------------------------------------------


def _pil_array(data: bytes) -> np.ndarray:
    arr = np.asarray(Image.open(io.BytesIO(data)))
    return arr.reshape(arr.shape[:2] + (-1,))


@pytest.mark.parametrize("path", sorted(glob.glob(str(GOLDENS / "*.png")) + glob.glob(str(GOLDENS / "*" / "*.png"))),
                         ids=os.path.basename)
def test_decode_png_matches_pil_on_goldens(path):
    data = open(path, "rb").read()
    np.testing.assert_array_equal(decode_png(data), _pil_array(data))


def _seeded_image(seed, channels, h=29, w=41):
    """Smooth gradients with noise and flat patches: PIL's adaptive
    encoder picks varied row filters for it."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    img = (y[..., None] * rng.integers(1, 9, channels) + x[..., None] * rng.integers(1, 9, channels)
           + rng.integers(0, 6, (h, w, channels)))
    img[5:12, 8:30] = rng.integers(0, 256, channels)
    return (img % 256).astype(np.uint8)


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_decode_png_matches_pil_on_seeded_images(mode, optimize):
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    for seed in range(4):
        img = _seeded_image(seed, c)
        buf = io.BytesIO()
        Image.fromarray(img[..., 0] if c == 1 else img, mode).save(buf, "PNG", optimize=optimize)
        data = buf.getvalue()
        np.testing.assert_array_equal(decode_png(data), _pil_array(data))
        np.testing.assert_array_equal(decode_png(data), img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered_png(img: np.ndarray, kinds) -> bytes:
    """An RGBA PNG whose row y is filtered with `kinds[y]` (PNG
    specification, section 9), written by this test independently of the
    decoder."""
    h, w, c = img.shape
    x = img.astype(np.int32)
    raw = []
    for y in range(h):
        a = np.concatenate([np.zeros((1, c), np.int32), x[y, :-1]])
        b = x[y - 1] if y else np.zeros_like(x[y])
        cc = np.concatenate([np.zeros((1, c), np.int32), b[:-1]])
        pred = [0, a, b, (a + b) // 2, _paeth(a, b, cc)][kinds[y]]
        raw.append(bytes([kinds[y]]) + ((x[y] - pred) % 256).astype(np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr) + _png_chunk(b"IDAT", zlib.compress(b"".join(raw)))
            + _png_chunk(b"IEND", b""))


def test_decode_png_reads_every_row_filter():
    img = _seeded_image(7, 4, h=25, w=33)
    for kinds in ([k % 5 for k in range(25)], [4] * 25, [3] * 25, [1, 2] * 12 + [0]):
        data = _filtered_png(img, kinds)
        np.testing.assert_array_equal(_pil_array(data), img)
        np.testing.assert_array_equal(decode_png(data), img)
    with pytest.raises(ValueError):
        decode_png(PNG_SIGNATURE + _png_chunk(b"IEND", b""))
    bad = bytearray(zlib.decompress(_chunk_body(_filtered_png(img, [0] * 25), b"IDAT")))
    bad[0] = 5
    with pytest.raises(ValueError):
        decode_png(_replace_idat(_filtered_png(img, [0] * 25), zlib.compress(bytes(bad))))


def _chunk_body(png: bytes, kind: bytes) -> bytes:
    pos = 8
    while pos < len(png):
        n, k = struct.unpack(">I4s", png[pos : pos + 8])
        if k == kind:
            return png[pos + 8 : pos + 8 + n]
        pos += 12 + n
    raise KeyError(kind)


def _replace_idat(png: bytes, body: bytes) -> bytes:
    return PNG_SIGNATURE + _png_chunk(b"IHDR", _chunk_body(png, b"IHDR")) + _png_chunk(b"IDAT", body) + \
        _png_chunk(b"IEND", b"")


@pytest.mark.parametrize("channels", [3, 4])
def test_decode_png_reads_encode_png(channels):
    img = _seeded_image(11, channels)
    data = encode_png(img)
    np.testing.assert_array_equal(decode_png(data), img)
    np.testing.assert_array_equal(_pil_array(data), img)


# -- refmath -------------------------------------------------------------------


@pytest.fixture(scope="module")
def oracle_states():
    """The port's lit cornell-box 8 (its dense relight on the CPU) and the
    sky-lit scene of tests/test_render_goldens.py's transparency case, each
    with the same arrays as numpy for `aic_tpu`'s oracle."""
    from aic_tpu_torch.light import evaluate_light_dense

    p = PKGS["torch"]
    cornell, _ = evaluate_light_dense(p.cornell_box(8).snapshot(device="cpu"))
    sky_lit, _ = chip_smoke.golden_case("transparency_volumetric", "cpu")
    out = {}
    for name, st in (("cornell-box 8", cornell), ("sky-lit", sky_lit)):
        out[name] = (st, SimpleNamespace(light=st.light.numpy(), sky_faces=st.sky_faces.numpy()))
    return out


def _oracle_samples(state, seed, n=256):
    """Surface samples (`chip_smoke.surface_samples`) and as many anywhere
    in and one cube around the bounds, faces and points at random: the
    sky outside the faces, edges and corners (NO_RAYS) included."""
    cube, point, face = chip_smoke.surface_samples(state, n, seed)
    rng = np.random.default_rng(seed + 100)
    size = np.asarray(state.light.shape[:3])
    anywhere = rng.integers(-1, size + 1, (n, 3))
    spots = (anywhere + rng.random((n, 3))).astype(np.float32)
    return (np.concatenate([cube, anywhere]), np.concatenate([point, spots]),
            np.concatenate([face, rng.integers(0, 6, n)]))


@pytest.mark.parametrize("mode", ["linear", "smooth", "coarse"])
@pytest.mark.parametrize("scene", ["cornell-box 8", "sky-lit"])
def test_refmath_matches_aic_tpu_bit_for_bit(oracle_states, scene, mode):
    st, host = oracle_states[scene]
    cube, point, face = _oracle_samples(st, seed=len(scene) + len(mode))
    for c, p, f in zip(cube, point, face):
        got = trefmath.interpolated_light_oracle(st, c, p, int(f), mode)
        want = jrefmath.interpolated_light_oracle(host, c, p, int(f), mode)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    size = np.asarray(st.light.shape[:3])
    for c in np.random.default_rng(1).integers(-2, size + 2, (256, 3)):
        got, want = trefmath.packed_light_oracle(st, c), jrefmath.packed_light_oracle(host, c)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
    for mix in np.linspace(-0.25, 1.25, 31):
        assert trefmath._modifier(mix, mode) == jrefmath._modifier(mix, mode)


# -- txn_tester ----------------------------------------------------------------


def _law_suite(pkg, suite):
    """tests/test_txn_laws.py's three law suites with one package's
    blocks, spaces, universes and inventories, run by that package's
    tester."""
    p = PKGS[pkg]
    U, cursor, txn = (tU, tcursor, ttxn) if pkg == "torch" else (jU, jcursor, jtxn)
    red = p.block.from_color((0.9, 0.1, 0.1, 1.0), display_name="red")
    green = p.block.from_color((0.1, 0.9, 0.1, 1.0), display_name="green")
    blue = p.block.from_color((0.1, 0.1, 0.9, 1.0), display_name="blue")

    def space(with_red=True):
        sp = p.Space(p.GridAab.from_lower_size((0, 0, 0), (4, 4, 4)))
        if with_red:
            sp.set((0, 0, 0), red)
        return sp

    if suite == "space":
        def expects(cube, blk):
            def pred(before, after):
                assert after.block_at(cube) == blk

            return pred

        T = U.SpaceTransaction
        return (
            txn.TransactionTester()
            .transaction(T.set_cube((1, 1, 1), new=green), expects((1, 1, 1), green))
            .transaction(T.set_cube((2, 2, 2), new=blue, conserved=False), expects((2, 2, 2), blue))
            .transaction(T.set_cube((0, 0, 0), old=red, new=green), expects((0, 0, 0), green))
            .transaction(T.set_cube((1, 1, 1), new=blue), expects((1, 1, 1), blue))
            .transaction(T.emitting_fluff((3, 3, 3), "happened"), lambda before, after: None)
            .transaction(T.set_cube((99, 0, 0), new=green, conserved=False), lambda before, after: None)
            .target(space)
            .target(lambda: space(False))
        )
    if suite == "universe":
        def make_universe():
            u = U.Universe(device="cpu") if pkg == "torch" else U.Universe()
            u.insert_space("w", space())
            return u

        def world_has(cube, blk):
            def pred(before, after):
                assert after.spaces["w"].block_at(cube) == blk

            return pred

        def member_exists(before, after):
            assert "annex" in after.spaces

        return (
            txn.TransactionTester()
            .transaction(U.UniverseTransaction(spaces={"w": U.SpaceTransaction.set_cube((1, 0, 0), new=green)}),
                         world_has((1, 0, 0), green))
            .transaction(U.UniverseTransaction.inserting("annex", space(False)),
                         member_exists)
            .transaction(U.UniverseTransaction(spaces={"w": U.SpaceTransaction.set_cube((0, 0, 0), old=red,
                                                                                        new=blue)}),
                         world_has((0, 0, 0), blue))
            .target(make_universe)
        )

    def has_tool(kind):
        def pred(before, after):
            assert any(isinstance(getattr(s, "tool", s), kind) for s in after.slots if s is not None)

        return pred

    return (
        txn.TransactionTester(conflict_types=(cursor.InventoryConflict,))
        .transaction(cursor.InventoryTransaction.insert_items([cursor.PlaceBlock(green)]),
                     has_tool(cursor.PlaceBlock))
        .transaction(cursor.InventoryTransaction.insert_items([cursor.RemoveBlock()]),
                     has_tool(cursor.RemoveBlock))
        .transaction(cursor.InventoryTransaction.replace_slot(0, cursor.Stack(cursor.RemoveBlock(), 1),
                                                              cursor.Stack(cursor.PlaceBlock(blue), 1)),
                     has_tool(cursor.PlaceBlock))
        .target(lambda: cursor.Inventory(slots=[cursor.Stack(cursor.RemoveBlock(), 1), None, None]))
    )


class _Put:
    """A duck-typed transaction over a dict target: `check` raises where
    the key is `missing`, `commit` sets the key (or raises where
    `commit_fails`), `merge` keeps both puts (or only its own where
    `drops`, breaking merge completeness; or raises `conflict` on a
    shared key)."""

    def __init__(self, key, value, commit_fails=False, drops=False, conflict=None, missing=()):
        self.puts = {key: value}
        self.commit_fails, self.drops, self.conflict, self.missing = commit_fails, drops, conflict, missing

    def check(self, target):
        if any(k in self.missing for k in self.puts):
            raise KeyError("inapplicable")

    def commit(self, target):
        if self.commit_fails:
            raise ValueError("commit failed")
        target.update(self.puts)

    def merge(self, other):
        if self.conflict is not None and self.puts.keys() & other.puts.keys():
            raise self.conflict("shared key")
        out = _Put(*next(iter(self.puts.items())), drops=self.drops, conflict=self.conflict)
        if not self.drops:
            out.puts.update(other.puts)
        return out

    def __repr__(self):
        return f"_Put({sorted(self.puts)})"


def _puts(key):
    def pred(before, after):
        assert after.get(key) == key, f"{key} not put"

    return pred


#: Law-breaking and lawful duck-typed cases: each a function of the
#: package's tester module giving a tester.
DUCK = {
    "lawful": lambda m: m.TransactionTester().transaction(_Put("a", "a"), _puts("a"))
    .transaction(_Put("b", "b"), _puts("b")).target(dict),
    "commit fails after check": lambda m: m.TransactionTester().transaction(_Put("a", "a", commit_fails=True),
                                                                           _puts("a")).target(dict),
    "merge drops an effect": lambda m: m.TransactionTester().transaction(_Put("a", "a", drops=True), _puts("a"))
    .transaction(_Put("b", "b"), _puts("b")).target(dict),
    "inapplicable everywhere": lambda m: m.TransactionTester().transaction(_Put("a", "a", missing=("a",)),
                                                                          _puts("a")).target(dict),
    "conflicting merges skipped": lambda m: m.TransactionTester().transaction(
        _Put("a", "a", conflict=m.TransactionConflict), _puts("a")).target(dict),
    "no targets": lambda m: m.TransactionTester().transaction(_Put("a", "a"), _puts("a")),
}


def _outcome(run):
    try:
        run()
    except AssertionError as e:
        return ("AssertionError", str(e).split(":")[0].split("\n")[0])
    return ("passed",)


@pytest.mark.parametrize("suite", ["space", "universe", "inventory"])
def test_txn_tester_matches_aic_tpu_on_the_law_suites(suite):
    assert _outcome(_law_suite("torch", suite).test) == _outcome(_law_suite("jax", suite).test) == ("passed",)


@pytest.mark.parametrize("case", sorted(DUCK))
def test_txn_tester_raises_where_aic_tpu_raises(case):
    got, want = _outcome(DUCK[case](ttxn).test), _outcome(DUCK[case](jtxn).test)
    assert got == want
    assert (got[0] == "passed") == (case in ("lawful", "conflicting merges skipped"))


def test_txn_tester_default_commit_matches_aic_tpu():
    for commit in (ttxn._default_commit, jtxn._default_commit):
        target = {}
        assert commit(_Put("k", 1), target) is None and target == {"k": 1}


# -- the six public names --------------------------------------------------------


def test_public_names_match_aic_tpu():
    import aic_tpu.content.template as jt
    import aic_tpu.math.color as jc
    import aic_tpu.raytrace.accel as ja
    import aic_tpu.raytrace.tracer as jtr
    import aic_tpu_torch.content.template as tt
    import aic_tpu_torch.math.color as tc
    import aic_tpu_torch.raytrace.accel as ta
    import aic_tpu_torch.raytrace.tracer as ttr

    for name in ("TRANSPARENT", "WHITE", "BLACK"):
        got, want = getattr(tc, name), getattr(jc, name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tt.TEMPLATES == jt.TEMPLATES
    assert ttr.HIT_KEYS == jtr.HIT_KEYS
    assert ta.MAX_SKIP == ja.MAX_SKIP
    assert ttesting.__all__ == jtesting.__all__


def test_txn_law_cases_on_a_device_state():
    """`chip_smoke`'s transaction-law phase on targets whose contents live
    on a device (the CPU here): the laws hold, and every commit that
    writes a cube scatters onto the target's state, which then equals the
    host contents."""
    from aic_tpu_torch.space import state as state_mod

    targets = []

    def make(with_red, blocks):
        targets.append(chip_smoke.DeviceTarget("cpu", with_red, blocks))
        return targets[-1]

    with chip_smoke.timed_calls(state_mod, "scatter_set_cubes") as scatters:
        chip_smoke.txn_law_cases(make, lambda txn, target: target.commit(txn)).test()
    assert scatters
    for t in targets:
        np.testing.assert_array_equal(t.state.contents.numpy(), t.space.contents.astype(np.int32))
