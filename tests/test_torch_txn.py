"""The port's transactions and operations (aic_tpu_torch.universe.
transaction, .op) against `aic_tpu`, mirroring tests/test_txn_laws.py
and tests/test_space_txn_ref.py.

Each case is built twice, once with each package's own blocks and
spaces, from the same description. The transaction laws are checked in
both and their outcomes compared: whether a merge conflicts, whether a
check passes on each target, and what a commit leaves in the host space
and on the device state (the port's on the CPU). A commit that grows
the palette returns None in both (the caller resnapshots).
"""

import itertools

import numpy as np
import pytest

import aic_tpu.universe as jU
import aic_tpu_torch.universe as tU
from test_torch_state import PKGS

PK = {"jax": (PKGS["jax"], jU), "torch": (PKGS["torch"], tU)}


def _blocks(p):
    b = p.block
    return dict(
        RED=b.from_color((0.9, 0.1, 0.1, 1.0), display_name="red"),
        GREEN=b.from_color((0.1, 0.9, 0.1, 1.0), display_name="green"),
        BLUE=b.from_color((0.1, 0.1, 0.9, 1.0), display_name="blue"),
        AIR=b.AIR,
    )


def _space(p, with_red=True, size=(4, 4, 4)):
    sp = p.Space(p.GridAab.from_lower_size((0, 0, 0), size))
    B = _blocks(p)
    if with_red:
        sp.set((0, 0, 0), B["RED"])
        sp.set((3, 3, 3), B["BLUE"])
    return sp


#: Transactions by name, each made by a function of (U, B).
TXNS = {
    "set_green": lambda U, B: U.SpaceTransaction.set_cube((1, 1, 1), new=B["GREEN"]),
    "paint_blue": lambda U, B: U.SpaceTransaction.set_cube((2, 2, 2), new=B["BLUE"], conserved=False),
    "cas_red_green": lambda U, B: U.SpaceTransaction.set_cube((0, 0, 0), old=B["RED"], new=B["GREEN"]),
    "set_blue_same_cube": lambda U, B: U.SpaceTransaction.set_cube((1, 1, 1), new=B["BLUE"]),
    "paint_blue_again": lambda U, B: U.SpaceTransaction.set_cube((2, 2, 2), new=B["BLUE"], conserved=False),
    "cas_blue_air": lambda U, B: U.SpaceTransaction.set_cube((3, 3, 3), old=B["BLUE"], new=B["AIR"]),
    "fluff": lambda U, B: U.SpaceTransaction.emitting_fluff((3, 3, 3), "happened"),
    "oob_paint": lambda U, B: U.SpaceTransaction.set_cube((9, 0, 0), new=B["GREEN"], conserved=False),
    "oob_set": lambda U, B: U.SpaceTransaction.set_cube((9, 0, 0), new=B["GREEN"]),
    "oob_compare": lambda U, B: U.SpaceTransaction.set_cube((9, 0, 0), old=B["GREEN"], conserved=False),
}
TARGETS = {"with_red": True, "empty": False}


def _names(sp):
    """Every cube's block by display name (palette indices may be
    interned in another order only if the packages diverged)."""
    return [[[sp.block_at((x, y, z)).attributes.display_name for z in range(sp.bounds.size[2])]
             for y in range(sp.bounds.size[1])] for x in range(sp.bounds.size[0])]


def _outcome(pkg, txn_names, target, device_state):
    """Merge the named transactions, check and commit on a fresh target.
    Returns a comparable record."""
    p, U = PK[pkg]
    B = _blocks(p)
    txn = None
    try:
        for n in txn_names:
            t = TXNS[n](U, B)
            txn = t if txn is None else txn.merge(t)
    except U.TransactionConflict:
        return ("conflict",)
    sp = _space(p, TARGETS[target])
    try:
        txn.check(sp)
    except U.PreconditionFailed:
        return ("precondition",)
    st = None
    if device_state:
        st = sp.snapshot(device="cpu") if pkg == "torch" else sp.snapshot()
    new_st = txn.commit(sp, st)
    dev = None
    if new_st is not None:
        dev = np.asarray(new_st.contents).astype(np.int32) if pkg == "jax" else new_st.contents.numpy()
        assert np.array_equal(dev, sp.contents.astype(np.int32))  # device equals host
    return ("ok", _names(sp), sp.contents.tolist(), dev is None if device_state else None,
            [(f.name, f.position) for f in txn.fluff], len(txn.cubes))


CASES = [(n,) for n in TXNS] + list(itertools.combinations(sorted(TXNS), 2))


@pytest.mark.parametrize("target", sorted(TARGETS))
@pytest.mark.parametrize("device_state", [False, True])
def test_transaction_laws_match_aic_tpu(target, device_state):
    """Every transaction and every pairwise merge, on each target: same
    conflict, same precondition outcome, same host contents and device
    contents after the commit, in both packages. And the laws: a check
    that passes commits without error, and a merge keeps both effects."""
    for case in CASES:
        want = _outcome("jax", case, target, device_state)
        got = _outcome("torch", case, target, device_state)
        assert got == want, case
        if len(case) == 2 and got[0] == "ok":
            for single in case:
                alone = _outcome("torch", (single,), target, False)
                if alone[0] == "ok":  # the merge keeps this constituent's edits
                    merged_names, alone_names = got[1], alone[1]
                    p, U = PK["torch"]
                    txn = TXNS[single](U, _blocks(p))
                    for cube in txn.cubes:
                        if all(0 <= c < 4 for c in cube) and txn.cubes[cube].new is not None:
                            x, y, z = cube
                            assert merged_names[x][y][z] == alone_names[x][y][z], (case, cube)


def test_commit_that_grows_the_palette_returns_none():
    """A commit interning a new block invalidates the device tables: both
    packages return None so that the caller resnapshots."""
    for pkg in ("jax", "torch"):
        p, U = PK[pkg]
        sp = _space(p, with_red=False)
        st = sp.snapshot(device="cpu") if pkg == "torch" else sp.snapshot()
        txn = U.SpaceTransaction.set_cube((1, 2, 3), new=p.block.from_color((0.3, 0.3, 0.3, 1.0), "new"))
        assert txn.execute(sp, st) is None
        assert sp.block_at((1, 2, 3)).attributes.display_name == "new"


def test_commit_without_growth_scatters_onto_the_state():
    """A commit of blocks the palette holds scatters onto the device
    state: contents, dirty marks and cells equal `aic_tpu`'s (cubes off
    the lower faces, where `aic_tpu`'s dirty marks wrap:
    tests/test_torch_update.py::test_scatter_dirty_marks_stay_in_bounds)."""
    out = {}
    for pkg in ("jax", "torch"):
        p, U = PK[pkg]
        B = _blocks(p)
        sp = _space(p)
        sp.set((2, 1, 1), B["GREEN"])
        st = sp.snapshot(device="cpu") if pkg == "torch" else sp.snapshot()
        txn = U.SpaceTransaction.set_cube((1, 1, 1), new=B["GREEN"]).merge(
            U.SpaceTransaction.set_cube((2, 1, 1), old=B["GREEN"], new=B["AIR"]))
        new = txn.execute(sp, st)
        out[pkg] = [np.asarray(getattr(new, k)) if pkg == "jax" else getattr(new, k).numpy()
                    for k in ("contents", "light_dirty", "cells")]
    for a, b in zip(out["torch"], out["jax"]):
        np.testing.assert_array_equal(a, b.astype(a.dtype))


def test_universe_transaction_laws_match_aic_tpu():
    """Per-space transactions and member inserts, merged and executed:
    the same conflicts, preconditions and results in both packages."""
    def run(pkg):
        p, U = PK[pkg]
        B = _blocks(p)
        u = U.Universe(device="cpu") if pkg == "torch" else U.Universe()
        u.insert_space("w", _space(p))
        annex = _space(p, with_red=False)
        t = U.UniverseTransaction(spaces={"w": U.SpaceTransaction.set_cube((1, 0, 0), new=B["GREEN"])})
        t = t.merge(U.UniverseTransaction.inserting("annex", annex))
        t = t.merge(U.UniverseTransaction(spaces={"w": U.SpaceTransaction.set_cube((0, 0, 0), old=B["RED"],
                                                                                  new=B["BLUE"])}))
        edits = t.execute(u)
        res = [edits, sorted(u.spaces), _names(u.spaces["w"])]
        with pytest.raises(U.TransactionConflict):
            U.UniverseTransaction.inserting("x", annex).merge(U.UniverseTransaction.inserting("x", _space(p)))
        assert U.UniverseTransaction.inserting("x", annex).merge(U.UniverseTransaction.inserting("x", annex))
        with pytest.raises(U.PreconditionFailed):
            U.UniverseTransaction.inserting("annex", _space(p)).execute(u)
        with pytest.raises(U.PreconditionFailed):
            U.UniverseTransaction(spaces={"nowhere": U.SpaceTransaction()}).execute(u)
        state = u.states["w"]
        dev = np.asarray(state.contents) if pkg == "jax" else state.contents.numpy()
        assert np.array_equal(dev.astype(np.int32), u.spaces["w"].contents.astype(np.int32))
        return res

    assert run("torch") == run("jax")


#: Operations applied at a cube, each made by a function of (U, B, p).
OPS = {
    "become": lambda U, B, p: U.Become(B["GREEN"]),
    "become_same": lambda U, B, p: U.Become(B["RED"]),
    "destroy": lambda U, B, p: U.DestroyTo(),
    "alt": lambda U, B, p: U.Alt((U.Become(B["RED"]), U.Become(B["BLUE"]))),
    "neighbors": lambda U, B, p: U.Neighbors((((1, 0, 0), U.Become(B["GREEN"])), ((0, 1, 0), U.DestroyTo()))),
    "neighbors_oob": lambda U, B, p: U.Neighbors((((-1, 0, 0), U.Become(B["GREEN"])),)),
    "move_inwards": lambda U, B, p: U.MoveInwards(face=4),
    "take_inventory": lambda U, B, p: U.TakeInventory(),
}


@pytest.mark.parametrize("name", sorted(OPS))
@pytest.mark.parametrize("cube", [(0, 0, 0), (3, 3, 3)])
def test_operations_match_aic_tpu(name, cube):
    """Each operation applied at a cube gives the same transaction (or
    the same failure) in both packages, and the same world once
    executed."""
    res = {}
    for pkg in ("jax", "torch"):
        p, U = PK[pkg]
        B = _blocks(p)
        sp = _space(p)
        try:
            txn = OPS[name](U, B, p).apply(sp, cube)
        except U.OperationFailed:
            res[pkg] = ("failed",)
            continue
        edits = sorted((c, (e.old.attributes.display_name if e.old is not None else None),
                        (e.new.attributes.display_name if e.new is not None else None), e.conserved)
                       for c, e in txn.cubes.items())
        try:
            txn.execute(sp)
            world = _names(sp)
        except U.PreconditionFailed:
            world = "precondition"
        res[pkg] = ("ok", edits, world)
    assert res["torch"] == res["jax"]
