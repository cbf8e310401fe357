"""The port's incremental light queue and the device half of a commit
(aic_tpu_torch.light.update, space.state, raytrace.accel) against
`aic_tpu`.

On the CPU `relight_batch` is the plain walk over the chart steps (the
card's path is the relight kernel over the batch, held against this walk
by chip_smoke.py and tests/test_torch_cuda.py). It sums in f32 in
another order than the XLA walk, so a cube's packed light may differ by
one step (the codec's unit, tests/test_pallas_relight.py:60), statuses
equal. The queue's selection is exact: the port selects on composite
keys that order ties as `lax.top_k` does. The cell functions on tensors
and `scatter_set_cubes` are bit-equal to their numpy twins and to
`aic_tpu`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aic_tpu.light import update as jupdate
from aic_tpu.light.refproc import fast_evaluate_seed as jseed
from aic_tpu.space import state as jstate
from aic_tpu_torch.light import dense as tdense
from aic_tpu_torch.light import relight_kernel
from aic_tpu_torch.light import update as tupdate
from aic_tpu_torch.raytrace import accel
from aic_tpu_torch.space import state as tstate
from test_pallas_relight import _scene
from test_torch_state import PKGS, to_port

MAX_STEP = 1


def _packed_diff(a, b):
    a, b = np.asarray(a).astype(np.int32), np.asarray(b).astype(np.int32)
    return int(np.abs(a[..., :3] - b[..., :3]).max(initial=0)), bool(np.array_equal(a[..., 3], b[..., 3]))


def _seeded(st):
    st, _ = jseed(st)
    return st


def _batch(st, n, seed):
    """n distinct cubes of the state (numpy-seeded), opaque and emissive
    cubes among them where the state has any; every fourth row padding."""
    rng = np.random.default_rng(seed)
    size = np.asarray(st.contents.shape)
    flat = rng.choice(int(np.prod(size)), size=n, replace=False)
    contents = np.asarray(st.contents).reshape(-1)
    t = st.tables
    opaque = np.asarray(t.opaque_faces).all(-1)[contents]
    emissive = (np.asarray(t.light_emission) != 0).any(-1)[contents]
    for i, pick in enumerate((np.flatnonzero(opaque & ~emissive), np.flatnonzero(emissive))):
        if pick.size and not np.isin(pick[0], flat):
            flat[i] = pick[0]
    cubes = np.stack(np.unravel_index(flat, tuple(size)), -1).astype(np.int32)
    valid = np.arange(n) % 4 != 3
    return cubes, valid


SCENES = {
    "mixed10": lambda: _scene((10, 10, 10), md=8),
    "non_pow2": lambda: _scene((6, 13, 9), md=6, seed=2),
    "cornell12": lambda: PKGS["jax"].cornell_box(12).snapshot(),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_relight_batch_matches_aic_tpu(name):
    """Packed light within one step, statuses equal, on the valid rows;
    padding rows give 0 texels."""
    st = _seeded(SCENES[name]())
    cubes, valid = _batch(st, 48, seed=len(name))
    want = np.asarray(jupdate.relight_batch(st, jnp.asarray(cubes), jnp.asarray(valid)))
    got = tupdate.relight_batch(to_port(st), torch.as_tensor(cubes), torch.as_tensor(valid)).numpy()
    step, status = _packed_diff(got[valid], want[valid])
    assert step <= MAX_STEP and status, (step, status)
    assert not got[~valid].any()
    contents = np.asarray(st.contents)[tuple(cubes.T)]
    t = st.tables
    assert (np.asarray(t.opaque_faces).all(-1)[contents] & valid).any()  # an opaque origin is covered


def test_relight_batch_on_the_cpu_takes_the_plain_walk():
    jst = _seeded(SCENES["mixed10"]())
    st = to_port(jst)
    cubes, valid = _batch(jst, 16, seed=0)
    before = relight_kernel.LAUNCHES_LISTED
    a = tupdate.relight_batch(st, torch.as_tensor(cubes), torch.as_tensor(valid))
    b = tupdate.relight_batch_plain(st, torch.as_tensor(cubes), torch.as_tensor(valid))
    assert relight_kernel.LAUNCHES_LISTED == before
    assert torch.equal(a, b)


def _dirty_fields(shape, seed):
    """u8 priorities with many ties: 0 mostly, then 255, 200 and 7."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([0, 0, 0, 0, 255, 200, 7], np.uint8), size=shape)


@pytest.mark.parametrize("shape,batch", [((16, 16, 16), 16), ((10, 7, 9), 16), ((12, 12, 12), 1024)])
def test_queue_selection_matches_aic_tpu(shape, batch, monkeypatch):
    """The cubes a round relights, in order, and their validity equal
    `aic_tpu`'s two-stage `lax.top_k` selection, ties included (recorded
    from `aic_tpu`'s round, run without jit, which stops once it has
    handed its selection to `relight_batch`: the relight and the rest of
    the round are not what this test checks)."""
    st = _scene(shape, md=4)
    dirty = _dirty_fields(shape, seed=sum(shape))
    st = dataclasses.replace(st, light_dirty=jnp.asarray(dirty))
    seen = {}

    class Selected(Exception):
        pass

    def record(state, cubes, valid):
        seen["cubes"], seen["valid"] = np.asarray(cubes), np.asarray(valid)
        raise Selected

    monkeypatch.setattr(jupdate, "relight_batch", record)
    with jax.disable_jit(), pytest.raises(Selected):
        jupdate.light_update_round(st, batch_size=batch)
    pos, valid, _flat = tupdate.select_batch(torch.as_tensor(dirty), batch)
    np.testing.assert_array_equal(valid.numpy(), seen["valid"])
    np.testing.assert_array_equal(pos.numpy()[seen["valid"]], seen["cubes"][seen["valid"]])
    assert seen["valid"].sum() == min(batch, int((dirty > 0).sum()))


def test_update_round_matches_aic_tpu():
    """One round from the seed: light within one step and statuses equal
    everywhere; the relit cubes' dirty marks cleared and the same
    neighbours bumped; the stats equal."""
    st = _seeded(SCENES["mixed10"]())
    jst, jstats = jupdate.light_update_round(st, batch_size=16)
    tst, tstats = tupdate.light_update_round(to_port(st), batch_size=16)
    step, status = _packed_diff(tst.light.numpy(), np.asarray(jst.light))
    assert step <= MAX_STEP and status
    np.testing.assert_array_equal(tst.light_dirty.numpy(), np.asarray(jst.light_dirty))
    for k in ("updated", "queue_remaining"):
        assert int(tstats[k]) == int(jstats[k]), k


def test_queue_to_fixpoint_matches_aic_tpu():
    """`evaluate_light` below the dense threshold runs the queue until it
    drains: from a converged room with one cube changed, both packages
    reach a fixpoint within one step of each other."""
    st = _scene((10, 10, 10), md=8)
    st, _ = jupdate.evaluate_light(st)  # dense: most of the volume is dirty
    st = jstate.scatter_set_cubes(st, jnp.asarray([[5, 5, 5]], jnp.int32), jnp.asarray([3], jnp.int32))
    assert 0 < int((np.asarray(st.light_dirty) > 0).sum()) <= 0.02 * st.light_dirty.size
    want, n_want = jupdate.evaluate_light(st, batch_size=16)
    got, n_got = tupdate.evaluate_light(to_port(st), batch_size=16)
    step, status = _packed_diff(got.light.numpy(), np.asarray(want.light))
    assert step <= MAX_STEP and status
    assert n_got > 0 and n_want > 0
    assert not got.light_dirty.any()


def test_evaluate_light_takes_the_dense_passes_above_two_percent():
    st = to_port(SCENES["cornell12"]())
    assert float((st.light_dirty > 0).float().mean()) > 0.02
    got, n = tupdate.evaluate_light(st)
    want, passes = tdense.evaluate_light_dense(st)
    assert n == passes * st.light_dirty.numel()
    assert torch.equal(got.light, want.light)


# -- cells and commits on tensors --------------------------------------------


@pytest.mark.parametrize("name", ["atoms", "voxels", "atrium_small"])
def test_cell_packing_on_tensors_equals_numpy(name):
    """`skip_distance_field` and `build_trace_cells` on CPU tensors give the
    numpy twins' bits, and the snapshot's space bricks."""
    from test_torch_state import SCENES as STATE_SCENES

    sp = STATE_SCENES[name](PKGS["torch"])
    st = sp.snapshot(device="cpu")
    t = st.tables
    contents = sp.contents.astype(np.int32)
    vis = t.visible.numpy()[contents]
    np.testing.assert_array_equal(accel.skip_distance_field(torch.as_tensor(vis)).numpy(),
                                  accel.np_skip_distance_field(vis))
    got = accel.to_bricks(accel.build_trace_cells(
        st.contents, t.visible, t.voxel_index >= 0, t.res_log2, payload=accel.cell_payload(t.voxel_index)))
    n_sb = got.shape[0]
    assert torch.equal(got, st.cells[:n_sb])


def _edits(st, n, seed):
    """n edits away from the lower faces (`aic_tpu`'s scatters wrap a
    neighbour index of -1 to the far face, test below), one at the upper
    corner (its neighbours outside the bounds are dropped) and one past
    the upper bound (dropped)."""
    rng = np.random.default_rng(seed)
    size = np.asarray(st.contents.shape)
    idx = np.stack([rng.integers(1, s, size=n) for s in size], -1).astype(np.int32)
    idx = np.unique(idx, axis=0)
    idx[0] = size - 1
    idx[1] = (size[0] + 1, 2, 2)
    new = rng.integers(0, st.tables.resolution.shape[0], size=idx.shape[0]).astype(np.int32)
    return idx, new


@pytest.mark.parametrize("name", ["voxels", "atrium_small"])
def test_scatter_set_cubes_matches_aic_tpu(name):
    """Contents, dirty marks and cells after a scatter equal `aic_tpu`'s."""
    from test_torch_state import SCENES as STATE_SCENES

    st = STATE_SCENES[name](PKGS["jax"]).snapshot()
    idx, new = _edits(st, 12, seed=5)
    want = jstate.scatter_set_cubes(st, jnp.asarray(idx), jnp.asarray(new))
    got = tstate.scatter_set_cubes(to_port(st), torch.as_tensor(idx), torch.as_tensor(new))
    np.testing.assert_array_equal(got.contents.numpy(), np.asarray(want.contents).astype(np.int32))
    np.testing.assert_array_equal(got.light_dirty.numpy(), np.asarray(want.light_dirty))
    np.testing.assert_array_equal(got.cells.numpy(), np.asarray(want.cells))


def test_scatter_dirty_marks_stay_in_bounds():
    """A commit at the lower faces marks the cubes the host Space marks
    (`_mark_light_dirty_around`: the cube and its in-bounds neighbours).
    `aic_tpu`'s device scatter wraps a neighbour index of -1 to the far
    face (JAX normalizes negative scatter indices before `mode="drop"`);
    the port drops it (ROADMAP §C)."""
    sp = PKGS["torch"].Space(PKGS["torch"].GridAab.from_lower_size((0, 0, 0), (5, 4, 6)))
    st = sp.snapshot(device="cpu")
    sp.light_dirty[...] = 0
    st = dataclasses.replace(st, light_dirty=torch.zeros_like(st.light_dirty))
    cubes = [(0, 0, 0), (0, 3, 2), (4, 1, 0)]
    for c in cubes:
        sp._mark_light_dirty_around(c)
    got = tstate.scatter_set_cubes(st, torch.as_tensor(cubes), torch.zeros(3, dtype=torch.int32))
    np.testing.assert_array_equal(got.light_dirty.numpy(), sp.light_dirty)
    assert not got.light_dirty[4, 3, 2] and not got.light_dirty[0, 0, 5]  # where -1 would wrap


def test_lookups_match_aic_tpu():
    st = _seeded(SCENES["non_pow2"]())
    rng = np.random.default_rng(1)
    idx = rng.integers(-2, 16, size=(40, 3)).astype(np.int32)
    tst = to_port(st)
    for jfn, tfn in ((jstate.lookup_contents, tstate.lookup_contents), (jstate.lookup_light, tstate.lookup_light)):
        jv, jm = jfn(st, jnp.asarray(idx))
        tv, tm = tfn(tst, torch.as_tensor(idx))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tv.numpy()[tm.numpy()], np.asarray(jv)[np.asarray(jm)])
    np.testing.assert_array_equal(tstate.in_bounds_mask(tst, torch.as_tensor(idx)).numpy(),
                                  np.asarray(jstate.in_bounds_mask(st, jnp.asarray(idx))))


def test_batch_tables_follow_the_contents():
    """The card path's visibility mask is cached on the contents tensor: a
    relight after an edit reads the edited contents' mask, the same as a
    fresh one, and an unchanged state gets the cached mask back. The pair
    tables depend only on the size, light distance and sky: the edit
    keeps them, and the dense context shares them."""
    st = to_port(_seeded(SCENES["mixed10"]()))
    mask = tupdate.batch_face_mask(st)
    pairs = tdense.device_pair_tables(st)
    assert tupdate.batch_face_mask(dataclasses.replace(st, light=st.light.clone())) is mask
    edited = tstate.scatter_set_cubes(st, torch.as_tensor([[5, 5, 5]]), torch.as_tensor([2]))
    mask2 = tupdate.batch_face_mask(edited)
    assert mask2 is not mask
    fresh = relight_kernel.build_face_mask(edited.contents.clone(), edited.tables.light_face_rows)
    assert torch.equal(mask2, fresh)
    assert not torch.equal(mask2, mask)
    assert tdense.device_pair_tables(edited) is pairs
    assert tdense.build_relight_ctx(edited).pairs is pairs
    args, _org = tupdate.listed_inputs(edited, torch.as_tensor([[5, 5, 5], [1, 1, 1]]), torch.as_tensor([True, True]))
    assert args[3] is mask2 and args[4] is pairs


def test_a_queue_count_holds_for_its_own_queue_tensor():
    """`note_queue` counts one `light_dirty` tensor: a state that shares it
    shares the count, a state with another one (an edit's, a copy) is not
    known, and only a count of 0 makes the queue known to be empty.
    `evaluate_light` notes the queue it leaves."""
    st = to_port(_seeded(SCENES["mixed10"]()))
    assert not tupdate.queue_known_empty(st)
    tupdate.note_queue(st, torch.tensor(3))
    assert not tupdate.queue_known_empty(st)
    tupdate.note_queue(st, 0)
    assert tupdate.queue_known_empty(st)
    assert tupdate.queue_known_empty(dataclasses.replace(st, light=st.light.clone()))
    assert not tupdate.queue_known_empty(dataclasses.replace(st, light_dirty=st.light_dirty.clone()))
    edited = tstate.scatter_set_cubes(st, torch.as_tensor([[5, 5, 5]]), torch.as_tensor([2]))
    assert not tupdate.queue_known_empty(edited)
    lit, _ = tupdate.evaluate_light(edited)
    assert tupdate.queue_known_empty(lit) and not lit.light_dirty.any()
