"""The light queue's round as a CUDA graph (`light/update.py::RoundGraph`),
on the card: `evaluate_light`'s replays give the light, queue, cubes
updated and rounds of eager rounds bit for bit, capture once per palette
tables and pair tables, and return states of their own.

These tests need a CUDA device and skip without one:

    python -m pytest tests/test_torch_relight_graph.py -m cuda
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from aic_tpu_torch import block, profiling
from aic_tpu_torch.content import atrium
from aic_tpu_torch.light import relight_kernel, update
from aic_tpu_torch.light.dense import evaluate_light_dense
from aic_tpu_torch.space.state import scatter_set_cubes

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def lit_atrium():
    """The atrium, its host Space and its state on the card lit to
    convergence."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the round graph and K2's listed kernel run only there")
    space = atrium()
    state, _ = evaluate_light_dense(space.snapshot(device="cuda"))
    return space, state


def eager_rounds(state, batch_size=256):
    """`evaluate_light`'s queue loop driven by hand with eager rounds:
    (state, cubes updated, rounds)."""
    updated = rounds = 0
    while True:
        state, stats = update.light_update_round(state, batch_size)
        rounds += 1
        updated += int(stats["updated"])
        if int(stats["queue_remaining"]) == 0:
            return state, updated, rounds


def seeded_edits(state, palette_len, n, seed):
    """n edits in turn of a cube, a 4x4x1 slab and a 12x12x1 wall, each set
    to one palette entry: [(cubes i64[k,3] index space, blocks i32[k])]."""
    rng = np.random.default_rng(seed)
    X, Y, Z = state.contents.shape
    out = []
    for i in range(n):
        w = (1, 4, 12)[i % 3]
        origin = np.array([rng.integers(0, X - w + 1), rng.integers(0, Y - w + 1), rng.integers(0, Z)])
        grid = np.stack(np.meshgrid(np.arange(w), np.arange(w), [0], indexing="ij"), -1).reshape(-1, 3)
        out.append((origin + grid, np.full(w * w, rng.integers(0, palette_len), np.int32)))
    return out


def relit(state):
    """`evaluate_light` under the recorder: (state, cubes updated, the
    recorder's counters it added, listed launches)."""
    c0, l0 = dict(profiling.RECORDER.counters), relight_kernel.LAUNCHES_LISTED
    got, updated = update.evaluate_light(state)
    added = {k: v - c0.get(k, 0) for k, v in profiling.RECORDER.counters.items()}
    return got, updated, added, relight_kernel.LAUNCHES_LISTED - l0


def test_graph_rounds_equal_eager_rounds(lit_atrium):
    """24 seeded edits of the atrium, each kind in turn, and their reverts,
    each relit by `evaluate_light`: its replays give light, queue and cubes
    updated equal to eager rounds from the same state bit for bit, in as
    many rounds (each a replay and one listed launch); after the warm-up
    nothing is captured again; each returned state owns its storage; and
    the listed kernel's tickets are all 0 at the end."""
    space, state = lit_atrium
    dev = state.contents.device
    warm = scatter_set_cubes(state, torch.tensor([[30, 5, 20]]), torch.tensor([1], dtype=torch.int32))
    update.evaluate_light(warm)
    profiling.RECORDER.reset()
    seen, prev = [], None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for cubes, blocks in seeded_edits(state, space.palette_len(), 24, seed=2**33 + 19):
            idx = torch.as_tensor(cubes, device=dev)
            old = state.contents[idx[:, 0], idx[:, 1], idx[:, 2]]
            for edit in (torch.as_tensor(blocks, device=dev), old):
                st = scatter_set_cubes(state, idx, edit)
                assert 0 < int((st.light_dirty > 0).sum()) <= update.DENSE_THRESHOLD * st.light_dirty.numel()
                got, updated, added, launches = relit(st)
                want, want_updated, rounds = eager_rounds(st)
                assert torch.equal(got.light, want.light) and torch.equal(got.light_dirty, want.light_dirty)
                assert updated == want_updated and not got.light_dirty.any()
                assert added["light.rounds"] == added["light.graph_rounds"] == launches == rounds
                assert added.get("light.graph_captures", 0) == 0
                if prev is not None:
                    for name in ("light", "light_dirty"):
                        a, b = getattr(prev[0], name), getattr(got, name)
                        assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr(), name
                    assert torch.equal(prev[0].light, prev[1])  # the last event's light, untouched
                prev = (got, got.light.clone())
                seen.append(rounds)
                state = got
    profiling.RECORDER.reset()
    assert len(seen) == 48 and sum(seen) > 48
    assert all(not t.any() for (d, _), t in relight_kernel._TICKETS.items() if d == dev)


def test_new_palette_tables_capture_anew(lit_atrium):
    """A state whose palette tables have an extra entry (the pair tables
    kept) captures a graph of its own, whose rounds equal eager rounds; a
    device, volume shape and batch size keep one graph, so going back to
    the first tables captures again."""
    space, state = lit_atrium
    grown = atrium()
    grown.set((1, 0, 1), block.from_color((0.9, 0.2, 0.1, 1.0), "extra"))
    assert grown.palette_len() == space.palette_len() + 1
    wide = dataclasses.replace(state, tables=grown.snapshot(device=state.contents.device).tables)
    edit = torch.tensor([[20, 4, 10], [21, 4, 10]])
    blocks = torch.full((2,), grown.palette_len() - 1, dtype=torch.int32)
    update.evaluate_light(scatter_set_cubes(state, edit, torch.tensor([1, 1], dtype=torch.int32)))
    profiling.RECORDER.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for st, captures in ((scatter_set_cubes(wide, edit, blocks), 1),
                             (scatter_set_cubes(state, edit, torch.tensor([2, 2], dtype=torch.int32)), 1)):
            got, updated, added, _ = relit(st)
            want, want_updated, rounds = eager_rounds(st)
            assert torch.equal(got.light, want.light) and torch.equal(got.light_dirty, want.light_dirty)
            assert updated == want_updated and added["light.rounds"] == rounds
            assert added.get("light.graph_captures", 0) == captures
    profiling.RECORDER.reset()


def test_a_graph_holds_one_launch_and_goes_with_its_tables(lit_atrium):
    """A capture counts the listed launches its round records, one, and
    each replay adds that many; a graph whose palette tables died is
    dropped at the next `round_graph`, with the buffers and pool it held."""
    space, state = lit_atrium
    grown = atrium()
    grown.set((1, 0, 1), block.from_color((0.2, 0.9, 0.1, 1.0), "extra"))
    wide = dataclasses.replace(state, tables=grown.snapshot(device=state.contents.device).tables)
    graph = update.round_graph(wide, 128)
    assert graph.launches == 1 and graph.live() and graph.fits(wide)
    before = relight_kernel.LAUNCHES_LISTED
    graph.load(wide)
    graph.replay()
    assert relight_kernel.LAUNCHES_LISTED == before + 1
    gone = weakref.ref(graph)
    del graph, wide, grown
    gc.collect()
    update.round_graph(state, 256)
    assert gone() is None
    assert all(g.live() for g in update._ROUND_GRAPHS.values())
