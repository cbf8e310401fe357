"""Each traffic generator repeats exactly for a seed and differs across seeds,
with seeds past 32 bits."""

import numpy as np
import pytest

from voxbench import harness
from voxbench.drivers import relight

SEEDS = (7, 2**31 + 12345, 2**33 + 5)


def _world(cell):
    c = harness.find_cell(cell)
    return harness.ROOT / c.config["world"]["file"], c.traffic


@pytest.mark.parametrize("seed", SEEDS)
def test_edit_script_repeats_and_differs(seed):
    path, params = _world("atrium.relight")
    a = relight.edit_script(path, params, seed, 400)
    b = relight.edit_script(path, params, seed, 400)
    c = relight.edit_script(path, params, seed + 1, 400)
    assert all(np.array_equal(x[0], y[0]) and x[1:] == y[1:] for x, y in zip(a, b))
    assert any(not np.array_equal(x[0], y[0]) for x, y in zip(a, c))
    kinds = [e[1] for e in a]
    share = {k: kinds.count(k) / len(kinds) for k in params["mix"]}
    assert all(abs(share[k] - params["mix"][k]) < 0.1 for k in params["mix"])
    sizes = {e[1]: len(e[0]) for e in a}
    assert sizes["single"] == 1 and sizes["slab"] == 16 and sizes["wall"] == 144


def test_seed_streams_are_independent():
    a = harness.seed_rng(2**40 + 3, "x").random(4)
    assert np.array_equal(a, harness.seed_rng(2**40 + 3, "x").random(4))
    assert not np.array_equal(a, harness.seed_rng(2**40 + 3, "y").random(4))
    assert not np.array_equal(a, harness.seed_rng(3, "x").random(4))


def test_reservoir_keeps_a_uniform_sample_of_unknown_length():
    counts = np.zeros(20)
    for s in range(400):
        r = harness.Reservoir(4, harness.seed_rng(s, "t"))
        for i in range(20):
            slot = r.wants()
            if slot is not None:
                r.put(slot, i)
        assert len(r.items) == 4 and len(set(r.items)) == 4
        counts[r.items] += 1
    assert counts.min() > 0.5 * counts.mean()
