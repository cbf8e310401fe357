"""A run with the timed path broken underneath has to come out not correct.

Each test skips the look for a card and drives the rest of a run on the
CPU at a small size (the program's plain twins; single-cube edits, whose
queue rounds take a second or two there), once sound and once for each
fault the cell can have: an event that leaves the light as it was, half
of the work left out, an answer altered where it is produced. (No cell
exchanges between chips, so that fault has no case.)"""

import dataclasses

import pytest

from voxbench import harness


def _run(overrides, seconds=4.0, **hooks):
    return harness.run_cell(harness.find_cell("atrium.relight"), 2**33 + 17, seconds, False, device="cpu",
                            overrides=overrides, driver_hooks=hooks)


def _relight_overrides(tiny_world):
    return {"sample_events": 3, "mix": {"single": 1.0, "slab": 0.0, "wall": 0.0}} | tiny_world


def _stale(i, prev, st):
    """The light as it was before the event: the relight left out."""
    return dataclasses.replace(st, light=prev.light)


def _half_light(i, prev, st):
    """Half of the cubes the event relit keep the light they had."""
    light = st.light.clone()
    moved = (light != prev.light).any(-1).nonzero()
    keep = moved[::2]
    light[keep[:, 0], keep[:, 1], keep[:, 2]] = prev.light[keep[:, 0], keep[:, 1], keep[:, 2]]
    return dataclasses.replace(st, light=light)


def _altered_light(i, prev, st):
    light = st.light.clone()
    flat = light.reshape(-1, 4)
    n = max(1, flat.shape[0] // 50)
    flat[:n, :3] = flat[:n, :3] ^ 0x40
    return dataclasses.replace(st, light=light)


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_relight_faults(tiny_world, fault):
    hook = {None: None, "unchanged": _stale, "half": _half_light, "altered": _altered_light}[fault]
    r = _run(_relight_overrides(tiny_world), light_hook=hook)
    assert r["attempted"] >= 1
    assert r["correct"] is (fault is None), r["checks"]


def test_a_wrong_edit_is_caught(tiny_world):
    """The transaction's cubes are compared exactly: an event that also
    changes a cube it was not asked to is not correct."""

    def extra(i, prev, st):
        contents = st.contents.clone()
        contents[0, 0, 0] = (contents[0, 0, 0] + 1) % 3
        return dataclasses.replace(st, contents=contents)

    r = _run(_relight_overrides(tiny_world), light_hook=extra)
    assert r["checks"]["edit_cubes_off"]["value"] > 0 and r["correct"] is False

