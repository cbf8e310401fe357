"""The reference light, written apart from the program, agrees with the
program's own plain version of the light equation where both are sound:
the same chart of rays, the same pass bit for bit, the same fixpoint to
one code. The program is imported here only to be compared with; the
reference itself never imports it (`test_voxbench_imports.py`)."""

import numpy as np
import pytest
import torch

from voxbench.reference import light as ref_light
from voxbench.reference import world as ref_world


@pytest.fixture(scope="module")
def lit(tiny_world):
    """The tiny world decoded by the reference, and the program's state of
    it relit to convergence on the CPU."""
    from aic_tpu_torch.io.save import load_universe
    from aic_tpu_torch.light.dense import evaluate_light_dense

    w = ref_world.load(tiny_world["world"])
    st = load_universe(tiny_world["world"], device="cpu").states["world"]
    st, _ = evaluate_light_dense(st)
    return w, st


@pytest.mark.parametrize("max_distance", [7, 20, 60])
def test_chart_is_the_programs(max_distance):
    from aic_tpu_torch.light.chart import STEP_END, build_chart

    ch = build_chart(max_distance)
    mine = ref_light.chart(max_distance)
    assert np.array_equal(ch["cosines"], mine["cos"])
    for r in range(ch["n_rays"]):
        n = list(ch["kinds"][r]).index(STEP_END) + 1
        m = list(mine["end"][r]).index(True) + 1
        assert n == m, r
        assert np.array_equal(ch["offsets"][r, :n], mine["off"][r, :m]), r
        assert np.array_equal(ch["faces_in"][r, :n], mine["face"][r, :m]), r


def test_the_world_decodes_to_the_programs_palette(lit):
    w, st = lit
    assert torch.equal(w.contents, st.contents.long())
    assert np.array_equal(w.sky_faces, st.sky_faces.numpy())
    assert w.max_distance == st.light_max_distance


def test_a_pass_is_the_programs_plain_pass(lit):
    from aic_tpu_torch.light.dense import build_relight_ctx, relight_all_pass

    w, st = lit
    prog = relight_all_pass(st, build_relight_ctx(st))
    assert torch.equal(ref_light.light_pass(w, st.light), prog)


def test_the_programs_settled_light_is_a_fixpoint_and_the_control_is_not(lit):
    w, st = lit
    resid = ref_light.codes_apart(ref_light.light_pass(w, st.light), st.light)
    assert int(resid.max()) <= 1
    low, _ = ref_light.relight(w, st.light, "lower")
    resid = ref_light.codes_apart(ref_light.light_pass(w, low), low)
    assert float((resid > 2).float().mean()) > 0.1


def test_relight_from_nothing_reaches_the_programs_light(lit):
    w, st = lit
    light, passes = ref_light.relight(w, torch.zeros_like(st.light))
    assert 1 < passes < 200
    assert int(ref_light.codes_apart(light, st.light).max()) <= 1


def test_codes_round_trip_and_status_counts_in_full():
    v = torch.tensor([0.0, 1.0, 2.0 ** -14.4, 1e6])
    assert ref_light.encode(v).tolist() == [0, 144, 0, 255]
    assert ref_light.decode(torch.tensor([144], dtype=torch.uint8)).item() == 1.0
    a = torch.tensor([[10, 10, 10, 255]], dtype=torch.uint8)
    b = torch.tensor([[12, 9, 10, 128]], dtype=torch.uint8)
    assert ref_light.codes_apart(a, b).tolist() == [255]
    assert ref_light.codes_apart(a, a).tolist() == [0]
