"""The control on the card: the plain reference one precision step down, put
in the program's place, has to come out not correct, and the program has
to come out correct, at each cell's own size with a short window.

    python3 -m pytest voxbench/tests/test_voxbench_control.py -m cuda -q
"""

import pytest

from voxbench import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    r = harness.run_cell(harness.find_cell(cell), 2**32 + 99, 5.0, False, control=True)
    assert r["correct"], r["checks"]
    failed = [k for k, v in r["control"].items() if v > r["checks"][k]["limit"]]
    assert failed, (r["control"], r["checks"])
