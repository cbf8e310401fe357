"""Fixtures of the benchmark's own tests: a tiny world written by the
program's content code, and whether a card is present (decided here,
never while a module is imported)."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(scope="session")
def tiny_world(tmp_path_factory):
    """A 20x17x16 atrium with a player, saved in the native format, and
    the saved palette indices of its lamp and opaque blocks."""
    from aic_tpu_torch.content.atrium import atrium
    from aic_tpu_torch.io.save import save_universe
    from aic_tpu_torch.universe import Universe

    sp = atrium(width=20, depth=16, floors=1)
    u = Universe(device="cpu")
    u.insert_space("world", sp)
    u.insert_character("player", "world", (7.0, 2.0, 5.0))
    path = tmp_path_factory.mktemp("voxbench") / "tiny.json"
    save_universe(u, str(path))
    lamps, opaque = [], []
    for i in range(sp.palette_len()):
        ev = sp.evaluated(i)
        if np.any(np.asarray(ev.light_emission) > 0) and ev.resolution > 1:
            lamps.append(i)
        elif bool(np.all(ev.opaque)) and ev.resolution == 1 and not np.any(np.asarray(ev.light_emission) > 0):
            opaque.append(i)
    return {"world": str(path), "lamp_blocks": lamps, "opaque_blocks": opaque}


@pytest.fixture
def card():
    """Skip unless a CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels and the cell's sizes run only there")
    return torch.device("cuda")
