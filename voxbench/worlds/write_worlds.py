"""Write the benchmark's worlds once, from the program's port of the
upstream templates, in the native save format; print each file's size
and sha256 for its configuration file.

    python3 voxbench/worlds/write_worlds.py

The benchmark never runs this: the files it writes are its inputs, so a
later change to `content/` does not change what is measured.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from aic_tpu_torch.content.template import TemplateParameters, build_universe  # noqa: E402
from aic_tpu_torch.io.save import save_universe  # noqa: E402
from voxbench import world  # noqa: E402

WORLDS = {
    "atrium": ("atrium", TemplateParameters(seed=0)),
}

if __name__ == "__main__":
    for name, (template, params) in WORLDS.items():
        path = Path(__file__).resolve().parent / f"{name}.json"
        save_universe(build_universe(template, params, device="cpu"), str(path))
        print(name, path.stat().st_size, world.sha256(path))
