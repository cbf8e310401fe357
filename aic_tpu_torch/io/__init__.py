"""Layer 5: save/load (port of `aic_tpu/io`; reference: all-is-cubes/src/save,
all-is-cubes-port). The reference's interchange schema (`import_ref.py`)
and the mesh exports (`export.py`) are still to be ported (ROADMAP A9,
A14)."""

from .save import load_universe, save_universe
from .vox import export_vox, import_vox
from .whence import FileWhence, NoWhence, load_universe_file

__all__ = ["FileWhence", "NoWhence", "export_vox", "import_vox", "load_universe", "load_universe_file",
           "save_universe"]
