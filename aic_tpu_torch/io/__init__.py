"""Layer 5: save/load and export (port of `aic_tpu/io`; reference:
all-is-cubes/src/save, all-is-cubes-port). Still to be ported: the
reference's interchange schema, `import_ref.py` (`.alliscubesjson`,
ROADMAP A9(c))."""

from .export import export_gltf, export_gltf_animation, export_stl
from .save import load_universe, save_universe
from .vox import export_vox, import_vox
from .whence import FileWhence, NoWhence, load_universe_file

__all__ = ["FileWhence", "NoWhence", "export_gltf", "export_gltf_animation", "export_stl", "export_vox",
           "import_vox", "load_universe", "load_universe_file", "save_universe"]
