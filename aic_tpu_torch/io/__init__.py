"""Layer 5: save/load, import and export (port of `aic_tpu/io`; reference:
all-is-cubes/src/save, all-is-cubes-port)."""

from .export import export_gltf, export_gltf_animation, export_stl
from .import_ref import load_alliscubesjson, save_alliscubesjson
from .save import load_universe, save_universe
from .vox import export_vox, import_vox
from .whence import FileWhence, NoWhence, load_universe_file

__all__ = ["FileWhence", "NoWhence", "export_gltf", "export_gltf_animation", "export_stl", "export_vox",
           "import_vox", "load_alliscubesjson", "load_universe", "load_universe_file", "save_alliscubesjson", "save_universe"]
