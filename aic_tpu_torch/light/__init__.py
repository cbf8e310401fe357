"""Layer 1c: global illumination (port of `aic_tpu/light`)."""

from .chart import build_chart, generate_directions
from .dense import build_relight_ctx, evaluate_light_dense, relight_all_pass

__all__ = [
    "build_chart",
    "build_relight_ctx",
    "evaluate_light_dense",
    "generate_directions",
    "relight_all_pass",
]
