"""Layer 1c: global illumination (port of `aic_tpu/light`)."""

from .chart import build_chart, generate_directions
from .dense import (
    build_relight_ctx,
    evaluate_light_dense,
    relight_all,
    relight_all_pass,
    relight_all_pass_sharded,
)
from .update import evaluate_light, light_update_round, relight_batch

__all__ = [
    "build_chart",
    "build_relight_ctx",
    "evaluate_light",
    "evaluate_light_dense",
    "generate_directions",
    "light_update_round",
    "relight_all",
    "relight_all_pass",
    "relight_all_pass_sharded",
    "relight_batch",
]
