"""Layer 1d: body physics (port of `aic_tpu/physics`)."""

from .body import Body, body_from_numpy, body_to_numpy, step_bodies

__all__ = ["Body", "body_from_numpy", "body_to_numpy", "step_bodies"]
