"""Layer 3: application session and frontends (port of `aic_tpu/apps`;
reference: all-is-cubes-ui/src/apps)."""

from .session import FrameClock, InputState, Session

__all__ = ["FrameClock", "InputState", "Session"]
