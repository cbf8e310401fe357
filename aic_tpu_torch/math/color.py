"""Color math (layer 0): sRGB encoding, torch port of `aic_tpu/math/color.py`.

Only what the ported path uses is here: `linear_to_srgb8` for the frame
finish, and the numpy twins that host content code calls.
"""

from __future__ import annotations

import numpy as np
import torch


def srgb_encode(c: torch.Tensor) -> torch.Tensor:
    """Linear → sRGB gamma for color components (color.rs:1036)."""
    c = torch.clamp(c, min=0.0)
    return torch.where(
        c <= 0.0031308,
        c * (323.0 / 25.0),
        (211.0 * torch.pow(torch.clamp(c, min=1e-10), 5.0 / 12.0) - 11.0) / 200.0,
    )


def linear_to_srgb8(rgb: torch.Tensor) -> torch.Tensor:
    """float linear components → u8 sRGB (color.rs:1049)."""
    return torch.clamp(torch.round(srgb_encode(rgb) * 255.0), 0, 255).to(torch.uint8)


def np_srgb8_to_linear(rgb8) -> np.ndarray:
    """Host-side (numpy) sRGB u8 → linear float, for content generation."""
    c = np.asarray(rgb8, np.float64) / 255.0
    out = np.where(c <= 0.04045, c * (25.0 / 323.0), ((200.0 * c + 11.0) / 211.0) ** (12.0 / 5.0))
    return out.astype(np.float32)


def np_linear_to_srgb8(rgb) -> np.ndarray:
    c = np.maximum(np.asarray(rgb, np.float64), 0.0)
    out = np.where(c <= 0.0031308, c * (323.0 / 25.0), (211.0 * c ** (5.0 / 12.0) - 11.0) / 200.0)
    return np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)
