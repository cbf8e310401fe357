"""Color math (layer 0): sRGB encoding, torch port of `aic_tpu/math/color.py`.

Every public function of `aic_tpu`'s module, on tensors of any batch
shape, and the numpy twins that host content code and the renderer's
NO_WORLD fill call.
"""

from __future__ import annotations

import numpy as np
import torch

TRANSPARENT = np.zeros(4, np.float32)
WHITE = np.array([1, 1, 1, 1], np.float32)
BLACK = np.array([0, 0, 0, 1], np.float32)


def nonneg(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0)


def clamp01(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def reflect(rgba: torch.Tensor, illumination: torch.Tensor) -> torch.Tensor:
    """Light reflected by a surface: rgb * illumination * alpha
    (color.rs:707 `Rgba::reflect`). `rgba` is (..., 4), `illumination`
    (..., 3); returns (..., 3)."""
    return rgba[..., :3] * illumination * rgba[..., 3:4]


def srgb_encode(c: torch.Tensor) -> torch.Tensor:
    """Linear → sRGB gamma for color components (color.rs:1036)."""
    c = torch.clamp(c, min=0.0)
    return torch.where(
        c <= 0.0031308,
        c * (323.0 / 25.0),
        (211.0 * torch.pow(torch.clamp(c, min=1e-10), 5.0 / 12.0) - 11.0) / 200.0,
    )


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance of linear RGB (color.rs `Rgb::luminance`)."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def composite_over(light, transmittance, surface_light, surface_transmittance):
    """Front-to-back premultiplied-alpha accumulation
    (raytracer_components.rs:87 `ColorBuf::add_color_internal`): the new
    layer's light is scaled by the transmittance so far, then the
    transmittance is multiplied in. Returns (light', transmittance')."""
    return (
        light + surface_light * transmittance[..., None],
        transmittance * surface_transmittance,
    )


def linear_to_srgb8(rgb: torch.Tensor) -> torch.Tensor:
    """float linear components → u8 sRGB (color.rs:1049)."""
    return torch.clamp(torch.round(srgb_encode(rgb) * 255.0), 0, 255).to(torch.uint8)


def srgb_decode(c: torch.Tensor) -> torch.Tensor:
    """sRGB → linear for color components (color.rs:1066)."""
    c = nonneg(c)
    return torch.where(
        c <= 0.04045,
        c * (25.0 / 323.0),
        torch.pow((200.0 * c + 11.0) / 211.0, 12.0 / 5.0),
    )


def srgb8_to_linear(rgb8: torch.Tensor) -> torch.Tensor:
    return srgb_decode(torch.as_tensor(rgb8).to(torch.float32) / 255.0)


def np_srgb8_to_linear(rgb8) -> np.ndarray:
    """Host-side (numpy) sRGB u8 → linear float, for content generation."""
    c = np.asarray(rgb8, np.float64) / 255.0
    out = np.where(c <= 0.04045, c * (25.0 / 323.0), ((200.0 * c + 11.0) / 211.0) ** (12.0 / 5.0))
    return out.astype(np.float32)


def np_linear_to_srgb8(rgb) -> np.ndarray:
    c = np.maximum(np.asarray(rgb, np.float64), 0.0)
    out = np.where(c <= 0.0031308, c * (323.0 / 25.0), (211.0 * c ** (5.0 / 12.0) - 11.0) / 200.0)
    return np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)
