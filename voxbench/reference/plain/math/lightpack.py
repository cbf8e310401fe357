"""PackedLight: logarithmic u8 light encoding + status channel (layer 0).

Torch port of `aic_tpu/math/lightpack.py` (the reference's `PackedLight`,
all-is-cubes/src/space/light/data.rs:51-69): each RGB component is stored
as ``round(log2(v) * 10 + 144)`` saturating-cast to u8, with a 4th status
byte. The encoded u8 codes are bit-exact with the JAX package; decoded
floats may differ from XLA's ``exp2`` in the last few ulps.

The numpy twins (`np_encode_scalar`, `np_decode_scalar`) serve host
content code exactly as in `aic_tpu`.
"""

from __future__ import annotations

import numpy as np
import torch

LOG_SCALE = 10.0
LOG_OFFSET = 144.0

STATUS_UNINITIALIZED = 0
STATUS_NO_RAYS = 1
STATUS_OPAQUE = 128
STATUS_VISIBLE = 255

#: Decode lookup table: exp2((v - 144) / 10), with table[0] = 0.
DECODE_TABLE = np.exp2((np.arange(256, dtype=np.float32) - LOG_OFFSET) / LOG_SCALE)
DECODE_TABLE[0] = 0.0
DECODE_TABLE = DECODE_TABLE.astype(np.float32)


def encode_scalar(v: torch.Tensor) -> torch.Tensor:
    """Linear light component (f32 >= 0) → u8 log scale (data.rs:213)."""
    v = torch.clamp(v.to(torch.float32), min=0.0)
    # log2(0) = -inf → clipped to 0, matching Rust's saturating `as u8`.
    raw = torch.round(torch.log2(v) * LOG_SCALE + LOG_OFFSET)
    raw = torch.nan_to_num(raw, nan=0.0, neginf=0.0, posinf=255.0)
    return torch.clamp(raw, 0, 255).to(torch.uint8)


def decode_scalar(u: torch.Tensor) -> torch.Tensor:
    """u8 log scale → linear light component (data.rs:222)."""
    u = u.to(torch.float32)
    return torch.where(
        u == 0.0, torch.zeros_like(u), torch.exp2((u - LOG_OFFSET) / LOG_SCALE)
    )


def encode_rgb(rgb: torch.Tensor, status: int = STATUS_VISIBLE) -> torch.Tensor:
    """(..., 3) linear RGB → (..., 4) packed texel with given status."""
    packed = encode_scalar(rgb)
    status_arr = torch.full(
        packed.shape[:-1] + (1,), status, dtype=torch.uint8, device=packed.device
    )
    return torch.cat([packed, status_arr], dim=-1)


def decode_rgb(texel: torch.Tensor) -> torch.Tensor:
    """(..., 4) packed texel → (..., 3) linear RGB (ignores status)."""
    return decode_scalar(texel[..., :3])


def decode_with_ao(texel: torch.Tensor) -> torch.Tensor:
    """(..., 4) texel → (..., 4) [r, g, b, weight] (data.rs:146
    `value_with_ambient_occlusion`): weight 1 for Visible, 0.25 for
    Opaque (the ambient-occlusion fudge), 0 otherwise."""
    status = texel[..., 3]
    weight = torch.where(
        status == STATUS_VISIBLE, 1.0, torch.where(status == STATUS_OPAQUE, 0.25, 0.0)
    ).to(torch.float32)
    return torch.cat([decode_rgb(texel), weight[..., None]], dim=-1)


def valid(texel: torch.Tensor) -> torch.Tensor:
    """Whether the stored light value is meaningful (data.rs:127)."""
    return texel[..., 3] == STATUS_VISIBLE


def difference_priority(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Max abs component difference incl. status flip (data.rs:193).

    Returns int32; 0 iff equal."""
    a = a.to(torch.int32)
    b = b.to(torch.int32)
    diff = (a[..., :3] - b[..., :3]).abs().amax(dim=-1)
    status_change = a[..., 3] != b[..., 3]
    return torch.where(status_change, torch.clamp(diff, min=255), diff)


# Host-side (numpy) variants for content generation / tests.
def np_encode_scalar(v) -> np.ndarray:
    v = np.maximum(np.asarray(v, np.float32), 0.0)
    with np.errstate(divide="ignore"):
        raw = np.round(np.log2(v) * LOG_SCALE + LOG_OFFSET)
    raw = np.nan_to_num(raw, nan=0.0, neginf=0.0, posinf=255.0)
    return np.clip(raw, 0, 255).astype(np.uint8)


def np_decode_scalar(u) -> np.ndarray:
    return DECODE_TABLE[np.asarray(u, np.int32)]
