"""Image-comparison harness: perceptual diff + golden images.

Port of `aic_tpu/testing/imagecmp.py` (the reference's renderer-
conformance apparatus: the `rendiff` differ with per-case `Threshold`s,
test-renderers/types/src/comparison.rs:157-263, and golden images in
expected/), with the same numbers. The differ tolerates one-pixel edge
shifts: a pixel counts as equal if it is within `delta` of *any* pixel in
the 3×3 neighborhood of the other image (both directions), so
antialiasing and rounding differences at silhouettes don't fail cases.

Goldens are read by `raytrace.render.decode_png` and recorded by
`encode_png`; no imaging library.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Threshold:
    """comparison.rs Threshold: how many pixels may differ by how much."""

    max_differing_fraction: float = 0.01
    delta: int = 4  # per-channel u8 tolerance after neighborhood matching

    @staticmethod
    def strict() -> "Threshold":
        return Threshold(0.0, 0)


def _neighborhood_min_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-pixel max-channel difference of `a` against the best-matching
    pixel in b's 3×3 neighborhood."""
    h, w, c = a.shape
    best = np.full((h, w), 255, np.int32)
    bp = np.pad(b.astype(np.int32), ((1, 1), (1, 1), (0, 0)), mode="edge")
    ai = a.astype(np.int32)
    for dy in range(3):
        for dx in range(3):
            cand = bp[dy : dy + h, dx : dx + w]
            diff = np.abs(ai - cand).max(axis=-1)
            best = np.minimum(best, diff)
    return best


def diff_images(a: np.ndarray, b: np.ndarray) -> dict:
    """Symmetric neighborhood-tolerant diff. Returns stats dict."""
    assert a.shape == b.shape, f"shape mismatch {a.shape} vs {b.shape}"
    d_ab = _neighborhood_min_diff(a, b)
    d_ba = _neighborhood_min_diff(b, a)
    d = np.maximum(d_ab, d_ba)
    return {
        "max_delta": int(d.max()) if d.size else 0,
        "mean_delta": float(d.mean()) if d.size else 0.0,
        "histogram": np.bincount(np.clip(d.reshape(-1), 0, 255), minlength=256),
        "deltas": d,
    }


def images_match(a: np.ndarray, b: np.ndarray, threshold: Threshold) -> tuple[bool, str]:
    stats = diff_images(a, b)
    differing = (stats["deltas"] > threshold.delta).mean()
    ok = differing <= threshold.max_differing_fraction
    msg = (
        f"differing={differing:.4%} (allowed {threshold.max_differing_fraction:.4%}), "
        f"max_delta={stats['max_delta']}, mean={stats['mean_delta']:.2f}"
    )
    return ok, msg


def _as_channels(img: np.ndarray, channels: int) -> np.ndarray:
    """A decoded PNG (1-4 channels) as RGB or RGBA, as PIL's
    `convert("RGB" / "RGBA")` gives it: grey repeated, alpha 255 where
    the file has none, dropped where the image has none."""
    c = img.shape[-1]
    rgb = np.repeat(img[..., :1], 3, axis=-1) if c <= 2 else img[..., :3]
    if channels == 3:
        return np.ascontiguousarray(rgb)
    alpha = img[..., -1:] if c in (2, 4) else np.full(img.shape[:2] + (1,), 255, np.uint8)
    return np.concatenate([rgb, alpha], axis=-1)


def compare_to_golden(
    image: np.ndarray,
    golden_path: str,
    threshold: Threshold = Threshold(),
    record_env: str = "AIC_RECORD_GOLDENS",
) -> tuple[bool, str]:
    """Compare against a stored golden PNG; record it when missing or when
    the record env var is set (harness.rs-style record mode)."""
    from ..raytrace.render import decode_png, encode_png

    record = os.environ.get(record_env) or not os.path.exists(golden_path)
    if record:
        os.makedirs(os.path.dirname(golden_path), exist_ok=True)
        with open(golden_path, "wb") as f:
            f.write(encode_png(image))
        return True, f"recorded golden {golden_path}"
    with open(golden_path, "rb") as f:
        golden = _as_channels(decode_png(f.read()), 4 if image.shape[-1] == 4 else 3)
    return images_match(image, golden, threshold)
