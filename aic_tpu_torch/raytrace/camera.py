"""Camera: view/projection math and per-pixel ray generation.

Port of `aic_tpu/raytrace/camera.py`: unchanged host math in float64;
`pixel_rays` returns float32 torch tensors on the requested device, and
`post_process` (exposure, tone mapping) runs on the tensor's device.

Equivalent of reference `Camera`/`Viewport` (all-is-cubes/src/camera.rs:40,487):
a DirectX-style (0..1 depth) perspective projection (camera.rs:385-400)
combined with a rigid eye-to-world transform. Rays are produced exactly as
`project_ndc_into_world` (camera.rs:235): origin = unproject(ndc, 0) on the
near plane, direction = unproject(ndc, 1) − origin, so t ∈ [0, 1] spans
near→far and fog's `t_to_view_distance` falls out naturally.

Matrix setup happens on host in float64 (matching the reference's f64 ray
math where it matters most — matrix inversion); per-pixel ray generation is
a device computation in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .options import GraphicsOptions


@dataclass(frozen=True)
class Viewport:
    """Framebuffer size in pixels (camera.rs:487)."""

    width: int
    height: int

    @property
    def aspect(self) -> float:
        # Zero-size viewports are legal (camera.rs is_empty); aspect falls
        # back to 1 so matrix construction stays finite.
        if self.height <= 0 or self.width <= 0:
            return 1.0
        return self.width / self.height

    def is_empty(self) -> bool:
        """camera.rs:575 Viewport::is_empty."""
        return self.width <= 0 or self.height <= 0


def look_at_transform(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Eye-to-world 4x4: translation `eye`, -Z looking at `target`."""
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float64) - eye
    f = f / np.linalg.norm(f)
    up = np.asarray(up, np.float64)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[:3, 0] = s
    m[:3, 1] = u
    m[:3, 2] = -f
    m[:3, 3] = eye
    return m


class Camera:
    """View + projection state (camera.rs:40).

    `eye_to_world`: 4x4 rigid transform (column-vector convention, world =
    M @ eye). The camera looks along its local -Z.
    """

    def __init__(
        self,
        options: GraphicsOptions,
        viewport: Viewport,
        eye_to_world: Optional[np.ndarray] = None,
    ):
        self.options = options.repair()
        self.viewport = viewport
        self.eye_to_world = np.eye(4) if eye_to_world is None else np.asarray(eye_to_world)
        self.exposure = options.exposure
        self._compute()

    def set_view_transform(self, eye_to_world: np.ndarray):
        self.eye_to_world = np.asarray(eye_to_world, np.float64)
        self._compute()

    def look_at(self, eye, target, up=(0.0, 1.0, 0.0)):
        self.set_view_transform(look_at_transform(eye, target, up))

    @property
    def view_position(self) -> np.ndarray:
        return self.eye_to_world[:3, 3]

    def near_plane_distance(self) -> float:
        return 1.0 / 32.0  # camera.rs:199: half a voxel at resolution 16

    def set_measured_exposure(self, e: float):
        """camera.rs set_measured_exposure: only effective under
        automatic exposure with lighting enabled."""
        from .options import LIGHT_NONE

        if self.options.exposure_auto and self.options.lighting_display != LIGHT_NONE:
            self.exposure = float(e)

    def _compute(self):
        """camera.rs:384 compute_matrices."""
        fov_cot = 1.0 / np.tan(np.radians(self.options.fov_y) / 2.0)
        aspect = self.viewport.aspect
        near = self.near_plane_distance()
        far = self.options.view_distance
        if getattr(self.options, "debug_reduce_view_frustum", False):
            far = far / 2.0  # graphics_options.rs:152 debugging aid
        # Column-vector convention; clip = P @ eye. (The reference writes the
        # same matrix in row-vector form, camera.rs:396-401.)
        projection = np.array(
            [
                [fov_cot / aspect, 0, 0, 0],
                [0, fov_cot, 0, 0],
                [0, 0, far / (near - far), (far * near) / (near - far)],
                [0, 0, -1, 0],
            ],
            np.float64,
        )
        world_to_eye = np.linalg.inv(self.eye_to_world)
        self.inverse_projection_view = np.linalg.inv(projection @ world_to_eye)

    def project_ndc_into_world(self, ndc_xy: np.ndarray):
        """Host ray for one NDC point (camera.rs:235). Returns (origin, direction)."""
        near = self._unproject(np.append(ndc_xy, 0.0))
        far = self._unproject(np.append(ndc_xy, 1.0))
        return near, far - near

    def _unproject(self, ndc3):
        with np.errstate(invalid="ignore"):
            h = self.inverse_projection_view @ np.append(ndc3, 1.0)
            return h[:3] / h[3]

    def pixel_rays(self, supersample: bool = False, device="cuda"):
        """Tensors of per-pixel rays on `device` (the card unless the
        caller asks for the CPU): (origins, directions) f32[H,W,3].

        Pixel centers map to NDC exactly like the reference's
        `Viewport::normalize_nominal_point` (x right, y *up* in NDC, so row 0
        is the top of the image). With `supersample`, returns f32[H,W,4,3]
        of 2×2 sub-pixel rays (renderer.rs:426-451 antialiasing pattern).
        """
        w, h = self.viewport.width, self.viewport.height
        xs = (np.arange(w) + 0.5) / w * 2.0 - 1.0
        ys = 1.0 - (np.arange(h) + 0.5) / h * 2.0
        if supersample:
            # The reference ray renderer's rotated-grid sample points
            # within the pixel patch: (1/8,5/8), (3/8,1/8), (5/8,7/8),
            # (7/8,3/8) (renderer.rs:428-433), expressed as NDC offsets
            # from the pixel center (patch v axis points NDC-up).
            pts = np.array(
                [[1 / 8, 5 / 8], [3 / 8, 1 / 8], [5 / 8, 7 / 8], [7 / 8, 3 / 8]]
            )
            ox = (pts[:, 0] - 0.5) * 2.0 / w
            oy = (pts[:, 1] - 0.5) * -2.0 / h
            xg, yg = np.meshgrid(xs, ys, indexing="xy")
            ndc = np.stack(
                [xg[..., None] + ox, yg[..., None] + oy], axis=-1
            )  # [H,W,4,2]
        else:
            xg, yg = np.meshgrid(xs, ys, indexing="xy")
            ndc = np.stack([xg, yg], axis=-1)  # [H,W,2]

        m = self.inverse_projection_view
        ndc_flat = ndc.reshape(-1, 2)
        ones = np.ones((ndc_flat.shape[0], 1))
        near_h = (np.concatenate([ndc_flat, 0 * ones, ones], axis=1)) @ m.T
        far_h = (np.concatenate([ndc_flat, ones, ones], axis=1)) @ m.T
        near = near_h[:, :3] / near_h[:, 3:4]
        far = far_h[:, :3] / far_h[:, 3:4]
        origins = near.reshape(ndc.shape[:-1] + (3,))
        directions = (far - near).reshape(ndc.shape[:-1] + (3,))
        return (
            torch.as_tensor(origins.astype(np.float32), device=device),
            torch.as_tensor(directions.astype(np.float32), device=device),
        )

    def post_process(self, rgb: torch.Tensor) -> torch.Tensor:
        """camera.rs:373 post_process_color: exposure then tone mapping,
        on the tensor's device; rgb is (..., 3) HDR scene light."""
        rgb = rgb * float(self.exposure)
        maxi = self.options.maximum_intensity
        if not np.isfinite(maxi):
            # Without a finite maximum intensity no tone mapping occurs
            # (graphics_options.rs:362-366).
            return rgb
        if self.options.tone_mapping == "reinhard":
            # Luminance-based Reinhard (graphics_options.rs:373-376).
            lum = rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722
            return rgb / (1.0 + lum / float(maxi))[..., None]
        return torch.clamp(rgb, max=float(maxi))
