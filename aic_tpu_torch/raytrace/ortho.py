"""Axis-aligned orthographic rendering (reference: raytracer/ortho.rs).

Port of `aic_tpu/raytrace/ortho.py`: parallel rays through a face of the
space bounds at a chosen pixel scale, traced by the general tracer on
the state's device; `render_orthographic_views` produces the
reference's multi-view debug sheet (one image per requested face).
"""

from __future__ import annotations

import numpy as np
import torch

from ..math import faces
from ..math.color import linear_to_srgb8
from ..space.state import SpaceState
from .camera import Camera, Viewport
from .options import GraphicsOptions
from .render import Rendering
from .tracer import trace_rays


def ortho_rays(state: SpaceState, face: int, scale: int = 4):
    """(origins, directions) f32[H,W,3] on the state's device: parallel
    rays looking at `face` of the space bounds from outside, `scale`
    pixels per cube."""
    size = state.contents.shape
    lower = np.asarray(state.lower, np.float64)
    upper = lower + np.asarray(size)
    n = np.asarray(faces.FACE_NORMALS[face], np.float64)
    axis = int(faces.FACE_AXES[face])
    u_axis, v_axis = [a for a in range(3) if a != axis]
    w_px = size[u_axis] * scale
    h_px = size[v_axis] * scale

    us = (np.arange(w_px) + 0.5) / scale + lower[u_axis]
    vs = (np.arange(h_px) + 0.5) / scale + lower[v_axis]
    uu, vv = np.meshgrid(us, vs[::-1])  # image row 0 = top
    origins = np.zeros((h_px, w_px, 3))
    origins[..., u_axis] = uu
    origins[..., v_axis] = vv
    # Start just outside the struck face, looking inward (direction = -n).
    origins[..., axis] = (upper[axis] + 0.5) if n[axis] > 0 else (lower[axis] - 0.5)
    directions = np.broadcast_to(-n, origins.shape)
    return (
        torch.as_tensor(origins.astype(np.float32), device=state.device),
        torch.as_tensor(directions.astype(np.float32), device=state.device),
    )


def render_orthographic(
    state: SpaceState,
    face: int = faces.PY,
    scale: int = 4,
    options: GraphicsOptions | None = None,
) -> Rendering:
    """One axis-aligned view (ortho.rs render_orthographic)."""
    options = options or GraphicsOptions(lighting_display="flat", fog="none", transparency="surface")
    origins, directions = ortho_rays(state, face, scale)
    light, trans = trace_rays(state, origins, directions, options)
    cam = Camera(options, Viewport(origins.shape[1], origins.shape[0]))
    srgb = linear_to_srgb8(cam.post_process(light))
    alpha = torch.clamp(torch.round((1.0 - trans) * 255.0), 0, 255).to(torch.uint8)
    img = torch.cat([srgb, alpha[..., None]], dim=-1).cpu().numpy()
    return Rendering(img.shape[1], img.shape[0], img)


def render_orthographic_views(state: SpaceState, view_faces=(faces.PX, faces.PY, faces.PZ), scale: int = 4):
    """Multi-view sheet (ortho.rs multi-view): dict face → Rendering."""
    return {f: render_orthographic(state, f, scale) for f in view_faces}
