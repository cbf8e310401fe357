"""Debug line overlays: world-space wireframes drawn over rendered frames.

A copy of `aic_tpu/raytrace/lines.py` (numpy only), so that the port
imports nothing of `aic_tpu`.

Role of the reference's debug-lines pipeline
(all-is-cubes-gpu/src/in_wgpu — the `lines` vertex buffer drawn over the
scene; fed by `Cursor` wireframes and physics debug boxes,
all-is-cubes/src/math/lines.rs `wireframe_points`). Re-design: with the
raytracer as the renderer there is no rasterizer pass, so segments are
projected through the same camera matrix and drawn host-side into the
finished sRGB frame with an anti-alias-free Bresenham — debug overlays
are diagnostics, not content.
"""

from __future__ import annotations

import numpy as np


def wireframe_box(lower, upper) -> np.ndarray:
    """The 12 edges of an axis-aligned box: f64[12,2,3]
    (math/lines.rs `Aab::wireframe_points` role)."""
    lo = np.asarray(lower, np.float64)
    hi = np.asarray(upper, np.float64)
    c = lambda x, y, z: np.array(
        [hi[0] if x else lo[0], hi[1] if y else lo[1], hi[2] if z else lo[2]]
    )
    edges = []
    for axis in range(3):
        for a in (0, 1):
            for b in (0, 1):
                p0 = [0, 0, 0]
                p1 = [0, 0, 0]
                p0[axis], p1[axis] = 0, 1
                other = [i for i in range(3) if i != axis]
                p0[other[0]] = p1[other[0]] = a
                p0[other[1]] = p1[other[1]] = b
                edges.append((c(*p0), c(*p1)))
    return np.asarray(edges)


def cursor_wireframe(cube) -> np.ndarray:
    """Slightly inflated box around a targeted cube (the reference's
    cursor highlight, gpu cursor lines)."""
    c = np.asarray(cube, np.float64)
    eps = 0.01
    return wireframe_box(c - eps, c + 1.0 + eps)


def project_segments(camera, segments: np.ndarray):
    """World segments f64[N,2,3] → pixel segments f64[M,2,2] (x, y),
    clipping segments that cross behind the near plane."""
    m = np.linalg.inv(camera.inverse_projection_view)
    w, h = camera.viewport.width, camera.viewport.height
    pts = np.asarray(segments, np.float64).reshape(-1, 3)
    homo = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ m.T
    out = []
    for i in range(0, len(homo), 2):
        a, b = homo[i], homo[i + 1]
        # Clip to w > epsilon (near plane).
        wa, wb = a[3], b[3]
        if wa <= 1e-9 and wb <= 1e-9:
            continue
        if wa <= 1e-9 or wb <= 1e-9:
            t = (1e-9 - wa) / (wb - wa)
            p = a + (b - a) * t
            if wa <= 1e-9:
                a = p
            else:
                b = p
        pa = a[:3] / a[3]
        pb = b[:3] / b[3]
        to_px = lambda p: (
            (p[0] * 0.5 + 0.5) * w - 0.5,
            (0.5 - p[1] * 0.5) * h - 0.5,
        )
        out.append((to_px(pa), to_px(pb)))
    return np.asarray(out, np.float64).reshape(-1, 2, 2)


def _clip_to_rect(x0, y0, x1, y1, w, h):
    """Liang–Barsky clip of a segment to [0,w)×[0,h). Returns clipped
    endpoints or None. Near-plane-clipped segments can project to ±1e9
    px; without this, rasterization would try to allocate that many
    steps."""
    dx, dy = x1 - x0, y1 - y0
    t0, t1 = 0.0, 1.0
    for p, q in (
        (-dx, x0),
        (dx, w - 1 - x0),
        (-dy, y0),
        (dy, h - 1 - y0),
    ):
        if p == 0:
            if q < 0:
                return None
            continue
        r = q / p
        if p < 0:
            if r > t1:
                return None
            t0 = max(t0, r)
        else:
            if r < t0:
                return None
            t1 = min(t1, r)
    return (x0 + dx * t0, y0 + dy * t0, x0 + dx * t1, y0 + dy * t1)


def draw_segments(image: np.ndarray, px_segments, color=(255, 255, 255)) -> None:
    """Bresenham the pixel segments into an sRGB(A) image in place."""
    h, w = image.shape[:2]
    color = np.asarray(color, image.dtype)
    for (x0, y0), (x1, y1) in np.asarray(px_segments, np.float64):
        clipped = _clip_to_rect(x0, y0, x1, y1, w, h)
        if clipped is None:
            continue
        x0, y0, x1, y1 = clipped
        n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
        xs = np.round(np.linspace(x0, x1, n)).astype(int)
        ys = np.round(np.linspace(y0, y1, n)).astype(int)
        keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        image[ys[keep], xs[keep], : len(color)] = color


def overlay_wireframes(image: np.ndarray, camera, segment_sets) -> np.ndarray:
    """Draw each (segments f64[N,2,3], rgb) set over `image` (copied)."""
    out = image.copy()
    for segments, color in segment_sets:
        if len(segments):
            draw_segments(out, project_segments(camera, segments), color)
    return out


def draw_segments_depth(
    image: np.ndarray, camera, segments: np.ndarray, color, scene_dist: np.ndarray
) -> None:
    """Depth-tested world-space line drawing (the wgpu lines pipeline
    draws cursor/debug lines WITH the scene depth buffer, so hidden
    edges are occluded — all-is-cubes-gpu lines pass).

    segments: f64[N,2,3] world space; scene_dist: f32[H,W] eye distance
    of the first surface per pixel (+inf for misses). Each segment is
    sampled densely in world space; each sample is projected and plotted
    only when its eye distance passes the depth test (small relative
    bias, the analog of the geometry's own z-fighting offset)."""
    h, w = image.shape[:2]
    color = np.asarray(color, image.dtype)
    m = np.linalg.inv(camera.inverse_projection_view)
    eye = np.asarray(camera.view_position, np.float64)
    for a, b in np.asarray(segments, np.float64):
        ha = m @ np.append(a, 1.0)
        hb = m @ np.append(b, 1.0)
        if ha[3] <= 1e-9 and hb[3] <= 1e-9:
            continue
        # Estimate pixel length from (near-clipped) endpoints.
        def _px(hp):
            p = hp[:3] / hp[3]
            return np.array(
                [(p[0] * 0.5 + 0.5) * w - 0.5, (0.5 - p[1] * 0.5) * h - 0.5]
            )
        ca, cb = ha, hb
        if ca[3] <= 1e-9 or cb[3] <= 1e-9:
            t = (1e-9 - ca[3]) / (cb[3] - ca[3])
            p = ca + (cb - ca) * t
            ca, cb = (p, cb) if ca[3] <= 1e-9 else (ca, p)
        n = int(np.clip(np.abs(_px(cb) - _px(ca)).max() * 2 + 2, 2, 4 * (w + h)))
        ts = np.linspace(0.0, 1.0, n)
        pts = a[None, :] + (b - a)[None, :] * ts[:, None]
        homo = np.concatenate([pts, np.ones((n, 1))], axis=1) @ m.T
        ok = homo[:, 3] > 1e-9
        ndc = homo[ok, :3] / homo[ok, 3:4]
        xs = np.round((ndc[:, 0] * 0.5 + 0.5) * w - 0.5).astype(int)
        ys = np.round((0.5 - ndc[:, 1] * 0.5) * h - 0.5).astype(int)
        dist = np.linalg.norm(pts[ok] - eye, axis=1)
        keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        xs, ys, dist = xs[keep], ys[keep], dist[keep]
        vis = dist <= scene_dist[ys, xs] * 1.001 + 1e-3
        image[ys[vis], xs[vis], : len(color)] = color
