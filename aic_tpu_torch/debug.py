"""Visual-debugging dumps (role of the reference's rerun glue).

Port of `aic_tpu/debug.py`. The reference optionally streams sim state,
light values, and mesh visualizations to the Rerun viewer
(`rerun_glue.rs`, gpu/rerun_image.rs, mesh viz). There is no viewer
here, so the same diagnostics are rendered to PNG sheets + JSON,
viewable anywhere; each reads a `SpaceState` tensor with one `.cpu()`,
and the PNGs are written without an imaging library (`encode_png`):

  dump_state(state, dir) writes
    light_slices.png   — per-Y slice sheet of decoded light (status-tinted)
    skip_slices.png    — per-Y slice sheet of the traversal skip field
    ortho_views.png    — axis-aligned renders from +X/+Y/+Z
    state.json         — shapes, palette stats, dirty counts, step info
"""

from __future__ import annotations

import json
import os

import numpy as np

from .math import faces, lightpack


def _slice_sheet(vol_rgb: np.ndarray, cols: int = 8, scale: int = 3) -> np.ndarray:
    """[X,Y,Z,3] u8 → one image tiling the Y slices (top-down maps)."""
    x, y, z, _ = vol_rgb.shape
    cols = min(cols, y)
    rows = (y + cols - 1) // cols
    sheet = np.zeros((rows * (z + 1), cols * (x + 1), 3), np.uint8)
    for yi in range(y):
        r, c = divmod(yi, cols)
        sheet[r * (z + 1) : r * (z + 1) + z, c * (x + 1) : c * (x + 1) + x] = (
            vol_rgb[:, yi, :, :].transpose(1, 0, 2)[::-1]
        )
    return np.repeat(np.repeat(sheet, scale, 0), scale, 1)


def light_slice_image(state) -> np.ndarray:
    """Decoded light, tinted by status: magenta = uninitialized,
    dark blue = NO_RAYS, grey = opaque (the light-debug coloring of the
    reference's rerun light view)."""
    light = state.light.cpu().numpy()
    rgb = lightpack.np_decode_scalar(light[..., :3])
    img = np.clip(np.sqrt(np.clip(rgb, 0, 4) / 4.0) * 255, 0, 255).astype(np.uint8)
    status = light[..., 3]
    img[status == lightpack.STATUS_UNINITIALIZED] = (255, 0, 255)
    img[status == lightpack.STATUS_NO_RAYS] = (10, 10, 60)
    img[status == lightpack.STATUS_OPAQUE] = (70, 70, 70)
    return img


def skip_slice_image(state) -> np.ndarray:
    """Traversal skip-distance field as heat (red = surface, blue = far)."""
    from .raytrace.accel import SKIP_MASK, SKIP_SHIFT, brick_dims

    # Un-brick the space cells back to [X,Y,Z].
    shape = tuple(state.contents.shape)
    sbd = brick_dims(shape)
    n_sb = int(np.prod(sbd))
    rows = state.cells[:n_sb].cpu().numpy().reshape(sbd + (4, 4, 4))
    cells = rows.transpose(0, 3, 1, 4, 2, 5).reshape(sbd[0] * 4, sbd[1] * 4, sbd[2] * 4)[
        : shape[0], : shape[1], : shape[2]
    ]
    skip = (cells >> SKIP_SHIFT) & SKIP_MASK
    t = np.clip(skip / 15.0, 0, 1)[..., None]
    img = (np.array([255, 40, 40]) * (1 - t) + np.array([40, 80, 255]) * t).astype(np.uint8)
    return img


def dump_state(state, out_dir: str, step_info=None) -> dict:
    """Write the diagnostic sheet set; returns the paths written."""
    from .raytrace.ortho import render_orthographic_views
    from .raytrace.render import encode_png

    os.makedirs(out_dir, exist_ok=True)
    paths = {}

    def write_png(name, img):
        p = os.path.join(out_dir, f"{name}.png")
        with open(p, "wb") as f:
            f.write(encode_png(img))
        paths[name] = p

    write_png("light_slices", _slice_sheet(light_slice_image(state)))
    write_png("skip_slices", _slice_sheet(skip_slice_image(state)))

    views = render_orthographic_views(state, (faces.PX, faces.PY, faces.PZ), scale=3)
    h = max(v.data.shape[0] for v in views.values())
    w = sum(v.data.shape[1] + 2 for v in views.values())
    sheet = np.zeros((h, w, 4), np.uint8)
    x0 = 0
    for f, v in views.items():
        sheet[: v.data.shape[0], x0 : x0 + v.data.shape[1]] = v.data
        x0 += v.data.shape[1] + 2
    write_png("ortho_views", sheet)

    light = state.light.cpu().numpy()
    info = dict(
        size=list(state.contents.shape),
        palette_padded=int(state.tables.padded_palette_size),
        voxel_resolution=int(state.tables.padded_voxel_resolution),
        light_dirty=int((state.light_dirty > 0).sum().item()),
        light_status_counts={
            "uninitialized": int((light[..., 3] == 0).sum()),
            "no_rays": int((light[..., 3] == 1).sum()),
            "opaque": int((light[..., 3] == 128).sum()),
            "visible": int((light[..., 3] == 255).sum()),
        },
        step_info=step_info.__dict__ if step_info is not None else None,
    )
    p = os.path.join(out_dir, "state.json")
    with open(p, "w") as f:
        json.dump(info, f, indent=1)
    paths["state"] = p
    return paths
