"""Headless renderer with layers, overlays, and session-follow semantics.

Port of `aic_tpu/raytrace/renderer.py`: the layers are traced and
composited on the world state's device (`render_hdr` picks each layer's
tracer), post-processed there, and the frame comes to the host for the
cursor lines and the info text. The UI layer is whatever snapshotted
`Space` the caller gives `UiViewState`.

The analog of the reference's `RtRenderer` + `StandardCameras` + headless
`HeadlessRenderer` stack (all-is-cubes-render/src/raytracer/renderer.rs,
camera/stdcam.rs, headless.rs):

- **Layers** (renderer.rs:454-478 trace_ray_through_layers): the UI layer
  is traced first (front), then the world; any pixel that is still not
  opaque after all layers is REPLACED with `palette::NO_WORLD_TO_SHOW`
  (sRGB 0xBC grey, palette.rs:76) before post-processing, so exposure and
  tone mapping apply to it like any scene color.
- **Overlays** (headless.rs Overlays): a `Cursor` drawn as the reference's
  cursor wireframe (character/cursor.rs:218-276: expanded block box +
  selected-face frame + entry-point diamond, CURSOR_OUTLINE black) — the
  reference's wgpu renderer draws these as line geometry; its CPU
  raytracer reports Flaws::NO_CURSOR instead (renderer.rs:298), so the
  golden images pin the wgpu behavior and we match *that* — and info
  text rastered with the system font (text/sysfont.py).
- **Follow semantics** (stdcam.rs:188-260): `StandardCameras` re-reads
  its sources on update(); switching characters or graphics options
  changes the next frame. Deleted members raise `RenderError` from
  update() while draw() still produces an image from the last snapshot
  (test-renderers cases error_character_gone / no_update).

Sources are plain values or zero-arg callables (the listen::Cell analog:
pass `lambda: cell_value` and mutate your variable).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..math import faces
from ..math.color import composite_over, linear_to_srgb8, np_srgb8_to_linear
from ..space.state import SpaceState
from .camera import Camera, look_at_transform
from .options import GraphicsOptions
from .render import Rendering, render_hdr

#: palette.rs:76 NO_WORLD_TO_SHOW = srgb[0xBC 0xBC 0xBC 0xFF].
NO_WORLD_TO_SHOW = np_srgb8_to_linear(np.array([0xBC, 0xBC, 0xBC]))

#: palette.rs:112 CURSOR_OUTLINE = srgb black.
CURSOR_OUTLINE = (0, 0, 0)


class RenderError(Exception):
    """HandleError analog: a member the renderer needs is gone."""


def _resolve(source):
    return source() if callable(source) else source


@dataclass
class UiViewState:
    """stdcam.rs:437 UiViewState: what to render for the UI layer."""

    state: Optional[SpaceState] = None  # snapshotted UI space
    view_transform: np.ndarray = None  # eye-to-world 4x4 (identity default)
    graphics_options: Optional[GraphicsOptions] = None
    #: Host Space object for cursor raycasts (optional; the snapshot
    #: alone suffices for rendering).
    space: object = None

    def __post_init__(self):
        if self.view_transform is None:
            self.view_transform = np.eye(4)


@dataclass
class CharacterSource:
    """Selects a character in a universe as the world-layer source."""

    universe: object
    name: str = "player"


@dataclass
class Layers:
    """stdcam.rs:21 Layers<T>."""

    world: object = None
    ui: object = None


class StandardCameras:
    """stdcam.rs:100: the bundle of camera state for world + UI layers."""

    def __init__(self, graphics_options, viewport, character, ui):
        self._options_source = graphics_options
        self._viewport_source = viewport
        self._character_source = character
        self._ui_source = ui
        self._cameras = None
        self.world_state: Optional[SpaceState] = None
        self.ui_state: Optional[SpaceState] = None
        self.options: GraphicsOptions = GraphicsOptions()
        self.update()

    @classmethod
    def from_constant_for_test(cls, options, viewport, universe, name=None):
        """stdcam.rs from_constant_for_test: constant sources, default
        character, no UI."""
        if name is None:
            name = next(iter(universe.characters), None)
        char = CharacterSource(universe, name) if name else None
        return cls(options, viewport, char, None)

    def update(self):
        """Re-read all sources (stdcam.rs:188). Raises RenderError when
        the character or its space has been deleted."""
        opts = _resolve(self._options_source)
        viewport = _resolve(self._viewport_source)
        self.options = opts

        char = _resolve(self._character_source)
        world_cam = Camera(opts, viewport)
        if char is not None:
            u, name = char.universe, char.name
            if name not in u.characters:
                raise RenderError(f"character {name!r} is gone")
            ch = u.characters[name]
            if ch.space_name not in u.spaces:
                raise RenderError(f"space {ch.space_name!r} is gone")
            self.world_state = u.get_state(ch.space_name)
            world_cam.set_view_transform(self._character_transform(u, ch))
        else:
            self.world_state = None

        ui = _resolve(self._ui_source)
        if ui is not None and ui.state is not None:
            self.ui_state = ui.state
            ui_opts = ui.graphics_options or opts
            ui_cam = Camera(ui_opts, viewport, eye_to_world=ui.view_transform)
        else:
            self.ui_state = None
            ui_cam = Camera(opts, viewport)
        self._cameras = Layers(world=world_cam, ui=ui_cam)

    @staticmethod
    def _character_transform(u, ch) -> np.ndarray:
        """View transform from the character (character.rs view()).

        When the character's space declares a spawn eye/look (the
        conformance cases' `Spawn::set_eye_position`), those take
        precedence; otherwise the body's position + 1.6 eye height and
        yaw/pitch are used (body.rs look semantics)."""
        sp = u.spaces[ch.space_name]
        eye = getattr(sp, "spawn_eye_position", None)
        look = getattr(sp, "spawn_look_direction", None)
        if eye is not None:
            eye = np.asarray(eye, np.float64)
            fwd = (
                np.asarray(look, np.float64)
                if look is not None
                else np.array([0.0, 0.0, -1.0])
            )
            return look_at_transform(eye, eye + fwd)
        pos = u.bodies.position[ch.body_index].cpu().numpy().astype(np.float64)
        eye = pos + np.array([0.0, 1.6, 0.0])
        yaw = float(u.bodies.yaw[ch.body_index])
        pitch = float(u.bodies.pitch[ch.body_index])
        cy, sy = np.cos(np.radians(yaw)), np.sin(np.radians(yaw))
        cp, spp = np.cos(np.radians(pitch)), np.sin(np.radians(pitch))
        fwd = np.array([-sy * cp, spp, -cy * cp])
        return look_at_transform(eye, eye + fwd)

    def cameras(self) -> Layers:
        return self._cameras

    def project_cursor(self, ndc_pos):
        """stdcam.rs:357 project_cursor: UI layer first (unlimited
        reach), then the character's world space (reach 6.0)."""
        from ..universe.cursor import cursor_raycast

        ui = _resolve(self._ui_source)
        if ui is not None and getattr(ui, "space", None) is not None:
            origin, direction = self._cameras.ui.project_ndc_into_world(
                np.asarray(ndc_pos, np.float64)
            )
            cur = cursor_raycast(ui.space, origin, direction, np.inf)
            if cur is not None:
                return cur
        char = _resolve(self._character_source)
        if char is not None:
            u, name = char.universe, char.name
            ch = u.characters.get(name)
            if ch is None or ch.space_name not in u.spaces:
                raise RenderError("character or space is gone")
            origin, direction = self._cameras.world.project_ndc_into_world(
                np.asarray(ndc_pos, np.float64)
            )
            return cursor_raycast(u.spaces[ch.space_name], origin, direction, 6.0)
        return None


@dataclass
class Overlays:
    """headless.rs Overlays: content drawn on top of the scene."""

    cursor: object = None
    info_text: Optional[str] = None


def cursor_wireframe_segments(cursor) -> np.ndarray:
    """cursor.rs:218 wireframe_points: f64[N,2,3] world-space segments.

    Expanded block box + selected-face frame + entry-point diamond. Our
    Evoxels store dense R^3 arrays, so voxels_bounds() is always the full
    cube (the reference notes its own box is 'often oversized')."""
    from .lines import wireframe_box

    segs = []
    cube = np.asarray(cursor.cube, np.float64)
    offset = 0.001 * float(cursor.distance_to_point)
    lo = cube - offset
    hi = cube + 1.0 + offset
    segs.append(wireframe_box(lo, hi))

    face = int(cursor.face)
    if face < 6:
        inset = 1.0 / 128.0
        flo = lo + inset
        fhi = hi - inset
        axis = face % 3
        coord = lo[axis] if face < 3 else hi[axis]
        flo[axis] = fhi[axis] = coord
        u_ax, v_ax = [a for a in range(3) if a != axis]
        # Build the 4-corner loop explicitly.
        corners = []
        for su, sv in ((0, 0), (0, 1), (1, 1), (1, 0)):
            p = flo.copy()
            p[u_ax] = fhi[u_ax] if su else flo[u_ax]
            p[v_ax] = fhi[v_ax] if sv else flo[v_ax]
            corners.append(p)
        segs.append(
            np.asarray(
                [(corners[k], corners[(k + 1) % 4]) for k in range(4)], np.float64
            )
        )

    if face < 6 and cursor.point_entered is not None:
        n = np.asarray(faces.FACE_NORMALS[face], np.float64)
        frame = np.asarray(faces.FACE_TANGENT_FRAMES[face], np.float64)
        u, v = frame[0], frame[1]
        center = np.asarray(cursor.point_entered, np.float64) + n * offset
        tips = [
            center + u / 32.0,
            center + v / 32.0,
            center - u / 32.0,
            center - v / 32.0,
        ]
        segs.append(
            np.asarray([(tips[k], tips[(k + 1) % 4]) for k in range(4)], np.float64)
        )
    return np.concatenate(segs, axis=0)


class RtRenderer:
    """renderer.rs RtRenderer + headless.rs HeadlessRenderer.

    update() snapshots the scene; draw() renders from the last snapshot
    (draw before any update produces the NO_WORLD fill — the no_update
    conformance case)."""

    def __init__(self, cameras: StandardCameras):
        self.cameras = cameras
        self._world_state = None
        self._ui_state = None
        self._cursor = None
        self._updated = False

    def update(self, cursor=None):
        """Refresh scene snapshots. Raises RenderError when a member the
        cameras follow has been deleted (renderer.rs update → HandleError)."""
        self.cameras.update()
        self._world_state = self.cameras.world_state
        self._ui_state = self.cameras.ui_state
        self._cursor = cursor
        self._updated = True

    def draw(self, info_text: str = "") -> Rendering:
        cams = self.cameras.cameras()
        world_cam: Camera = cams.world
        viewport = world_cam.viewport
        if viewport.is_empty():
            return Rendering(
                viewport.width,
                viewport.height,
                np.zeros((viewport.height, viewport.width, 4), np.uint8),
            )
        flaws: list[str] = []
        if not self._updated:
            flaws.append("INVOCATION")  # draw() without update()

        opts = self.cameras.options
        h, w = viewport.height, viewport.width
        dev = next(
            (s.device for s in (self._world_state, self._ui_state) if s is not None), torch.device("cpu")
        )
        light = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
        trans = torch.ones((h, w), dtype=torch.float32, device=dev)

        # UI layer first (front), no sky.
        if self._ui_state is not None and opts.show_ui:
            ui_light, ui_trans = render_hdr(self._ui_state, cams.ui, include_sky=False)
            light, trans = composite_over(light, trans, ui_light, ui_trans)

        if self._world_state is not None:
            w_light, w_trans = render_hdr(self._world_state, world_cam)
            light, trans = composite_over(light, trans, w_light, w_trans)

        # NO_WORLD fill for any pixel still not opaque (renderer.rs:475).
        not_opaque = trans >= 1.0 / 256.0
        fill = torch.as_tensor(NO_WORLD_TO_SHOW, dtype=torch.float32, device=dev)
        light = torch.where(not_opaque[..., None], fill, light)
        trans = torch.where(not_opaque, 0.0, trans)

        rgb = world_cam.post_process(light)
        alpha = torch.clamp(torch.round((1.0 - trans) * 255.0), 0, 255).to(torch.uint8)
        img = torch.cat([linear_to_srgb8(rgb), alpha[..., None]], dim=-1).cpu().numpy()

        if self._cursor is not None:
            # Depth-tested like the wgpu lines pass: hidden edges of the
            # wireframe are occluded by the scene. (Drawn over the UI
            # layer; no conformance case combines cursor + UI.)
            from .lines import draw_segments_depth
            from .render import render_depth

            segs = cursor_wireframe_segments(self._cursor)
            if self._world_state is not None:
                t = render_depth(self._world_state, world_cam).cpu().numpy()
                o, d = world_cam.pixel_rays(device="cpu")
                o, d = o.numpy().astype(np.float64), d.numpy().astype(np.float64)
                pts = o + d * np.where(np.isfinite(t), t, 0.0)[..., None]
                eye = np.asarray(world_cam.view_position, np.float64)
                scene_dist = np.where(
                    np.isfinite(t), np.linalg.norm(pts - eye, axis=-1), np.inf
                )
            else:
                scene_dist = np.full((h, w), np.inf)
            draw_segments_depth(img, world_cam, segs, CURSOR_OUTLINE, scene_dist)

        if info_text and opts.debug_info_text:
            from ..text.sysfont import draw_info_text

            draw_info_text(img, info_text)

        return Rendering(viewport.width, viewport.height, img, tuple(flaws))
