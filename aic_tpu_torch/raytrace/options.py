"""Graphics options (render configuration).

Copied unchanged from `aic_tpu/raytrace/options.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

Equivalent of the reference `GraphicsOptions`
(all-is-cubes/src/camera/graphics_options.rs:26-152). These are *static*
configuration: every option combination compiles to a specialized XLA
program (hashable frozen dataclass used as a jit static argument), which is
the TPU-native replacement for the reference's runtime branching.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

# LightingOption (graphics_options.rs:440)
LIGHT_NONE = "none"
LIGHT_FLAT = "flat"
LIGHT_LINEAR = "linear"
LIGHT_COARSE = "coarse"
LIGHT_SMOOTHSTEP = "smoothstep"
LIGHT_BOUNCE = "bounce"

# TransparencyOption (graphics_options.rs:502)
TRANSPARENCY_SURFACE = "surface"
TRANSPARENCY_VOLUMETRIC = "volumetric"
TRANSPARENCY_THRESHOLD = "threshold"

# FogOption
FOG_NONE = "none"
FOG_ABRUPT = "abrupt"
FOG_COMPROMISE = "compromise"
FOG_PHYSICAL = "physical"

TONE_CLAMP = "clamp"
TONE_REINHARD = "reinhard"


@dataclass(frozen=True)
class GraphicsOptions:
    fog: str = FOG_ABRUPT
    fov_y: float = 90.0
    tone_mapping: str = TONE_CLAMP
    maximum_intensity: float = float("inf")
    exposure: float = 1.0
    #: ExposureOption::Automatic (graphics_options.rs): the session adapts
    #: the camera's exposure to scene luminance each frame.
    exposure_auto: bool = False
    view_distance: float = 200.0
    lighting_display: str = LIGHT_LINEAR
    transparency: str = TRANSPARENCY_VOLUMETRIC
    transparency_threshold: float = 0.5
    bounce_samples: int = 8
    antialiasing: bool = False
    bloom_intensity: float = 0.125
    #: RenderMethod (graphics_options.rs:31): "preferred" lets the
    #: frontend choose; "mesh" forces the mesh path, "reference" the
    #: raytracer. Our headless session always raytraces; exporters use
    #: the mesh path — the field records the request for session logic.
    render_method: str = "preferred"
    #: Whether the HUD/UI layer is composited (graphics_options.rs:102).
    show_ui: bool = True
    #: Info-text overlay toggle (graphics_options.rs:108).
    debug_info_text: bool = True
    #: Debug overlays (graphics_options.rs:121-152), drawn as projected
    #: wireframes by the session (raytrace/lines.py).
    debug_behaviors: bool = False
    debug_chunk_boxes: bool = False
    debug_collision_boxes: bool = False
    debug_light_rays_at_cursor: bool = False
    #: Shade each pixel by its traversal step count instead of color
    #: (graphics_options.rs:145; our tracer counts loop steps per ray).
    debug_pixel_cost: bool = False
    #: Halve the view distance for culling/frustum debugging
    #: (graphics_options.rs:152).
    debug_reduce_view_frustum: bool = False

    @staticmethod
    def default() -> "GraphicsOptions":
        """graphics_options.rs:255 Default."""
        return GraphicsOptions()

    @staticmethod
    def unaltered_colors() -> "GraphicsOptions":
        """graphics_options.rs:169 UNALTERED_COLORS: rendered colors are
        exactly block colors."""
        return GraphicsOptions(
            fog=FOG_NONE,
            lighting_display=LIGHT_NONE,
            bloom_intensity=0.0,
        )

    def repair(self) -> "GraphicsOptions":
        """graphics_options.rs:196."""
        return replace(
            self,
            fov_y=min(max(self.fov_y, 1.0), 189.0),
            view_distance=min(max(self.view_distance, 1.0), 10000.0),
        )

    def fog_blend(self) -> float:
        """sr.rs:156 distance_fog_blend by FogOption."""
        return {FOG_ABRUPT: 1.0, FOG_COMPROMISE: 0.5}.get(self.fog, 0.0)
