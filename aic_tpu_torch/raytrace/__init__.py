"""Layer 2a: raytrace rendering (port of `aic_tpu/raytrace`)."""

from .camera import Camera, Viewport, look_at_transform
from .options import GraphicsOptions
from .render import Rendering, decode_png, encode_png, print_space_ascii, render, render_hdr, save_png
from .trace_kernel import trace_rays_kernel
from .tracer import trace_rays

__all__ = [
    "Camera",
    "GraphicsOptions",
    "Rendering",
    "Viewport",
    "decode_png",
    "encode_png",
    "look_at_transform",
    "print_space_ascii",
    "render",
    "render_hdr",
    "save_png",
    "trace_rays",
    "trace_rays_kernel",
]
