"""Full-frame renderer: camera + megakernel tracer + frame finish → image.

Port of `aic_tpu/raytrace/render.py` (the reference's `RtRenderer::draw`,
all-is-cubes-render/src/raytracer/renderer.rs:183,543-556): per-pixel
rays, traced by `trace_kernel.trace_rays_kernel`, then bloom, exposure,
tone mapping and sRGB. The tracer is the megakernel where its tables fit
and the v1 surface finder elsewhere, each the CUDA kernel for a state on
the card and its plain twin on the CPU (`aic_tpu`'s 2^19-ray threshold
for its XLA tracer is a TPU measurement, and that tracer is not ported
yet).

Not ported yet: bounce lighting, depth and pixel-cost renders, and
windowing of states larger than the megakernel's 4096 regions.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from ..math.color import linear_to_srgb8
from ..space.state import SpaceState
from .camera import Camera
from .trace_kernel import trace_rays_kernel


@dataclass
class Rendering:
    """render/headless.rs Rendering: size + RGBA data + flaws."""

    width: int
    height: int
    data: np.ndarray  # u8[H,W,4] sRGB
    flaws: tuple[str, ...] = ()


def render_hdr(state: SpaceState, camera: Camera):
    """Trace the frame, sky included; returns (HDR linear light
    f32[H,W,3], transmittance f32[H,W], unfinished bool) on the state's
    device."""
    opts = camera.options
    if opts.lighting_display == "bounce":
        raise NotImplementedError("bounce lighting is not ported yet")
    aa = opts.antialiasing
    origins, directions = camera.pixel_rays(supersample=aa, device=state.device)
    light, trans, unfinished = trace_rays_kernel(state, origins, directions, opts)
    if aa:
        light = light.mean(dim=2)  # mean over the 4 sub-pixels (accum.rs mean)
        trans = trans.mean(dim=2)
    return light, trans, unfinished


def _bilerp(img, ys, xs):
    """Clamp-to-edge bilinear sample of img[H,W,C] at continuous texel
    coords (texel centers at k+0.5), vectorized over ys[...]/xs[...]."""
    h, w = img.shape[:2]
    y = torch.clamp(ys - 0.5, 0.0, h - 1.0)
    x = torch.clamp(xs - 0.5, 0.0, w - 1.0)
    y0 = torch.clamp(torch.floor(y).long(), 0, h - 1)
    x0 = torch.clamp(torch.floor(x).long(), 0, w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fy = (y - y0)[..., None]
    fx = (x - x0)[..., None]
    return (
        img[y0][:, x0] * (1 - fy[:, None]) * (1 - fx[None, :])
        + img[y0][:, x1] * (1 - fy[:, None]) * fx[None, :]
        + img[y1][:, x0] * fy[:, None] * (1 - fx[None, :])
        + img[y1][:, x1] * fy[:, None] * fx[None, :]
    )


def _stage_sample(src, out_h, out_w, dy, dx):
    """Sample `src` at the centers of an out_h×out_w grid offset by
    (dy, dx) OUTPUT texels, mapped into src texel coords (the shaders'
    `input_pixel`, resampling.wgsl:71)."""
    sh, sw = src.shape[:2]
    dev = src.device
    ys = (torch.arange(out_h, device=dev, dtype=torch.float32) + 0.5 + dy) * (sh / out_h)
    xs = (torch.arange(out_w, device=dev, dtype=torch.float32) + 0.5 + dx) * (sw / out_w)
    return _bilerp(src, ys, xs)


def apply_bloom(light, intensity: float):
    """Bloom as the reference wgpu pipeline computes it (gpu/src/bloom.rs:
    base = framebuffer/2, 6 mip levels, 3 repetitions; resampling.wgsl:91
    5-tap downsample, :101 9-tap upsample + higher-stage blend 5·1.5^−stage;
    postprocess.wgsl:149 mix by intensity)."""
    if intensity <= 0.0:
        return light

    h, w = light.shape[:2]
    base_h, base_w = -(-h // 2), -(-w // 2)
    levels = min(6, int(np.log2(max(min(base_h, base_w), 1))) + 1)
    div = 1 << levels
    base_h = -(-base_h // div) * div
    base_w = -(-base_w // div) * div
    sizes = [(base_h >> k, base_w >> k) for k in range(levels)]

    def downsample(src, oh, ow):
        return (
            0.5 * _stage_sample(src, oh, ow, 0.0, 0.0)
            + 0.125 * _stage_sample(src, oh, ow, 0.5, 0.5)
            + 0.125 * _stage_sample(src, oh, ow, 0.5, -0.5)
            + 0.125 * _stage_sample(src, oh, ow, -0.5, 0.5)
            + 0.125 * _stage_sample(src, oh, ow, -0.5, -0.5)
        )

    def upsample(src, higher, oh, ow, stage):
        hw = 5.0 * (1.5 ** -float(stage))
        acc = (
            2.0 * _stage_sample(src, oh, ow, 0.5, 0.5)
            + 2.0 * _stage_sample(src, oh, ow, 0.5, -0.5)
            + 2.0 * _stage_sample(src, oh, ow, -0.5, 0.5)
            + 2.0 * _stage_sample(src, oh, ow, -0.5, -0.5)
            + _stage_sample(src, oh, ow, 1.0, 0.0)
            + _stage_sample(src, oh, ow, -1.0, 0.0)
            + _stage_sample(src, oh, ow, 0.0, 1.0)
            + _stage_sample(src, oh, ow, 0.0, -1.0)
            + hw * _stage_sample(higher, oh, ow, 0.0, 0.0)
        )
        return acc / (12.0 + hw)

    mips = [None] * levels
    for rep in range(3):
        for k in range(levels):
            if rep != 0 and k == 0:
                continue  # keep the previous repetition's upsampled mip 0
            src = light if k == 0 else mips[k - 1]
            mips[k] = downsample(src, *sizes[k])
        for k in range(levels - 2, -1, -1):
            higher = mips[k - 1] if k > 0 else mips[k + 1]
            mips[k] = upsample(mips[k + 1], higher, *sizes[k], stage=k)

    bloom = _stage_sample(mips[0], h, w, 0.0, 0.0)
    return light * (1.0 - intensity) + bloom * intensity


def finish_frame(light, trans, exposure: float, options) -> torch.Tensor:
    """Bloom + exposure/tone-map + sRGB + alpha → u8[H,W,4] on the device
    (`aic_tpu` `_finish_frame`)."""
    if options.bloom_intensity > 0.0:
        light = apply_bloom(light, options.bloom_intensity)
    rgb = light * exposure
    maxi = options.maximum_intensity
    if np.isfinite(maxi):
        if options.tone_mapping == "reinhard":
            lum = rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722
            rgb = rgb / (1.0 + lum / maxi)[..., None]
        else:
            rgb = torch.clamp(rgb, max=maxi)
    srgb = linear_to_srgb8(rgb)
    alpha = torch.clamp(torch.round((1.0 - trans) * 255.0), 0, 255).to(torch.uint8)
    return torch.cat([srgb, alpha[..., None]], dim=-1)


def render(state: SpaceState, camera: Camera) -> Rendering:
    """Render to an sRGB image (host). Imperfections are reported in
    Rendering.flaws (flaws.rs contract), never silently dropped.

    `GraphicsOptions.debug_pixel_cost` asks `aic_tpu` for its pixel-cost
    image (render.py:222-223), which is not ported yet (ROADMAP A12):
    raises NotImplementedError rather than return a shaded frame."""
    if camera.options.debug_pixel_cost:
        raise NotImplementedError("the pixel-cost debug render is not ported yet")
    vp = camera.viewport
    if vp.is_empty():
        return Rendering(vp.width, vp.height, np.zeros((vp.height, vp.width, 4), np.uint8))
    light, trans, unfinished = render_hdr(state, camera)
    flaws = ("UNFINISHED",) if unfinished else ()
    img = finish_frame(light, trans, float(camera.exposure), camera.options)
    return Rendering(vp.width, vp.height, img.cpu().numpy(), flaws)


def save_png(rendering: Rendering, path: str) -> None:
    """Write the RGBA image as a PNG (zlib + struct; no imaging library)."""
    data = np.ascontiguousarray(rendering.data, np.uint8)
    h, w = data.shape[:2]
    raw = b"".join(b"\x00" + data[y].tobytes() for y in range(h))

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (
            struct.pack(">I", len(body))
            + kind
            + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)
        )

    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)
