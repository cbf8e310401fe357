"""Full-frame renderer: camera + tracer + frame finish → image, and the
render API around it.

Port of `aic_tpu/raytrace/render.py` (the reference's `RtRenderer::draw`,
all-is-cubes-render/src/raytracer/renderer.rs:183,543-556): per-pixel
rays, traced, then bloom, exposure, tone mapping and sRGB. `render_hdr`
picks the tracer by what holds the state, before anything is launched
(`pick_tracer`): the megakernel (`trace_kernel.py`) where its tables fit,
else the v1 surface finder (`trace_kernel_v1.py`) where its tables hold
the state, else the general tracer (`tracer.trace_rays`), as `aic_tpu`
falls back to its XLA tracer; each kernel is the CUDA kernel for a state
on the card and its plain twin on the CPU. Bounce lighting goes through
`tracer.trace_rays_bounce`. `render` first cuts a state of more than
`AUTO_WINDOW_VOLUME` cubes down to the camera's view (`view_window`).

Also here, on the general tracer's outputs: the pixel-cost heatmap, the
depth image, per-phase hit folds, the ASCII print, scaled renders and
the auto-exposure target. `aic_tpu`'s 2^19-ray threshold for its XLA
tracer (`_use_pallas`) is a TPU measurement and is not ported.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from ..math.color import linear_to_srgb8, luminance
from ..space.state import SpaceState, visible_light_volume, window_state
from .camera import Camera, Viewport
from .trace_kernel import megakernel_fits, trace_rays_kernel
from .trace_kernel_v1 import v1_fits
from .tracer import HIT_NONE, trace_rays, trace_rays_bounce

#: Frames traced by each tracer in this process (`render_hdr`'s choice).
TRACES = {"megakernel": 0, "v1": 0, "general": 0, "bounce": 0}

#: Volume above which `render` windows the state to the camera's visible
#: volume before tracing (`aic_tpu` render.py:208): 2^24 cubes ≈ 256³.
AUTO_WINDOW_VOLUME = 1 << 24


@dataclass
class Rendering:
    """render/headless.rs Rendering: size + RGBA data + flaws."""

    width: int
    height: int
    data: np.ndarray  # u8[H,W,4] sRGB
    flaws: tuple[str, ...] = ()


def pick_tracer(state: SpaceState) -> str:
    """The tracer `render_hdr` sends a state to: "megakernel" where its
    tables fit, else "v1" where the v1 tables hold it, else "general"."""
    if megakernel_fits(state):
        return "megakernel"
    if v1_fits(state):
        return "v1"
    return "general"


def render_hdr(state: SpaceState, camera: Camera, include_sky: bool = True, with_stats: bool = False):
    """Trace the frame on the state's device; returns (HDR linear light
    f32[H,W,3], transmittance f32[H,W]), and with `with_stats` a stats
    dict ("unfinished", and the general tracer's "iters" and "walkers"),
    or None for bounce lighting."""
    opts = camera.options
    aa = opts.antialiasing
    origins, directions = camera.pixel_rays(supersample=aa, device=state.device)
    stats = None
    if opts.lighting_display == "bounce":
        TRACES["bounce"] += 1
        gen = torch.Generator(device=state.device)
        gen.manual_seed(0)
        light, trans = trace_rays_bounce(state, origins, directions, opts, gen, include_sky=include_sky)
    else:
        tracer = pick_tracer(state)
        TRACES[tracer] += 1
        if tracer == "general":
            out = trace_rays(state, origins, directions, opts, include_sky=include_sky,
                             return_stats=with_stats)
            light, trans = out[0], out[1]
            stats = out[2] if with_stats else None
        else:
            light, trans, unfinished = trace_rays_kernel(
                state, origins, directions, opts, megakernel=tracer == "megakernel",
                include_sky=include_sky,
            )
            stats = {"unfinished": unfinished}
    if aa:
        light = light.mean(dim=2)  # mean over the 4 sub-pixels (accum.rs mean)
        trans = trans.mean(dim=2)
    if with_stats:
        return light, trans, stats
    return light, trans


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


def auto_exposure_target(light: torch.Tensor) -> float:
    """Scene-adaptive exposure (character/exposure.rs:67): the target
    that maps the mean log luminance to middle grey."""
    mean_log = torch.log2(torch.clamp(luminance(light), min=1e-6)).mean()
    return float(0.5 / np.exp2(float(mean_log)))


def view_window(state: SpaceState, camera: Camera) -> SpaceState:
    """The state `render` traces: above `AUTO_WINDOW_VOLUME` cubes, the
    state cut to the camera's visible volume (`window_state`), else the
    state itself."""
    n_cubes = int(np.prod(state.contents.shape))
    if n_cubes <= AUTO_WINDOW_VOLUME:
        return state
    eye = np.asarray(camera.eye_to_world[:3, 3], np.float64)
    lo, hi = visible_light_volume(state, eye, camera.options.view_distance)
    if int(np.prod(np.asarray(hi) - np.asarray(lo))) < n_cubes:
        return window_state(state, lo, hi)
    return state


def render(state: SpaceState, camera: Camera, include_sky: bool = True) -> Rendering:
    """Render to an sRGB image (host). Imperfections are reported in
    Rendering.flaws (flaws.rs contract), never silently dropped:
    UNFINISHED where a ray used up its step budget. With
    `debug_pixel_cost` the image is the pixel-cost heatmap."""
    vp = camera.viewport
    if vp.is_empty():
        return Rendering(vp.width, vp.height, np.zeros((vp.height, vp.width, 4), np.uint8))
    if camera.options.debug_pixel_cost:
        return render_pixel_cost(state, camera)
    state = view_window(state, camera)
    flaws = ()
    if camera.options.lighting_display == "bounce":
        light, trans = render_hdr(state, camera, include_sky)
    else:
        light, trans, stats = render_hdr(state, camera, include_sky, with_stats=True)
        if bool(stats["unfinished"]):
            flaws = ("UNFINISHED",)
    img = finish_frame(light, trans, float(camera.exposure), camera.options)
    return Rendering(vp.width, vp.height, img.cpu().numpy(), flaws)


def render_pixel_cost(state: SpaceState, camera: Camera) -> Rendering:
    """debug_pixel_cost (graphics_options.rs:145): each pixel shaded by
    its traversal step count in the general tracer, a heatmap (black =
    cheap, white = expensive, red saturating first)."""
    origins, directions = camera.pixel_rays(device=state.device)
    _, _, steps = trace_rays(state, origins, directions, camera.options, count_steps=True)
    steps = steps.cpu().numpy().astype(np.float32)
    t = steps / max(float(steps.max()), 1.0)
    r = np.clip(t * 3.0, 0.0, 1.0)
    g = np.clip(t * 3.0 - 1.0, 0.0, 1.0)
    b = np.clip(t * 3.0 - 2.0, 0.0, 1.0)
    img = np.round(np.stack([r, g, b, np.ones_like(t)], axis=-1) * 255.0).astype(np.uint8)
    return Rendering(camera.viewport.width, camera.viewport.height, img)


def print_space_ascii(state: SpaceState, camera: Camera, chars: str = " .:-=+*#%@") -> str:
    """ASCII-art rendering, the analog of the reference's `print_space`
    terminal debugging (raytracer/text.rs)."""
    light, _ = render_hdr(state, camera)
    lum = luminance(light).cpu().numpy()
    lum = lum / max(lum.max(), 1e-6)
    idx = np.clip((lum * (len(chars) - 1)).round().astype(int), 0, len(chars) - 1)
    return "\n".join("".join(chars[i] for i in row) for row in idx)


def render_depth(state: SpaceState, camera: Camera) -> torch.Tensor:
    """Depth image f32[H,W] on the state's device: the t-distance (in
    units of the camera ray's near→far span) of the first surface per
    pixel, +inf on a miss (the DepthBuf accumulator, accum.rs:254-282),
    from the general tracer's first-phase hit buffer."""
    origins, directions = camera.pixel_rays(device=state.device)
    _, _, hits = trace_rays(state, origins, directions, camera.options, return_hits=True)
    shape = origins.shape[:-1]
    t = hits["hit_t"].reshape(shape)
    return torch.where(hits["hit_kind"].reshape(shape) == HIT_NONE, torch.inf, t)


def accumulate_hits(state: SpaceState, camera: Camera, fold, init):
    """Custom accumulation over the general tracer's per-phase hit
    buffers, the batch analog of the reference's `Accumulate` trait
    (accum.rs:108): `fold(acc, phase_hits)` is called once per phase with
    tensors over all rays (hit_kind, hit_idx, hit_vflat, hit_face,
    hit_cube, hit_t) and returns the new accumulator."""
    origins, directions = camera.pixel_rays(device=state.device)
    _, _, hits = trace_rays(state, origins, directions, camera.options, return_hits=True)
    acc = init
    for phase_hits in hits["phases"]:
        acc = fold(acc, phase_hits)
    return acc


def resample_frame(image, out_h: int, out_w: int, device=None) -> torch.Tensor:
    """Bilinear frame resample (gpu/src/shaders/resampling.wgsl's
    scene-copy role): any rendered resolution onto the display's. `image`
    is a numpy array (moved to `device`, the CPU by default) or a tensor;
    integer images come back as u8."""
    if isinstance(image, np.ndarray):
        integer = np.issubdtype(image.dtype, np.integer)
        img = torch.as_tensor(image, device=device)
    else:
        integer = not torch.is_floating_point(image)
        img = image
    out = _stage_sample(img.to(torch.float32), out_h, out_w, 0.0, 0.0)
    if integer:
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out


def render_scaled(state: SpaceState, camera: Camera, scale: float) -> Rendering:
    """Render at `scale`× resolution and resample to the camera viewport
    (camera.rs Viewport::with_scale + the gpu frame-resampling pass):
    scale < 1 trades sharpness for ray count; scale > 1 supersamples."""
    vp = camera.viewport
    rw = max(int(round(vp.width * scale)), 1)
    rh = max(int(round(vp.height * scale)), 1)
    small_cam = Camera(camera.options, Viewport(rw, rh), eye_to_world=camera.eye_to_world)
    small_cam.exposure = camera.exposure
    r = render(state, small_cam)
    data = resample_frame(r.data, vp.height, vp.width, device=state.device).cpu().numpy()
    return Rendering(vp.width, vp.height, data, r.flaws)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _png_image(data: np.ndarray) -> tuple[bytes, bytes]:
    """The IHDR body and the zlib stream (level 6, every row filtered
    with type 0) of an RGBA or RGB image."""
    data = np.ascontiguousarray(data, np.uint8)
    h, w, c = data.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), data.reshape(h, w * c)], axis=1).tobytes()
    color_type = {4: 6, 3: 2}[c]
    return struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0), zlib.compress(raw, 6)


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def encode_png(data: np.ndarray) -> bytes:
    """An RGBA (u8[H,W,4]) or RGB (u8[H,W,3]) image as PNG bytes, in
    memory (zlib level 6 + struct; no imaging library)."""
    ihdr, idat = _png_image(data)
    return PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr) + _png_chunk(b"IDAT", idat) + _png_chunk(b"IEND", b"")


def encode_apng(frames, duration_ms: int) -> bytes:
    """Images of one shape as an animated PNG (APNG: `acTL`, a `fcTL`
    before each frame, the first frame in `IDAT` as the default image,
    the others in `fdAT`), each shown `duration_ms`, whole (no offset,
    dispose none, blend source). A recording loops forever (`acTL`'s
    play count 0)."""
    frames = list(frames)
    h, w = frames[0].shape[:2]
    out = [PNG_SIGNATURE, None, _png_chunk(b"acTL", struct.pack(">II", len(frames), 0))]
    seq = 0
    for i, frame in enumerate(frames):
        if frame.shape[:2] != (h, w):
            raise ValueError(f"frame {i} is {frame.shape[:2]}, frame 0 {(h, w)}")
        ihdr, data = _png_image(frame)
        if i == 0:
            out[1] = _png_chunk(b"IHDR", ihdr)
        out.append(_png_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0, duration_ms, 1000, 0, 0)))
        seq += 1
        if i == 0:
            out.append(_png_chunk(b"IDAT", data))
        else:
            out.append(_png_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    out.append(_png_chunk(b"IEND", b""))
    return b"".join(out)


#: Channels of an 8-bit PNG by colour type: grey, RGB, grey + alpha, RGBA.
PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(kinds: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """PNG's row filters undone (None, Sub, Up, Average, Paeth; `kinds`
    u8[H], `rows` u8[H,W,C] as filtered). Each pixel depends on its left,
    upper and upper-left neighbours, so the pixels are reconstructed one
    anti-diagonal at a time, each step across every row at once: in the
    skewed layout `skew[t + 2, r + 1]` = pixel (r, t - r), step t reads
    the left and upper neighbours at t + 1 and the upper-left at t."""
    h, w, c = rows.shape
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())} is not one of 0-4")
    r, x = np.mgrid[:h, :w]
    # Filtered bytes off the image are 0, and so is every pixel before a
    # row's first (x < 0) and the row above the first: they read as 0.
    filt = np.zeros((h + w - 1, h, c), np.int16)
    filt[r + x, r] = rows
    skew = np.zeros((h + w + 1, h + 1, c), np.int16)
    k = kinds[:, None]
    sub, up, avg, paeth = ((k == i).astype(np.int16) for i in (1, 2, 3, 4))
    for t in range(h + w - 1):
        a, b, ul = skew[t + 1, 1:], skew[t + 1, :-1], skew[t, :-1]
        pa, pb, pc = np.abs(b - ul), np.abs(a - ul), np.abs(a + b - 2 * ul)
        nearest = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        pred = sub * a + up * b + avg * ((a + b) >> 1) + paeth * nearest
        skew[t + 2, 1:] = (filt[t] + pred) & 0xFF
    return skew[r + x + 2, r + 1].astype(np.uint8)


def decode_png(png: bytes) -> np.ndarray:
    """The image of an 8-bit, non-interlaced PNG of colour type 0, 2, 4 or
    6 (grey, RGB, grey + alpha, RGBA), every row filter allowed, as
    u8[H,W,C] with C = 1, 3, 2 or 4; of an APNG, its default image (the
    `IDAT` frame)."""
    if png[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(png):
        n, kind = struct.unpack(">I4s", png[pos : pos + 8])
        body = png[pos + 8 : pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
            _, _, depth, color_type, _, _, interlace = header
            if depth != 8 or color_type not in PNG_CHANNELS or interlace:
                raise ValueError(f"unsupported PNG: depth {depth}, colour type {color_type}, interlace {interlace}")
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, _, color_type = header[:4]
    c = PNG_CHANNELS[color_type]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    image = rows[:, 1:].reshape(h, w, c)
    if not rows[:, 0].any():  # every row unfiltered, as `encode_png` writes
        return image.copy()
    return _unfilter(rows[:, 0], image)


def save_png(rendering: Rendering, path: str) -> None:
    """Write the RGBA image as a PNG (`encode_png`)."""
    with open(path, "wb") as f:
        f.write(encode_png(rendering.data))
