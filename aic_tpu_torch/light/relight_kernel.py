"""The relight pass: CUDA kernel `csrc/relight.cu` and its plain twin.

Replaces the TPU kernel `aic_tpu/light/pallas_relight.py:338
_kernel_factory` (launched by `_kernel_pass_planes`, driven by
`converge_pallas`): one Jacobi relight pass over every cube. For each
chart ray and each of its steps it fetches the entered cube's face row
(colour, opacity, flags, emission), carries the ray's alpha and weight,
and reads the stored light behind a struck face or inside a cube the ray
passes through; a ray ends at the chart's end, outside the volume, at an
opaque face or when its alpha reaches 0, and then picks up the sky. The
pass returns incoming RGB and total ray weight per cube; `dense._finish`
packs them. Semantics are `aic_tpu` `dense._run_pairs` (dense.py:210-418).

On the H100 what bounds the pass is the latency of the dependent loads
along each ray (pair entry → the entered cube → its face row → the
light), which neither the operation bound nor the byte bound sees. The
kernel shortens that chain and each step of it (`csrc/relight.cu` gives
the details): a work list of the cubes that have ray weight
(`KernelTables.cubes`); a block of 32 listed cubes whose rays are dealt
out over `WARPS` warps (`PairTables.warp_start`), the
warps' partial sums added in a fixed order with no atomics; a one-byte
visibility mask, padded by one cube so that an air step reads one byte
and no in-volume test (`KernelTables.face_mask`); and one 32-bit word
per pair (`PairTables.words`), loaded two steps ahead. The TPU kernel's
octant-mirror and plane packing are layout tricks for its vector unit
and are not carried over; f32 replaces bf16.

Both of the TPU kernel's variants are here, as a template flag of the one
kernel: the full pass, and the light-only pass (`dyn=True`, the TPU
kernel's `dyn`), which leaves out the terms that read no stored light --
emission, the sky a ray picks up at its end, the sky one-ring outside the
bounds and the total weight. A pass is affine in the stored light, so
the full pass over ring-only light plus the light-only pass over the
interior light is the full pass (up to f32 summation order);
`dense.converge` runs the first once and the second per iteration.

`relight_pass` dispatches on the device of its tensors: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises.

The incremental light queue (`light/update.py`) relights a round's batch
with the second kernel of `csrc/relight.cu`, which shares the walk
(`relight_listed_cuda`): the full pass over a few to about a thousand
rows, whose per-cube inputs and outputs are per batch row. Each lane
walks one (row, chart ray) pair, a warp 32 rays of one row dealt by chart
length (`deal_lanes`, kept in `PairTables.lane_ray`), so the launch's
chain is one ray and a batch spreads over every SM; each row's sum is
taken in a fixed order (a shuffle tree, then the warps' partials in warp
order, added by the row's last warp to finish). It reads the state's
packed light and decodes it through `decode_table`. Its plain twin is
`update.relight_batch_plain`.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..math import faces, lightpack

#: Launches of the CUDA kernels by this process: the full and light-only
#: variants over a volume's work list, and the listed pass over a queue
#: round's batch (the plain versions do not count).
LAUNCHES = 0
LAUNCHES_DYN = 0
LAUNCHES_LISTED = 0


#: Warps of a kernel block; `csrc/relight.cu`'s `kWarps` (checked at load).
WARPS = 16
#: Listed cubes of a kernel block, one per lane.
TILE = 32
#: Lanes of a warp: the listed kernel's chart rays of one row per warp.
LANES = 32
#: Warps a block of the listed kernel; `csrc/relight.cu`'s `kListedWarps`
#: (checked at load).
LISTED_BLOCK_WARPS = 8
#: Mask bit of the padding cubes around the volume.
MASK_OUTSIDE = 0x40


def pack_pair_words(off: np.ndarray, face: np.ndarray, is_end: np.ndarray) -> np.ndarray:
    """One 32-bit word per pair, as i32: the offsets as three i8 in bits
    0-23 (x lowest), the entered face in bits 24-26, the end flag in bit
    27; then two pad words of 0, so that the kernel may load the two words
    after a ray's last pair.

    The kernel reads only the face and the end flag: it moves each step by
    minus the normal of the face it enters through, which this checks the
    offsets for (every pair that does not end its ray steps one cube from
    the previous pair, or from the origin)."""
    if np.abs(off).max(initial=0) > 127:
        raise ValueError("pair offsets do not fit in i8")
    normals = np.asarray(faces.FACE_NORMALS[:6], np.int64)
    walked = ~is_end
    first = np.ones(len(off), bool)
    first[1:] = is_end[:-1]
    prev = np.where(first[:, None], 0, np.roll(off, 1, axis=0))
    if not (off - prev == -normals[face])[walked].all():
        raise ValueError("a pair does not enter its cube through its face")
    off = off.astype(np.int64) & 0xFF
    words = (off[:, 0] | off[:, 1] << 8 | off[:, 2] << 16
             | face.astype(np.int64) << 24 | is_end.astype(np.int64) << 27)
    return np.append(words, [0, 0]).astype(np.int32)


def deal_rays(lengths: np.ndarray, warps: int) -> tuple[np.ndarray, np.ndarray]:
    """The chart's rays, dealt out over `warps` warps so that each gets
    about the same total chart length: longest first, each to the warp
    with the least so far. Returns (ray_id i32[R], warp_start
    i32[warps+1]): the rays in dealt order, warp k's ascending, from
    position warp_start[k] to warp_start[k+1]."""
    load = np.zeros(warps, np.int64)
    share: list[list[int]] = [[] for _ in range(warps)]
    for r in np.argsort(-lengths, kind="stable"):
        k = int(np.argmin(load))
        share[k].append(int(r))
        load[k] += lengths[r]
    ray_id = np.concatenate([np.sort(np.asarray(s, np.int64)) for s in share]).astype(np.int32)
    warp_start = np.concatenate([[0], np.cumsum([len(s) for s in share])]).astype(np.int32)
    return ray_id, warp_start


def deal_lanes(lengths: np.ndarray) -> np.ndarray:
    """The listed kernel's lanes: one chart ray each, longest chart first,
    LANES a warp, so that a warp's lanes walk rays of about the same
    length and end together. Returns lane_ray i32[W*LANES], W =
    ceil(R / LANES): the chart ray of each lane, -1 on the last warp's
    empty lanes."""
    order = np.argsort(-np.asarray(lengths), kind="stable")
    lane_ray = np.full(-(-len(order) // LANES) * LANES, -1, np.int32)
    lane_ray[: len(order)] = order
    return lane_ray


@dataclass(frozen=True)
class PairTables:
    """The chart's (ray, step) pair tables on the device, in two layouts:
    per (ray, step) in chart order for the plain version, and one packed
    word per pair for the kernel, its rays in the order the kernel's warps
    walk them (`deal_pair_tables`), so that a warp's pairs are one run of
    `words`. Cosines and sky are per chart ray; the volume kernel finds
    them through `ray_id`, the listed kernel through `lane_ray`."""

    words: torch.Tensor  # i32[N+2] `pack_pair_words`, rays in dealt order
    ray_start: torch.Tensor  # i32[R+1] first word of each dealt ray
    ray_id: torch.Tensor  # i32[R] chart ray of each dealt ray
    warp_start: torch.Tensor  # i32[WARPS+1] first dealt ray of each kernel warp
    lane_ray: torch.Tensor  # i32[W*LANES] `deal_lanes`: chart ray of each listed lane, or -1
    lane_start: torch.Tensor  # i32[W*LANES] first word of each listed lane's ray (0 where -1)
    cosines: torch.Tensor  # f32[R,6]
    sky_ray: torch.Tensor  # f32[R,3] sky light seen along each ray
    sky_faces: torch.Tensor  # f32[6,3] BlockSky per-face light
    step_off: torch.Tensor  # i32[R,S,3]
    step_face: torch.Tensor  # i32[R,S]
    step_end: torch.Tensor  # bool[R,S]

    @staticmethod
    def from_numpy(ch: dict, dealt: dict, sky_faces: torch.Tensor) -> "PairTables":
        """The flat pair tables `ch` (`dense._pair_tables`) and their deal
        (`deal_pair_tables(ch)`) on `sky_faces`'s device."""
        dev = sky_faces.device
        ray_id = ch["ray_id"]
        n_rays = ch["cosines"].shape[0]
        counts = np.bincount(ray_id, minlength=n_rays)
        first = np.concatenate([[0], np.cumsum(counts)])
        steps = int(counts.max())
        pos = np.arange(len(ray_id)) - first[ray_id]
        step_off = np.zeros((n_rays, steps, 3), np.int32)
        step_face = np.zeros((n_rays, steps), np.int32)
        step_end = np.ones((n_rays, steps), np.bool_)
        step_off[ray_id, pos] = ch["off"]
        step_face[ray_id, pos] = ch["face"]
        step_end[ray_id, pos] = ch["is_end"]
        cosines = torch.as_tensor(ch["cosines"], device=dev)
        sky_ray = (cosines @ sky_faces) / cosines.sum(-1, keepdim=True)
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        return PairTables(
            words=t(dealt["words"]),
            ray_start=t(dealt["ray_start"]),
            ray_id=t(dealt["ray_id"]),
            warp_start=t(dealt["warp_start"]),
            lane_ray=t(dealt["lane_ray"]),
            lane_start=t(dealt["lane_start"]),
            cosines=cosines,
            sky_ray=sky_ray.contiguous(),
            sky_faces=sky_faces.contiguous(),
            step_off=t(step_off),
            step_face=t(step_face),
            step_end=t(step_end),
        )


def deal_pair_tables(ch: dict) -> dict:
    """The kernel's layout of the chart's flat pair tables
    (`dense._pair_tables`), as numpy arrays: the rays dealt out over
    `WARPS` warps (`deal_rays`), then words (`pack_pair_words`) and
    ray_start in that order, ray_id and warp_start; and the listed
    kernel's lanes (`deal_lanes`) with the first word of each lane's ray.
    It depends only on the chart, so the caller caches it."""
    n_rays = ch["cosines"].shape[0]
    counts = np.bincount(ch["ray_id"], minlength=n_rays)
    ray_id, warp_start = deal_rays(counts, WARPS)
    position = np.empty(n_rays, np.int64)
    position[ray_id] = np.arange(n_rays)
    pair = np.argsort(position[ch["ray_id"]], kind="stable")  # pairs in dealt ray order
    off, face, is_end = ch["off"][pair], ch["face"][pair], ch["is_end"][pair]
    ray_start = np.concatenate([[0], np.cumsum(counts[ray_id])]).astype(np.int32)
    if not is_end[ray_start[1:] - 1].all():
        raise ValueError("a chart ray does not end at its last pair")
    lane_ray = deal_lanes(counts)
    lane_start = np.where(lane_ray >= 0, ray_start[:-1][position[lane_ray]], 0).astype(np.int32)
    return dict(words=pack_pair_words(off, face, is_end), ray_start=ray_start, ray_id=ray_id,
                warp_start=warp_start, lane_ray=lane_ray, lane_start=lane_start)


@dataclass(frozen=True)
class KernelTables:
    """What the kernel reads besides the pair tables, built once per
    context from contents (it does not depend on light)."""

    cubes: torch.Tensor  # i32[n] walked cubes with any ray weight, ascending
    face_mask: torch.Tensor  # u8[X+2,Y+2,Z+2] bit f: face f visible; MASK_OUTSIDE: padding

    @staticmethod
    def build(contents, face_rows, dir_weights, alpha0, origin_opaque) -> "KernelTables":
        """On the tensors' device: the work list and the padded mask."""
        walked = (alpha0 > 0.0) & ~origin_opaque & (dir_weights > 0.0).any(-1)
        cubes = walked.reshape(-1).nonzero().squeeze(1).to(torch.int32)
        return KernelTables(cubes=cubes, face_mask=build_face_mask(contents, face_rows))


def build_face_mask(contents, face_rows) -> torch.Tensor:
    """u8[X+2,Y+2,Z+2] on the tensors' device: bit f where face f of the
    cube is visible, `MASK_OUTSIDE` on the padding around the volume."""
    X, Y, Z = contents.shape
    dev = contents.device
    visible = face_rows.reshape(-1, 6, 8)[..., 4] >= 2.0
    bits = (visible.to(torch.int32) << torch.arange(6, device=dev, dtype=torch.int32)).sum(-1)
    mask = torch.full((X + 2, Y + 2, Z + 2), MASK_OUTSIDE, dtype=torch.uint8, device=dev)
    mask[1:-1, 1:-1, 1:-1] = bits.to(torch.uint8)[contents.long()]
    return mask


def _ring_padded_light(light_rgb: torch.Tensor, sky_faces: torch.Tensor) -> torch.Tensor:
    """Decoded light padded by one cube: the face slabs of the padding
    carry the sky's face light, edges and corners are 0 (sky.rs:96
    `light_outside`). f32[X+2,Y+2,Z+2,3]."""
    X, Y, Z = light_rgb.shape[:3]
    lp = torch.zeros((X + 2, Y + 2, Z + 2, 3), dtype=torch.float32, device=light_rgb.device)
    lp[1:-1, 1:-1, 1:-1] = light_rgb
    lp[0, 1:-1, 1:-1] = sky_faces[0]
    lp[-1, 1:-1, 1:-1] = sky_faces[3]
    lp[1:-1, 0, 1:-1] = sky_faces[1]
    lp[1:-1, -1, 1:-1] = sky_faces[4]
    lp[1:-1, 1:-1, 0] = sky_faces[2]
    lp[1:-1, 1:-1, -1] = sky_faces[5]
    return lp


#: Most (cube, ray) pairs the plain pass holds at once. The pass is
#: independent per cube, so it walks the cubes in slabs of at most this
#: many pairs and its memory stays a few GB at any volume.
PLAIN_PAIRS = 1 << 26


def relight_pass_plain(contents, light_rgb, face_rows, ctx, dyn=False, work=None, lengths=None):
    """Plain PyTorch pass: (incoming f32[X,Y,Z,3], total f32[X,Y,Z]) over
    the chart rays, without the root-step term `ctx.incoming0`. With
    `dyn` the light-only variant: no emission, sky or total terms (total
    comes back 0), and 0 light on the ring outside the bounds.

    In each slab of cubes, all live (cube, ray) pairs advance one step at
    a time; pairs whose ray ended drop out of the lists, so the work
    follows the rays' lengths. `work`, a dict, gets the work the kernel
    does on these inputs, by branch: "weights" (ray weights of the cubes
    that have any), "rays" (live pairs), "steps" (pair steps), "inside"
    (steps into a cube of the volume), "visible", "struck" and "through"
    (steps that take those branches). `lengths`, a list, gets the pair
    steps of each live (cube, ray) as (cube i64[P], chart ray i64[P],
    steps i32[P]) entries, one per step at which rays ended."""
    X, Y, Z = contents.shape
    dev = contents.device
    V = X * Y * Z
    pairs = ctx.pairs
    ring = torch.zeros_like(pairs.sky_faces) if dyn else pairs.sky_faces
    lp = _ring_padded_light(light_rgb, ring).reshape(-1, 3)
    incoming = torch.zeros((V, 3), dtype=torch.float32, device=dev)
    total = torch.zeros(V, dtype=torch.float32, device=dev)
    tally: dict = {}
    slab = max(1, PLAIN_PAIRS // pairs.cosines.shape[0])
    for c0 in range(0, V, slab):
        _plain_slab(contents, lp, face_rows, ctx, dyn, c0, min(V, c0 + slab), incoming, total, tally, lengths)
    if work is not None:
        for k, n in tally.items():
            work[k] = work.get(k, 0) + int(n)
    return incoming.reshape(X, Y, Z, 3), total.reshape(X, Y, Z)


def _plain_slab(contents, lp, face_rows, ctx, dyn, c0, c1, incoming, total, tally, lengths):
    """`relight_pass_plain` over the cubes c0 <= c < c1 (flat index):
    adds into `incoming` f32[V,3] and `total` f32[V], the work by branch
    into `tally`, and (cube, ray, steps) of the ended pairs to `lengths`
    (a list, or None)."""
    X, Y, Z = contents.shape
    dev = contents.device
    V = X * Y * Z
    pairs = ctx.pairs
    normals = torch.as_tensor(faces.FACE_NORMALS, dtype=torch.int32, device=dev)

    def count(key, n):
        tally[key] = tally.get(key, 0) + n

    dw = ctx.dir_weights.reshape(V, 6)[c0:c1]
    cos = pairs.cosines
    rw_all = dw[:, 0:1] * cos[:, 0]
    for f in range(1, 6):
        rw_all = rw_all + dw[:, f : f + 1] * cos[:, f]
    a0 = ctx.alpha0.reshape(V)[c0:c1]
    walked = (a0 > 0.0) & ~ctx.origin_opaque.reshape(V)[c0:c1]
    count("weights", (walked & (dw > 0.0).any(-1)).sum() * cos.shape[0])
    live0 = (rw_all > 0.0) & walked[:, None]
    c_idx, r_idx = live0.nonzero(as_tuple=True)
    w = rw_all[c_idx, r_idx]
    alpha = a0[c_idx]
    c_idx = c_idx + c0
    count("rays", c_idx.numel())
    cx = torch.div(c_idx, Y * Z, rounding_mode="floor")
    cy = torch.div(c_idx, Z, rounding_mode="floor") % Y
    cz = c_idx % Z
    flat_contents = contents.reshape(-1)

    for s in range(pairs.step_face.shape[1]):
        if c_idx.numel() == 0:
            break
        count("steps", c_idx.numel())
        off = pairs.step_off[r_idx, s]
        face = pairs.step_face[r_idx, s]
        px, py, pz = cx + off[:, 0], cy + off[:, 1], cz + off[:, 2]
        inside = (px >= 0) & (px < X) & (py >= 0) & (py < Y) & (pz >= 0) & (pz < Z)
        exits = pairs.step_end[r_idx, s] | ~inside
        pid = flat_contents[
            (px.clamp(0, X - 1) * Y + py.clamp(0, Y - 1)) * Z + pz.clamp(0, Z - 1)
        ].long()
        row = face_rows[pid * 6 + face]
        fc = row[:, 0:4]
        flags = row[:, 4]
        opaque_f = torch.remainder(flags, 2.0) >= 1.0
        visible = flags >= 2.0
        emission = torch.zeros_like(row[:, 5:8]) if dyn else row[:, 5:8]
        hit_alpha = fc[:, 3].clamp(0.0, 1.0)
        interacting = ~exits & visible

        def light_at(qx, qy, qz):
            q = ((qx + 1).clamp(0, X + 1) * (Y + 2) + (qy + 1).clamp(0, Y + 1)) * (
                Z + 2
            ) + (qz + 1).clamp(0, Z + 1)
            return lp[q]

        # Struck-face branch: reflect the light stored behind the face.
        nrm = normals[face]
        behind = light_at(px + nrm[:, 0], py + nrm[:, 1], pz + nrm[:, 2])
        struck = interacting & (hit_alpha > 0.0)
        light_struck = emission + fc[:, :3].clamp(0.0, 1.0) * behind * hit_alpha[:, None]
        zero3 = torch.zeros_like(light_struck)
        contrib = torch.where(struck[:, None], light_struck * (alpha * w)[:, None], zero3)
        hit_opaque = struck & opaque_f
        alpha = torch.where(struck & ~hit_opaque, alpha * (1.0 - hit_alpha), alpha)

        # Pass-through branch: pick up the cube's own stored light.
        through = interacting & (hit_alpha < 1.0) & ~hit_opaque
        light_through = emission + light_at(px, py, pz) * hit_alpha[:, None]
        contrib = contrib + torch.where(
            through[:, None], light_through * (alpha * w)[:, None], zero3
        )
        alpha = torch.where(through, alpha * (1.0 - hit_alpha), alpha)

        alpha = torch.where(hit_opaque, torch.zeros_like(alpha), alpha)
        ends = exits | hit_opaque | (alpha <= 0.0)
        if not dyn:
            contrib = contrib + torch.where(
                ends[:, None], pairs.sky_ray[r_idx] * (alpha * w)[:, None], zero3
            )
            total.index_add_(0, c_idx, torch.where(ends, w, torch.zeros_like(w)))
        incoming.index_add_(0, c_idx, contrib)
        count("inside", (~exits).sum())
        count("visible", interacting.sum())
        count("struck", struck.sum())
        count("through", through.sum())

        if lengths is not None:
            done = c_idx[ends]
            lengths.append((done, r_idx[ends], torch.full_like(done, s + 1, dtype=torch.int32)))
        keep = ~ends
        c_idx, r_idx, w, alpha = c_idx[keep], r_idx[keep], w[keep], alpha[keep]
        cx, cy, cz = cx[keep], cy[keep], cz[keep]


def _fn():
    lib = kernels.load_library("relight")
    if lib.aic_relight_warps() != WARPS:
        raise RuntimeError(f"csrc/relight.cu has {lib.aic_relight_warps()} warps a block, the ray deal {WARPS}")
    fn = lib.aic_relight_pass
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _listed_fn():
    lib = kernels.load_library("relight")
    if lib.aic_relight_listed_warps() != LISTED_BLOCK_WARPS:
        raise RuntimeError(f"csrc/relight.cu has {lib.aic_relight_listed_warps()} listed warps a block, "
                           f"relight_kernel {LISTED_BLOCK_WARPS}")
    fn = lib.aic_relight_listed
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def relight_pass_cuda(contents, light_rgb, face_rows, ctx, dyn=False):
    """Launch `csrc/relight.cu` on the tensors' card; same contract as
    `relight_pass_plain`. `ctx.kernel` must be built from these contents
    and face rows (`dense.build_relight_ctx` does so). An empty work list
    launches nothing and gives zeros."""
    global LAUNCHES, LAUNCHES_DYN
    kt, p = ctx.kernel, ctx.pairs
    dev = contents.device
    X, Y, Z = contents.shape
    n = kt.cubes.shape[0]
    R = p.cosines.shape[0]
    req = kernels.require
    req(contents, "contents", torch.int32, (X, Y, Z), dev)
    req(light_rgb, "light_rgb", torch.float32, (X, Y, Z, 3), dev)
    req(face_rows, "face_rows", torch.float32, (face_rows.shape[0], 8), dev)
    req(ctx.dir_weights, "dir_weights", torch.float32, (X, Y, Z, 6), dev)
    req(ctx.alpha0, "alpha0", torch.float32, (X, Y, Z), dev)
    req(kt.face_mask, "face_mask", torch.uint8, (X + 2, Y + 2, Z + 2), dev)
    req(kt.cubes, "cubes", torch.int32, (n,), dev)
    req(p.cosines, "cosines", torch.float32, (R, 6), dev)
    req(p.sky_ray, "sky_ray", torch.float32, (R, 3), dev)
    req(p.ray_start, "ray_start", torch.int32, (R + 1,), dev)
    req(p.ray_id, "ray_id", torch.int32, (R,), dev)
    req(p.words, "words", torch.int32, tuple(p.words.shape), dev)
    req(p.warp_start, "warp_start", torch.int32, (WARPS + 1,), dev)
    incoming = torch.zeros((X, Y, Z, 3), dtype=torch.float32, device=dev)
    total = torch.zeros((X, Y, Z), dtype=torch.float32, device=dev)
    if n == 0:
        return incoming, total
    ptr = kernels.ptr
    err = _fn()(
        ptr(contents), ptr(light_rgb), ptr(face_rows), ptr(ctx.dir_weights),
        ptr(ctx.alpha0), ptr(kt.face_mask), ptr(kt.cubes), ptr(p.cosines),
        ptr(p.sky_ray), ptr(p.ray_start), ptr(p.ray_id), ptr(p.words), ptr(p.warp_start),
        ptr(incoming), ptr(total), Y, Z, n, int(dyn), kernels.stream_ptr(dev),
    )
    kernels.check_launch(err, "relight kernel")
    if dyn:
        LAUNCHES_DYN += 1
    else:
        LAUNCHES += 1
    return incoming, total


@functools.lru_cache(maxsize=8)
def decode_table(device: torch.device) -> torch.Tensor:
    """f32[256] on `device`: the light of each packed u8 code, computed by
    `lightpack.decode_scalar` there, so a lookup gives the bits that
    `lightpack.decode_rgb` gives on that device."""
    return lightpack.decode_scalar(torch.arange(256, device=device)).contiguous()


#: (device, stream) → i32 tickets of the listed kernel, one per row, all 0
#: between launches (the row's last warp resets its own). Only launches on
#: that stream use them, so they take turns.
_TICKETS: dict = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.shape[0] < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def relight_listed_cuda(contents, light, face_rows, face_mask, pairs, cubes, dir_weights, alpha0):
    """The listed kernel of `csrc/relight.cu` on the tensors' card: one
    full pass over a list of cubes (flat i32[n] volume indices) whose ray
    weights f32[n,6] and alpha f32[n] are given per row, reading the
    packed light u8[X,Y,Z,4]: (incoming f32[n,3], total f32[n]) per row,
    without the root term. A row whose ray weights are all 0 walks no ray
    and gives 0.

    The rows are summed through per-row tickets that the launch finds at 0
    and leaves at 0; each (device, stream) has its own, so launches that
    share them run one after another on that stream."""
    global LAUNCHES_LISTED
    dev = contents.device
    if dev.type != "cuda":
        raise ValueError(f"the listed relight kernel runs on a CUDA device, not {dev}")
    X, Y, Z = contents.shape
    n = cubes.shape[0]
    p = pairs
    R = p.cosines.shape[0]
    L = p.lane_ray.shape[0]
    ray_warps = L // LANES
    if L % LANES or not 0 < ray_warps <= LANES:
        raise ValueError(f"{L} listed lanes: the row's sum takes 1 to {LANES} warps of {LANES}")
    table = decode_table(dev)
    req = kernels.require
    req(contents, "contents", torch.int32, (X, Y, Z), dev)
    req(light, "light", torch.uint8, (X, Y, Z, 4), dev)
    if light.data_ptr() % 4:
        raise ValueError("light: not aligned to its 32-bit texels")
    req(table, "decode_table", torch.float32, (256,), dev)
    req(face_rows, "face_rows", torch.float32, (face_rows.shape[0], 8), dev)
    req(face_mask, "face_mask", torch.uint8, (X + 2, Y + 2, Z + 2), dev)
    req(cubes, "cubes", torch.int32, (n,), dev)
    req(dir_weights, "dir_weights", torch.float32, (n, 6), dev)
    req(alpha0, "alpha0", torch.float32, (n,), dev)
    req(p.cosines, "cosines", torch.float32, (R, 6), dev)
    req(p.sky_ray, "sky_ray", torch.float32, (R, 3), dev)
    req(p.lane_ray, "lane_ray", torch.int32, (L,), dev)
    req(p.lane_start, "lane_start", torch.int32, (L,), dev)
    req(p.words, "words", torch.int32, tuple(p.words.shape), dev)
    incoming = torch.empty((n, 3), dtype=torch.float32, device=dev)
    total = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return incoming, total
    partial = torch.empty((n, ray_warps, 4), dtype=torch.float32, device=dev)
    ptr = kernels.ptr
    err = _listed_fn()(
        ptr(contents), ptr(light), ptr(table), ptr(face_rows), ptr(dir_weights), ptr(alpha0),
        ptr(face_mask), ptr(cubes), ptr(p.cosines), ptr(p.sky_ray), ptr(p.lane_ray),
        ptr(p.lane_start), ptr(p.words), ptr(partial), ptr(_tickets(dev, n)), ptr(incoming),
        ptr(total), Y, Z, n, ray_warps, kernels.stream_ptr(dev),
    )
    kernels.check_launch(err, "listed relight kernel")
    LAUNCHES_LISTED += 1
    return incoming, total


def relight_pass(contents, light_rgb, face_rows, ctx, dyn=False):
    """One relight pass over every cube (the light-only variant with
    `dyn`): the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if contents.device.type == "cuda":
        return relight_pass_cuda(contents, light_rgb, face_rows, ctx, dyn)
    if contents.device.type == "cpu":
        return relight_pass_plain(contents, light_rgb, face_rows, ctx, dyn)
    raise ValueError(f"no relight pass for device {contents.device}")
