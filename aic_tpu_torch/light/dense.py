"""Whole-volume dense relight: one Jacobi pass relights every cube at once.

Port of `aic_tpu/light/dense.py` (the bulk half of the reference light
updater, all-is-cubes/src/space/light/updater.rs). Kept: the pair tables,
the contents-derived context, `_finish`, the pass, one whole-volume round
(`relight_all`), the ray-split pass over several ranks
(`relight_all_pass_sharded`) and the convergence driver. Left out: the
coarse multigrid seed (measured negative in `aic_tpu`).

The pass itself is `relight_kernel.relight_pass`: the CUDA kernel for a
state on the card, its plain PyTorch twin for one on the CPU.

Convergence follows `converge_pallas`: the light-independent terms come
from one full pass over ring-only light, and every iteration runs the
light-only pass. On the CPU the passes are plain Jacobi (`aic_tpu`
`_converge_xla` on the CPU), on CUDA they over-relax (w = 1.3, the stop
always judged on the plain pass).
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
import weakref

import numpy as np
import torch

from ..math import faces, lightpack
from ..space.state import SpaceState
from .chart import STEP_END, STEP_PAD, build_chart
from .relight_kernel import KernelTables, PairTables, deal_pair_tables, relight_pass

#: Over-relaxation weight of the CUDA convergence loop (aic_tpu
#: dense.py:710: 18 → 15 passes on light_bench; w ≥ 1.5 diverges).
OVERRELAX = 1.3


@functools.lru_cache(maxsize=16)
def _pair_tables(max_distance: int, size: tuple[int, int, int]):
    """Flattened (ray, step) pair tables, truncated to the volume extent.

    Returns dict of numpy arrays over N pairs:
      off i32[N,3], face i32[N], is_end bool[N], ray_new bool[N],
      ray_id i32[N]; plus cosines f32[R,6]."""
    ch = build_chart(max_distance)
    offsets = np.asarray(ch["offsets"], np.int32)
    faces_in = np.asarray(ch["faces_in"], np.int32)
    kinds = np.asarray(ch["kinds"], np.int32)
    size_a = np.asarray(size, np.int64)

    off_l, face_l, end_l, new_l, ray_l = [], [], [], [], []
    for r in range(ch["n_rays"]):
        first = True
        for s in range(ch["max_steps"]):
            kind = kinds[r, s]
            if kind == STEP_PAD:
                break
            off = offsets[r, s].astype(np.int64)
            # Outside the volume for every cube → forced end (sky exit).
            forced_end = bool((np.abs(off) >= size_a).any())
            off_l.append(offsets[r, s])
            face_l.append(faces_in[r, s])
            end_l.append(bool(kind == STEP_END) or forced_end)
            new_l.append(first)
            ray_l.append(r)
            first = False
            if end_l[-1]:
                break
    return dict(
        off=np.asarray(off_l, np.int32),
        face=np.asarray(face_l, np.int32),
        is_end=np.asarray(end_l, np.bool_),
        ray_new=np.asarray(new_l, np.bool_),
        ray_id=np.asarray(ray_l, np.int32),
        cosines=np.asarray(ch["cosines"], np.float32),
    )


@functools.lru_cache(maxsize=16)
def _dealt_pair_tables(max_distance: int, size: tuple[int, int, int]) -> dict:
    """`_pair_tables` in the order the CUDA kernel's warps walk the rays."""
    return deal_pair_tables(_pair_tables(max_distance, size))


#: (light distance, size, id(sky_faces), share) → (weakref to the sky, PairTables).
_DEVICE_PAIRS: dict = {}


@functools.lru_cache(maxsize=16)
def _pair_tables_sharded(max_distance: int, size: tuple[int, int, int], world: int, rank: int):
    """`_pair_tables` of the chart rays with ray_id % world == rank, one
    rank's share of a ray-split pass (`aic_tpu` dense.py:449 splits them
    so), and their deal over the kernel's warps: (flat tables, dealt)."""
    ch = _pair_tables(max_distance, size)
    keep = ch["ray_id"] % world == rank
    sub = {k: (v[keep] if k != "cosines" else v) for k, v in ch.items()}
    return sub, deal_pair_tables(sub)


def device_pair_tables(state: SpaceState, size=None, share=None) -> PairTables:
    """The pair tables of the state's light distance with its sky's ray
    light, on its device, truncated to `size` (the state's own unless a
    slab of a larger world asks for the world's), with every chart ray or
    `share` = (world, rank)'s (`_pair_tables_sharded`). They depend on
    nothing else, so they are built once per sky tensor (a snapshot makes
    one; edits and device ticks keep it) and shared by the dense context
    and the queue's batches."""
    md = state.light_max_distance
    size = tuple(state.contents.shape) if size is None else tuple(size)
    key = (md, size, id(state.sky_faces), share)
    hit = _DEVICE_PAIRS.get(key)
    if hit is not None and hit[0]() is state.sky_faces:
        return hit[1]
    if share is None:
        ch, dealt = _pair_tables(md, size), _dealt_pair_tables(md, size)
    else:
        ch, dealt = _pair_tables_sharded(md, size, *share)
    pairs = PairTables.from_numpy(ch, dealt, state.sky_faces)
    if len(_DEVICE_PAIRS) >= 8:
        _DEVICE_PAIRS.pop(next(iter(_DEVICE_PAIRS)))
    _DEVICE_PAIRS[key] = (weakref.ref(state.sky_faces), pairs)
    return pairs


def _shift(vol: torch.Tensor, normal) -> torch.Tensor:
    """out[c] = vol[c + normal], zero (False) outside."""
    out = torch.zeros_like(vol)
    src = [slice(None)] * 3
    dst = [slice(None)] * 3
    for a in range(3):
        n = int(normal[a])
        if n > 0:
            src[a], dst[a] = slice(n, None), slice(0, -n)
        elif n < 0:
            src[a], dst[a] = slice(0, n), slice(-n, None)
    out[tuple(dst)] = vol[tuple(src)]
    return out


@dataclasses.dataclass(frozen=True)
class RelightCtx:
    """Contents-derived volumes reused across passes (light-independent)."""

    dir_weights: torch.Tensor  # f32[X,Y,Z,6]
    alpha0: torch.Tensor  # f32[X,Y,Z]
    incoming0: torch.Tensor  # f32[X,Y,Z,3]
    origin_opaque: torch.Tensor  # bool[X,Y,Z]
    origin_emission: torch.Tensor  # f32[X,Y,Z,3]
    pairs: PairTables
    kernel: KernelTables  # the CUDA pass's work list and mask


def build_relight_ctx(state: SpaceState, size=None, own=None) -> RelightCtx:
    """Precompute the dense per-cube volumes one pass needs.

    A slab of a larger world (`parallel/slab.py`) passes the world's
    `size`, whose pair tables the pass walks, and `own` = (x0, x1): the
    planes whose cubes it relights. The other planes are the slab's halo:
    they get no ray weight, so neither the kernel's work list nor the
    plain version walks a ray from them."""
    t = state.tables
    size = tuple(state.contents.shape) if size is None else tuple(size)
    idx = state.contents.long()
    md = state.light_max_distance

    visible_v = t.visible[idx]
    emission_v = t.light_emission[idx]  # [X,Y,Z,3]
    emissive_v = (emission_v != 0).any(-1)
    origin_opaque = t.opaque_faces.all(-1)[idx]
    mean_alpha = torch.clamp(t.face_colors[:, 6, 3], 0.0, 1.0)[idx]

    # directions_to_seek_light (updater.rs:663), dense: per face f the
    # neighbor in direction f; visibility tested through the opposite slot.
    normals = faces.FACE_NORMALS
    vis_sh = [_shift(visible_v, normals[f]) for f in range(6)]
    emis_sh = [_shift(emissive_v, normals[f]) for f in range(6)]
    opp = faces.OPPOSITE[:6]
    dir_weights = torch.stack(
        [(visible_v | vis_sh[int(opp[f])] | emis_sh[f]).to(torch.float32) for f in range(6)],
        dim=-1,
    )
    if own is not None:
        dir_weights[: own[0]] = 0.0
        dir_weights[own[1] :] = 0.0

    # Root step (face Within).
    root_pickup = visible_v & ~origin_opaque & (mean_alpha < 1.0)
    root_contrib = torch.where(root_pickup[..., None], emission_v, torch.zeros_like(emission_v))
    alpha0 = torch.where(root_pickup, 1.0 - mean_alpha, torch.ones_like(mean_alpha))
    ch = _pair_tables(md, size)
    cos_sum = torch.as_tensor(ch["cosines"].sum(axis=0), device=state.device)
    w_total = (dir_weights * cos_sum).sum(-1)
    incoming0 = root_contrib * w_total[..., None]

    dir_weights = dir_weights.contiguous()
    alpha0 = alpha0.contiguous()
    origin_opaque = origin_opaque.contiguous()
    pairs = device_pair_tables(state, size)
    return RelightCtx(
        dir_weights=dir_weights,
        alpha0=alpha0,
        incoming0=incoming0,
        origin_opaque=origin_opaque,
        origin_emission=emission_v,
        pairs=pairs,
        kernel=KernelTables.build(state.contents, t.light_face_rows, dir_weights, alpha0, origin_opaque),
    )


def _finish(ctx: RelightCtx, incoming: torch.Tensor, total_w: torch.Tensor) -> torch.Tensor:
    """finish (updater.rs:925): packed light u8[X,Y,Z,4]."""
    return finish(ctx.origin_opaque, ctx.origin_emission, incoming, total_w)


def finish(origin_opaque, origin_emission, incoming, total_w) -> torch.Tensor:
    """finish (updater.rs:925) for any batch of cubes: their origin
    opacity bool[...] and emission f32[...,3], and the summed incoming
    light f32[...,3] and ray weight f32[...] → packed light u8[...,4].
    Opaque origins get OPAQUE, or their emission with weight 1."""
    origin_emissive = (origin_emission != 0).any(-1)
    opaque_emissive = origin_opaque & origin_emissive
    one = torch.ones_like(total_w)
    zero = torch.zeros_like(total_w)
    total = torch.where(
        origin_opaque, torch.where(opaque_emissive, one, zero), total_w
    )
    incoming = torch.where(
        origin_opaque[..., None],
        torch.where(
            opaque_emissive[..., None], origin_emission, torch.zeros_like(incoming)
        ),
        incoming,
    )
    rgb = incoming / torch.clamp(total, min=1.0)[..., None]
    packed_rgb = lightpack.encode_scalar(rgb)
    status = torch.where(
        total > 0.0,
        lightpack.STATUS_VISIBLE,
        torch.where(origin_opaque, lightpack.STATUS_OPAQUE, lightpack.STATUS_NO_RAYS),
    ).to(torch.uint8)
    packed_rgb = torch.where(
        (status == lightpack.STATUS_VISIBLE)[..., None], packed_rgb, torch.zeros_like(packed_rgb)
    )
    return torch.cat([packed_rgb, status[..., None]], dim=-1)


def relight_all_pass(state: SpaceState, ctx: RelightCtx) -> torch.Tensor:
    """One Jacobi pass: new packed light u8[X,Y,Z,4] for every cube,
    reading only the pre-pass light field."""
    light_rgb = lightpack.decode_rgb(state.light).contiguous()
    incoming, total_w = relight_pass(
        state.contents, light_rgb, state.tables.light_face_rows, ctx
    )
    return _finish(ctx, incoming + ctx.incoming0, total_w)


def relight_all_pass_sharded(state: SpaceState, ctx: RelightCtx, mesh) -> torch.Tensor:
    """One Jacobi pass with the chart's rays split over the ranks of
    `mesh` (`parallel.make_mesh`), as `aic_tpu` dense.py:470 splits them
    over a device mesh: every rank holds the whole state and `ctx`, walks
    the rays with ray_id % world == rank (K2 on the card, its plain
    version on the CPU) and all-reduces the per-cube incoming light and
    ray weight, which add over rays. Every rank returns the new packed
    light u8[X,Y,Z,4]. Called by every rank."""
    from ..parallel import comm

    share = dataclasses.replace(ctx, pairs=device_pair_tables(state, share=(mesh.world, mesh.rank)))
    light_rgb = lightpack.decode_rgb(state.light).contiguous()
    incoming, total_w = relight_pass(state.contents, light_rgb, state.tables.light_face_rows, share)
    incoming = comm.all_reduce(incoming, mesh)
    total_w = comm.all_reduce(total_w, mesh)
    return _finish(ctx, incoming + ctx.incoming0, total_w)


def _apply_pass(state: SpaceState, new_light: torch.Tensor):
    """Commit a pass (`aic_tpu` dense.py:512): the new light, the six
    neighbours of every cube whose light moved by more than one step
    marked dirty at that difference (apply_light_update, updater.rs:289),
    and the stats as tensors."""
    diff = lightpack.difference_priority(state.light, new_light)
    bump = torch.where(diff > 1, torch.clamp(diff, max=255), 0).to(torch.uint8)
    dirty = torch.zeros_like(state.light_dirty)
    for f in range(6):
        dirty = torch.maximum(dirty, _shift(bump, faces.FACE_NORMALS[f]))
    stats = dict(updated=diff.numel(), max_diff=diff.max(), queue_remaining=(dirty > 0).sum())
    return dataclasses.replace(state, light=new_light, light_dirty=dirty), stats


def relight_all(state: SpaceState, ctx: RelightCtx | None = None):
    """One whole-volume relight round (`aic_tpu` dense.py:555): K2's full
    pass on the card, its plain version on the CPU, committed by
    `_apply_pass`. Returns (state, stats)."""
    if ctx is None:
        ctx = build_relight_ctx(state)
    return _apply_pass(state, relight_all_pass(state, ctx))


def _overrelax(light, new_light, diff: int, w: float):
    """converge_pallas's extrapolation (aic_tpu pallas_relight.py:868-879):
    L ← L + w·(F(L) − L) in decoded space while the plain pass still moves
    some cube by more than 4 steps; the plain output otherwise."""
    cur = lightpack.decode_rgb(light)
    new = lightpack.decode_rgb(new_light)
    packed = lightpack.encode_scalar(torch.clamp(new + (w - 1.0) * (new - cur), min=0.0))
    status = new_light[..., 3:4]
    keep_plain = (diff <= 4) | (status != lightpack.STATUS_VISIBLE)
    rgb = torch.where(keep_plain, new_light[..., :3], packed)
    return torch.cat([rgb, status], dim=-1)


class OverrelaxFellBack(RuntimeWarning):
    """`converge`'s over-relaxed loop met a pass whose plain change grew,
    and ran plain Jacobi from there on."""


class LightNotConverged(RuntimeWarning):
    """`converge` stopped at its pass limit with a cube still moving by
    more than one packed step."""


def converge(state: SpaceState, ctx: RelightCtx, max_passes: int = 32, overrelax: float = 1.0):
    """Jacobi passes until no cube moves by more than 1 packed step (the
    reference's re-enqueue threshold, updater.rs:340). Returns (new packed
    light, passes run); warns `LightNotConverged` when it stops at
    `max_passes` short of that, and `OverrelaxFellBack` when it drops to
    plain Jacobi (below).

    As in `converge_pallas` (pallas_relight.py:827-862): one full pass
    over light that is zero inside the bounds and the sky on the ring
    around them gives the emission, sky and ring terms and the total
    weights once; each iteration adds to them the light-only pass over
    the stored light (the split is exact by linearity, up to f32
    summation order).

    Over-relaxation can diverge: on cornell-box 16 at w = 1.3 the plain
    pass's largest change falls to 9 steps, then grows to 127, where
    plain Jacobi converges in 11 passes. From the first pass whose plain
    change is larger than the pass before's, the loop runs plain Jacobi
    (w = 1). Where w = 1.3 converges (the atrium, cornell-box 24 and 32,
    plaza640) the change never grows before the stop, and the passes
    and light are those of the loop without the fallback."""
    rows = state.tables.light_face_rows
    zero = torch.zeros(tuple(state.contents.shape) + (3,), dtype=torch.float32, device=state.device)
    static, total_w = relight_pass(state.contents, zero, rows, ctx)
    light = state.light
    passes = 0
    w = overrelax
    last = None
    while passes < max_passes:
        light_rgb = lightpack.decode_rgb(light).contiguous()
        inc, _ = relight_pass(state.contents, light_rgb, rows, ctx, dyn=True)
        new_light = _finish(ctx, inc + static + ctx.incoming0, total_w)
        diff = int(lightpack.difference_priority(light, new_light).max())
        if w != 1.0 and last is not None and diff > last:
            warnings.warn(f"over-relaxed relight: the change grew to {diff} packed steps at pass {passes + 1}; "
                          "plain Jacobi from there on", OverrelaxFellBack, stacklevel=2)
            w = 1.0
        last = diff
        if w != 1.0:
            new_light = _overrelax(light, new_light, diff, w)
        light = new_light
        passes += 1
        if diff <= 1:
            return light, passes
    warnings.warn(f"relight stopped after {passes} passes with a cube still moving by {diff} packed steps",
                  LightNotConverged, stacklevel=2)
    return light, passes


def evaluate_light_dense(state: SpaceState, max_passes: int = 32, ctx: RelightCtx | None = None,
                         seed: bool = True):
    """Full-volume relight to convergence, at most `max_passes` passes,
    with `ctx` built from the state's contents unless given (`aic_tpu`
    dense.py:649; its opt-in coarse seed is not ported). Returns (state,
    passes_run); `converge`'s `LightNotConverged` warning reaches the
    caller.

    With `seed` the ``fast_evaluate_light`` column scan runs first
    (updater.rs:531-576) and starts sky-lit columns at their fixpoint. A
    CUDA state converges with over-relaxation, a CPU state with plain
    Jacobi, as the JAX package does on the TPU and the CPU."""
    if seed:
        from .refproc import fast_evaluate_seed

        state, _prio = fast_evaluate_seed(state)
    if ctx is None:
        ctx = build_relight_ctx(state)
    w = OVERRELAX if state.device.type == "cuda" else 1.0
    light, passes = converge(state, ctx, max_passes=max_passes, overrelax=w)
    state = dataclasses.replace(
        state, light=light, light_dirty=torch.zeros_like(state.light_dirty)
    )
    return state, passes
