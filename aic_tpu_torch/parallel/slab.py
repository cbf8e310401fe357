"""Slab-sharded Space: the world split in X slabs over the ranks.

Port of `aic_tpu/parallel/slab.py`, SPMD over `torch.distributed`: rank r
of a mesh of w (`mesh.py`) holds the X slab [r·X/w, (r+1)·X/w) of the
world's contents, light and dirty marks on its device, with the slab's
own traversal cells, and every rank calls the same functions. A world
larger than one card's memory is the reason this exists (the
reference's windowed light texture, gpu/src/light_texture.rs:139-239).

- **relight** (the dense Jacobi pass, `light/dense.py`): each rank
  relights its own planes. Their chart rays read up to
  `pad = min(light_max_distance + 1, X)` planes past the slab, so each
  pass first takes `pad` planes of light from the neighbours
  (`comm.halo_exchange`, several hops when the halo is deeper than a
  slab). The rank then runs the one-card pass, K2 on the card
  (`relight_kernel.relight_pass`), over its *extended* slab: its planes
  and the halo, clipped at the world's faces. Its context is built once
  on the extended contents (a one-time contents halo), with the world's
  pair tables and ray weight on the rank's own planes only, so the work
  list holds just those cubes. A cube's sum is then the unsharded pass's
  bit for bit, under two conditions that the tests check: no chart ray
  enters a cube more than `pad` planes from its origin (so the extended
  slab's faces at an interior cut, which read as outside, are never
  reached), and K2's per-cube sum does not depend on which cubes share
  its block.
- **trace**: every rank traces all the rays against its slab alone,
  without the sky; the slabs are composited front to back in each ray's
  X direction (slabs partition X, so a ray crosses them in X order) and
  the sky is added once at the end. The slab's window has one plane of
  its neighbours' light on each side, behind planes that the traversal
  sees as empty, so a face on a cut is lit, flat or smooth, by the light
  across the cut. `aic_tpu`'s slab trace reads the sky there instead;
  that is the one place where the port's result is not its.

A ray whose one-process trace spends its budget (its transparency phases,
its steps, the 1/256 of transmittance it must keep to go on) goes on in
the next slab with a budget of its own, in `aic_tpu`'s design as here:
the composite differs from the one-process frame on such rays.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..light import dense as _dense
from ..light.relight_kernel import relight_pass
from ..math import lightpack
from ..space.state import SpaceState, _cells_for, window_state
from . import comm
from .mesh import Mesh


@dataclasses.dataclass
class SlabSharded:
    """This rank's X slab of a Space (`aic_tpu` slab.py:51).

    `state` is the slab's window (contents, light, dirty marks, its
    cells rebuilt for the window, the tables and sky) on the mesh's
    device, its `lower` the slab's world corner. `full_cells` keeps the
    whole world's traversal cells where the caller had them, so that
    `gather` restores a whole state without rebuilding them."""

    mesh: Mesh
    state: SpaceState
    lower: tuple
    global_size: tuple
    slab_x: int
    full_cells: torch.Tensor
    _ctx: tuple | None = None
    _trace: tuple | None = None

    @property
    def n_devices(self) -> int:
        """The ranks the world is split over (`aic_tpu` slab.py:76)."""
        return self.mesh.world

    @property
    def x0(self) -> int:
        """The slab's first plane, counted from the world's lower face."""
        return self.mesh.rank * self.slab_x

    def gather(self) -> SpaceState:
        """The whole state, on every rank (all-gathered), on its device."""
        st = self.state
        cat = lambda t: comm.all_gather(t, self.mesh).flatten(0, 1)  # noqa: E731
        return dataclasses.replace(
            st,
            contents=cat(st.contents),
            light=cat(st.light),
            light_dirty=cat(st.light_dirty),
            cells=self.full_cells.to(st.device),
            lower=self.lower,
        )


def shard_space(state: SpaceState, mesh: Mesh) -> SlabSharded:
    """This rank's slab of `state` (`aic_tpu` slab.py:99): X split into
    equal slabs over the ranks, its window cut and its traversal cells
    rebuilt by `window_state` (the skip field must not see past the
    slab) on the mesh's device, to which only the window is copied.
    Every rank passes the same state, on any device. X must be divisible
    by the world size."""
    size = tuple(int(v) for v in state.contents.shape)
    if size[0] % mesh.world:
        raise ValueError(
            f"slab sharding needs X ({size[0]}) divisible by the rank count ({mesh.world}); "
            "pad the space bounds to a multiple"
        )
    xs = size[0] // mesh.world
    lo = tuple(int(v) for v in state.lower)
    x0 = lo[0] + mesh.rank * xs
    slab = window_state(state, (x0, lo[1], lo[2]), (x0 + xs, lo[1] + size[1], lo[2] + size[2]), mesh.device)
    return SlabSharded(mesh=mesh, state=slab, lower=lo, global_size=size, slab_x=xs, full_cells=state.cells)


def _pad(sh: SlabSharded) -> tuple:
    return tuple(min(sh.state.light_max_distance + 1, s) for s in sh.global_size)


def _extend(sh: SlabSharded, local: torch.Tensor, px: int | None = None) -> torch.Tensor:
    """`local` [Xs, ...] with its X halo of `px` planes (the relight pad by
    default) from the neighbours, clipped at the world's faces: the planes
    [max(0, x0 − px), min(X, x0 + Xs + px))."""
    px = _pad(sh)[0] if px is None else px
    ext = comm.halo_exchange(local, px, sh.mesh)
    lo = max(0, sh.x0 - px) - (sh.x0 - px)
    hi = min(sh.global_size[0], sh.x0 + sh.slab_x + px) - (sh.x0 - px)
    return ext[lo:hi].contiguous()


def _slab_ctx(sh: SlabSharded):
    """The extended slab's relight context (`aic_tpu` slab.py:210), built
    once from a one-time contents halo: (contents, ctx, own planes). The
    pair tables are the world's and only the rank's own planes carry ray
    weight (`dense.build_relight_ctx`'s `size` and `own`)."""
    if sh._ctx is None:
        contents = _extend(sh, sh.state.contents)
        own0 = sh.x0 - max(0, sh.x0 - _pad(sh)[0])
        own = (own0, own0 + sh.slab_x)
        # The context reads the contents, tables, sky and light distance.
        ext = dataclasses.replace(sh.state, contents=contents)
        sh._ctx = (contents, _dense.build_relight_ctx(ext, size=sh.global_size, own=own), own)
    return sh._ctx


def _slab_light_pad(sh: SlabSharded) -> torch.Tensor:
    """The decoded light of the extended slab, from this pass's light halo
    (`aic_tpu` slab.py:178). The pass itself puts the BlockSky one-ring
    around it: at the world's faces, which the extended slab shares, that
    is the world's ring; at an interior cut no chart ray from the own
    planes reaches it."""
    return lightpack.decode_rgb(_extend(sh, sh.state.light)).contiguous()


def relight_pass_slab(sh: SlabSharded, timings: list | None = None) -> dict:
    """One whole-volume Jacobi pass over the slabs (`aic_tpu` slab.py:268),
    called by every rank: each relights its own planes, and the result is
    the unsharded `dense.relight_all_pass`'s, cube for cube. Updates
    `sh.state`'s light and returns {"max_diff"}: the largest change of any
    cube of the world (all-reduced), a tensor. With `timings` (a list),
    appends the milliseconds of the rank's K2 launch (CUDA events; on the
    CPU the plain pass's host time)."""
    contents, ctx, own = _slab_ctx(sh)
    light_rgb = _slab_light_pad(sh)
    rows = sh.state.tables.light_face_rows
    if timings is None:
        incoming, total = relight_pass(contents, light_rgb, rows, ctx)
    else:
        incoming, total = _timed(timings, lambda: relight_pass(contents, light_rgb, rows, ctx), contents.device)
    mine = slice(*own)
    new_light = _dense.finish(ctx.origin_opaque[mine], ctx.origin_emission[mine],
                              incoming[mine] + ctx.incoming0[mine], total[mine])
    diff = lightpack.difference_priority(sh.state.light, new_light).max()
    sh.state = dataclasses.replace(sh.state, light=new_light)
    return {"max_diff": comm.all_reduce(diff, sh.mesh, op="max")}


def _timed(timings: list, fn, device):
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        timings.append((time.perf_counter() - t0) * 1e3)
        return out
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    timings.append(start.elapsed_time(end))
    return out


def evaluate_light_slab(sh: SlabSharded, max_passes: int = 32) -> int:
    """Slab-sharded plain Jacobi (`aic_tpu` slab.py:345): passes until no
    cube of the world moves by more than one packed step (updater.rs:340),
    at most `max_passes`; then every slab's dirty marks are cleared.
    Returns the passes run."""
    passes = 0
    for _ in range(max_passes):
        stats = relight_pass_slab(sh)
        passes += 1
        if int(stats["max_diff"]) <= 1:
            break
    sh.state = dataclasses.replace(sh.state, light_dirty=torch.zeros_like(sh.state.light_dirty))
    return passes


def _trace_state(sh: SlabSharded) -> SpaceState:
    """The slab's window for tracing: its planes and one plane of the
    neighbours' light on each side (clipped at the world's faces). The
    halo planes hold a palette entry that is not visible, so the
    traversal walks through them and hits only the slab's own cubes; the
    traversal cells are built once, the light halo taken anew."""
    st = sh.state
    if sh._trace is None:
        hidden = (~st.tables.visible).nonzero()
        if hidden.numel() == 0:
            raise ValueError("the slab trace needs a palette entry that is not visible for its halo planes")
        contents = _extend(sh, st.contents, 1).clone()
        lo = sh.x0 - max(0, sh.x0 - 1)
        contents[:lo] = int(hidden[0, 0])
        contents[lo + sh.slab_x:] = int(hidden[0, 0])
        cells = _cells_for(st, contents, st.tables)
        lower = (sh.lower[0] + sh.x0 - lo, sh.lower[1], sh.lower[2])
        sh._trace = (contents, cells, lower)
    contents, cells, lower = sh._trace
    return dataclasses.replace(st, contents=contents, light=_extend(sh, st.light, 1),
                               light_dirty=torch.zeros_like(contents, dtype=torch.uint8), cells=cells, lower=lower)


def trace_rays_slab(sh: SlabSharded, origins, directions, options, include_sky: bool = True):
    """Trace against the slab-sharded world (`aic_tpu` slab.py:359), called
    by every rank with every ray (world coordinates, any batch shape).

    Each rank traces all the rays within its slab (general tracer, sky
    off, no beam pre-pass; `_trace_state`); the slabs' premultiplied light and
    transmittance are all-gathered and composited front to back in each
    ray's X direction: ascending X iff dx >= 0. A ray with dx == 0 whose
    origin lies on a cut is inside both slabs' boxes, so only the slab
    that holds its start cube (floor(o_x), clipped to the bounds) counts
    it. The sky is added once after the composite. Returns (light,
    transmittance) on every rank."""
    from ..raytrace.tracer import trace_rays

    dev = sh.state.device
    batch_shape = tuple(origins.shape[:-1])
    o = torch.as_tensor(origins, dtype=torch.float32).reshape(-1, 3).to(dev)
    d = torch.as_tensor(directions, dtype=torch.float32).reshape(-1, 3).to(dev)
    light, trans = trace_rays(_trace_state(sh), o, d, options, include_sky=False, beam_tile=0)
    start = torch.clamp(torch.floor(o[:, 0] - float(sh.lower[0])), 0.0, float(sh.global_size[0] - 1))
    foreign = (d[:, 0] == 0.0) & (start.to(torch.int64) // sh.slab_x != sh.mesh.rank)
    light = torch.where(foreign[:, None], 0.0, light)
    trans = torch.where(foreign, 1.0, trans)
    lg = comm.all_gather(light, sh.mesh)  # [D, n, 3]
    tg = comm.all_gather(trans, sh.mesh)  # [D, n]

    def composite(ls, ts):
        # Exclusive prefix product of transmittance (robust to ts == 0).
        before = torch.cat([torch.ones_like(ts[:1]), torch.cumprod(ts, dim=0)[:-1]], dim=0)
        return (ls * before[..., None]).sum(0)

    fwd = (d[:, 0] >= 0.0)[:, None]
    light = torch.where(fwd, composite(lg, tg), composite(lg.flip(0), tg.flip(0)))
    trans = torch.prod(tg, dim=0)
    if include_sky:
        oct_idx = (d[:, 0] >= 0).long() * 4 + (d[:, 1] >= 0).long() * 2 + (d[:, 2] >= 0).long()
        light = light + sh.state.sky_octants[oct_idx] * trans[..., None]
        trans = torch.zeros_like(trans)
    return light.reshape(batch_shape + (3,)), trans.reshape(batch_shape)
