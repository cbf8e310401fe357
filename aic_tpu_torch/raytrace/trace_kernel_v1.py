"""v1 surface-finder kernel (`csrc/trace_v1.cu`), its plain twin, and the
round loop around them. Counterpart of the v1 half of
`aic_tpu/raytrace/pallas_trace.py`.

The kernel replaces the TPU kernel `aic_tpu/raytrace/pallas_trace.py:198
_make_kernel` (launched by `_run_kernel`, driven by `_trace_pallas_impl`).
It only finds surfaces: per ray it runs the two-level DDA from the ray's
cube to its next surface event and stops there -- `HIT_OUTER` (a visible
outer cube: atom or voxel block), `HIT_INNER` (a visible voxel inside a
block's grid), `INNER_EXIT` (left a block's grid) -- or where the ray
leaves the volume. Its tables are one 128-word bit row per 16³ region,
then one per voxel entry at its native edge (R ≤ 16), and the L1 row of
region bits.

Classification, voxel-grid entry and the pop back to the outer registers
stay between launches, in PyTorch (`advance_packed`, the glue of
`_trace_pallas_impl`): an atom ends the ray; a voxel block saves the outer
registers and enters the block's grid one voxel early with a 1e-4/|d|
nudge; `INNER_EXIT` restores them. The glue reads each hit cube's packed
cell (`SpaceState.cells`). Rounds repeat while any ray walks, up to
`ROUNDS` per phase. Keeping the push and pop inside one kernel is what
the megakernel (`trace_kernel.py`) does; this path serves the states whose
megakernel tables do not fit (`trace_kernel.megakernel_fits`).

The round loop (`trace_phases_v1`) packs the ray constants once per call
and carries the state, saved registers and hit buffers in one i32[28, m]
round buffer (`pack_round`). A frame's first round walks nearly every
ray and its later rounds a few (plaza640 at 1080p: 2.07 M, 1.04 M, 319,
311), so each round lists the rays that walk in it, launches the kernel
over the list and runs the glue on the same rays (`walk_round`,
`advance_packed`); the result is bit for bit that of the all-ray loop
(`trace_phases_all_rays` with the per-field glue `advance`, as `aic_tpu`
runs it: the reference). The glue of a round is ~150 PyTorch operations
whatever its size, so the rounds are bound by their dispatch on the
host.

On the H100 the kernel is one thread per ray; what bounds it is the
per-step arithmetic and the serial chain of the longest rays (see
`csrc/trace_v1.cu`). The TPU kernel's min-domain group synchronisation
and its `domains_per_iter` / `macro_steps` knobs only schedule rays
inside a group of 1024 and do not change a ray's result; they are gone.

`run_surface_finder` (all rays) and `find_surfaces` (a walking list)
dispatch on the tensors' device: CPU → the plain vectorised version, CUDA
→ the kernel or an exception.
"""

from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..space.state import SpaceState
from .accel import RES_SHIFT, VOXEL_BIT, brick_dims
from .trace_kernel import (
    MAX_REGIONS,
    PHASES,
    REGION,
    PackedRays,
    _argmin3,
    _pack_bits_3d,
    _w,
    pack_fields,
    region_count,
    unpack_fields,
)
from .tracer import HIT_ATOM, HIT_NONE as TR_HIT_NONE, HIT_VOXEL

#: Launches of the CUDA kernel by this process (the plain version does
#: not count).
LAUNCHES = 0

#: Per-launch iteration budget and rounds per phase. `aic_tpu` runs 48
#: iterations per launch and 48 rounds; its rays also spend iterations
#: waiting for their group's domain, so a ray that `aic_tpu` finishes needs
#: at most 48 × 48 of its own iterations for any one event, and at most 48
#: events per phase: it finishes here too.
ITERS = 48 * 48
ROUNDS = 48
#: Cube steps per iteration within one domain, `aic_tpu`'s v1 default.
#: It moves no hit; it moves only where a ray that crosses an empty region
#: from outside stops once the macro step sees it leave the volume.
SUBSTEPS = 4

HIT_NONE = 0
HIT_OUTER = 1  # entered a visible outer cube (atom OR voxel block)
HIT_INNER = 2  # entered a visible voxel within a block grid
INNER_EXIT = 3  # left a voxel grid without a hit (resume outer)

#: Kernel input: 9 state fields (after the ray constants of
#: `trace_kernel.RAY_FIELDS`); output: 15 fields.
STATE_FIELDS = ("dom", "cx", "cy", "cz", "tmx", "tmy", "tmz", "resl", "walking")
OUT_FIELDS = (
    "dom", "cx", "cy", "cz", "tmx", "tmy", "tmz",
    "walking", "hit", "face", "t", "nt", "hx", "hy", "hz",
)
FLOAT_FIELDS = frozenset(("tmx", "tmy", "tmz", "t", "nt"))


@dataclass(frozen=True)
class BitmaskCtx:
    """v1 tables; u32 words are held as int32 (see state.py)."""

    rows: torch.Tensor  # i32[n_regions + n_ventries, 128] visibility bits
    l1: torch.Tensor  # i32[1, 128] region-occupancy bits
    rdims: tuple
    size: tuple
    n_regions: int
    n_ventries: int


def build_bitmask_ctx(state: SpaceState) -> BitmaskCtx:
    """Region rows, then one row per voxel entry at its native edge, and
    the L1 row (host numpy, as `aic_tpu` `build_bitmask_ctx`,
    pallas_trace.py:110-169)."""
    t = state.tables
    contents = state.contents.cpu().numpy()
    visible = t.visible.cpu().numpy()[contents]
    sx, sy, sz = contents.shape
    rd = (-(-sx // REGION), -(-sy // REGION), -(-sz // REGION))
    n_regions = rd[0] * rd[1] * rd[2]
    if n_regions > MAX_REGIONS:
        raise ValueError(
            f"{n_regions} regions > {MAX_REGIONS}: window the state, or trace it "
            "with the general tracer (tracer.trace_rays), as render does"
        )
    max_r = t.padded_voxel_resolution
    if max_r > REGION:
        raise ValueError(
            f"voxel resolution {max_r} > {REGION} unsupported by the v1 kernel; the "
            "general tracer (tracer.trace_rays) holds it, and render sends it there"
        )

    rows = np.empty((n_regions, 128), np.uint32)
    l1_bits = np.zeros(n_regions, bool)
    for rx in range(rd[0]):
        for ry in range(rd[1]):
            for rz in range(rd[2]):
                sub = visible[
                    rx * REGION : (rx + 1) * REGION,
                    ry * REGION : (ry + 1) * REGION,
                    rz * REGION : (rz + 1) * REGION,
                ]
                rid = (rx * rd[1] + ry) * rd[2] + rz
                rows[rid] = _pack_bits_3d(sub, REGION)
                l1_bits[rid] = sub.any()

    # A voxel is visible if it has alpha or emission (the packed cells'
    # predicate).
    vr = t.vox_rows.cpu().numpy()
    vis_v = (vr[..., 3] > 0.0) | (vr[..., 4:7] != 0.0).any(-1)
    n_ventries = vis_v.shape[0]
    voxel_index = t.voxel_index.cpu().numpy()
    res_log2 = t.res_log2.cpu().numpy()
    ventry_res = np.zeros(n_ventries, np.int32)
    live = voxel_index >= 0
    ventry_res[voxel_index[live]] = 1 << res_log2[live]
    vrows = np.zeros((n_ventries, 128), np.uint32)
    for v in range(n_ventries):
        r = int(ventry_res[v]) or 1
        vrows[v] = _pack_bits_3d(vis_v[v][:r, :r, :r], r)

    l1_words = np.zeros(128, np.uint32)
    idx = np.nonzero(l1_bits)[0]
    np.bitwise_or.at(l1_words, idx >> 5, np.uint32(1) << (idx & 31).astype(np.uint32))

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a).view(np.int32), device=state.device)

    return BitmaskCtx(
        rows=i32(np.concatenate([rows, vrows], axis=0)),
        l1=i32(l1_words[None, :]),
        rdims=rd,
        size=(sx, sy, sz),
        n_regions=n_regions,
        n_ventries=n_ventries,
    )


def v1_fits(state: SpaceState) -> bool:
    """True when the v1 kernel's tables hold the state: at most
    `MAX_REGIONS` 16³ regions and voxel resolution at most 16 (what
    `build_bitmask_ctx` refuses). Decided without building them."""
    return region_count(state) <= MAX_REGIONS and state.tables.padded_voxel_resolution <= REGION


#: id(state.contents) → (weakref to it, ctx): one build per snapshot.
_CTX_CACHE: dict = {}


def get_bitmask_ctx(state: SpaceState) -> BitmaskCtx:
    key = id(state.contents)
    hit = _CTX_CACHE.get(key)
    if hit is not None and hit[0]() is state.contents:
        return hit[1]
    ctx = build_bitmask_ctx(state)
    if len(_CTX_CACHE) >= 8:
        _CTX_CACHE.pop(next(iter(_CTX_CACHE)))
    _CTX_CACHE[key] = (weakref.ref(state.contents), ctx)
    return ctx


def surface_finder_plain(rays: dict, st: dict, ctx: BitmaskCtx, work: dict | None = None) -> dict:
    """Plain PyTorch surface finder: the kernel's per-ray logic as a
    masked loop over all rays, up to `ITERS` iterations. Each iteration
    does, per walking ray, either one macro step across an empty region
    or up to `SUBSTEPS` cube steps within its current domain. Returns the
    15 `OUT_FIELDS`. `work`, a dict, gets the work the kernel does on
    these inputs, by branch: "rays" and "walking" (rays, and those
    walking at launch); "inner" and "macro_rays" (walking rays in a voxel
    grid, and rays that take a macro step: those that read their grid's
    resolution, and their origin and direction); "iters" and "outer_iters"
    (iterations of walking rays, and those in an outer domain);
    "macro_steps"; "steps" and "outer_steps" (cube-step attempts, and
    those in an outer domain); "tests" (attempts that test a bit:
    neither a region change nor a step out of the volume or grid);
    "hits"; and "ray_steps", each ray's attempts (i32[m], the critical
    path's length, no operation count)."""
    ox, oy, oz = rays["ox"], rays["oy"], rays["oz"]
    dx, dy, dz = rays["dx"], rays["dy"], rays["dz"]
    ivx, ivy, ivz = rays["ivx"], rays["ivy"], rays["ivz"]
    stx, sty, stz = rays["stx"], rays["sty"], rays["stz"]
    spx, spy, spz = (stx > 0).int(), (sty > 0).int(), (stz > 0).int()
    sx, sy, sz = ctx.size
    rdy, rdz = ctx.rdims[1], ctx.rdims[2]
    n_regions = ctx.n_regions
    n_domains = ctx.rows.shape[0]
    l1 = ctx.l1[0]
    inf = torch.full_like(ox, float("inf"))
    dom, cx, cy, cz = st["dom"], st["cx"], st["cy"], st["cz"]
    tmx, tmy, tmz = st["tmx"], st["tmy"], st["tmz"]
    resl = st["resl"]
    walking = st["walking"] == 1
    zi = torch.zeros_like(dom)
    zf = torch.zeros_like(ox)
    hit, face, hx, hy, hz = zi, zi, zi, zi, zi
    t, nt = zf, zf
    redge_in = 1 << resl
    scale_in = redge_in.float()

    def region_id(cx, cy, cz):
        return ((cx >> 4) * rdy + (cy >> 4)) * rdz + (cz >> 4)

    def outside(cx, cy, cz, ex, ey, ez):
        return (cx < 0) | (cx >= ex) | (cy < 0) | (cy >= ey) | (cz < 0) | (cz >= ez)

    def count(key, mask):
        if work is not None:
            work[key] = work.get(key, 0) + int(mask.sum())

    if work is not None:
        work["rays"] = work.get("rays", 0) + ox.shape[0]
        work["ray_steps"] = work.get("ray_steps", 0) + torch.zeros_like(dom)
    count("walking", walking)
    count("inner", walking & (dom >= n_regions))
    macro = torch.zeros_like(walking)
    for _ in range(ITERS):
        if not bool(walking.any()):
            break
        # ---- macro step across an empty region --------------------------
        inner = dom >= n_regions
        count("iters", walking)
        count("outer_iters", walking & ~inner)
        dom_c = dom.clamp(0, MAX_REGIONS - 1)
        l1bit = (l1[(dom_c >> 5).long()] >> (dom_c & 31)) & 1
        in_empty = walking & ~inner & (l1bit == 0) & ~outside(cx, cy, cz, sx, sy, sz)
        count("macro_steps", in_empty)
        macro = macro | in_empty
        rbx, rby, rbz = ((cx >> 4) + spx) << 4, ((cy >> 4) + spy) << 4, ((cz >> 4) + spz) << 4
        rtx = _w(stx == 0, inf, (rbx.float() - ox) * ivx)
        rty = _w(sty == 0, inf, (rby.float() - oy) * ivy)
        rtz = _w(stz == 0, inf, (rbz.float() - oz) * ivz)
        rax = _argmin3(rtx, rty, rtz)
        rt = torch.minimum(rtx, torch.minimum(rty, rtz))
        fx = torch.minimum(torch.maximum(torch.floor(ox + dx * rt).int(), (cx >> 4) << 4), ((cx >> 4) << 4) + 15)
        fy = torch.minimum(torch.maximum(torch.floor(oy + dy * rt).int(), (cy >> 4) << 4), ((cy >> 4) << 4) + 15)
        fz = torch.minimum(torch.maximum(torch.floor(oz + dz * rt).int(), (cz >> 4) << 4), ((cz >> 4) << 4) + 15)
        ecx = _w(rax == 0, _w(stx > 0, rbx, rbx - 1), fx)
        ecy = _w(rax == 1, _w(sty > 0, rby, rby - 1), fy)
        ecz = _w(rax == 2, _w(stz > 0, rbz, rbz - 1), fz)
        exits = outside(ecx, ecy, ecz, sx, sy, sz)
        adv = in_empty & ~exits
        cx, cy, cz = _w(adv, ecx, cx), _w(adv, ecy, cy), _w(adv, ecz, cz)
        tmx = _w(adv, _w(stx == 0, inf, ((cx + spx).float() - ox) * ivx), tmx)
        tmy = _w(adv, _w(sty == 0, inf, ((cy + spy).float() - oy) * ivy), tmy)
        tmz = _w(adv, _w(stz == 0, inf, ((cz + spz).float() - oz) * ivz), tmz)
        dom = _w(adv, region_id(cx, cy, cz), dom)
        walking = walking & ~(in_empty & exits)

        # ---- cube steps within the current domain ------------------------
        dom_start = dom
        for _k in range(SUBSTEPS):
            inner = dom >= n_regions
            act = walking & (dom == dom_start) & ~in_empty
            if not bool(act.any()):
                break
            redge = _w(inner, redge_in, REGION)
            scale = _w(inner, scale_in, 1.0)
            ax = _argmin3(tmx, tmy, tmz)
            t_hit = torch.minimum(tmx, torch.minimum(tmy, tmz))
            stax = _w(ax == 0, stx, _w(ax == 1, sty, stz))
            f = _w(stax > 0, ax, ax + 3)
            ncx = cx + _w(ax == 0, stx, 0)
            ncy = cy + _w(ax == 1, sty, 0)
            ncz = cz + _w(ax == 2, stz, 0)
            utx = tmx + _w(ax == 0, ivx.abs() / scale, 0.0)
            uty = tmy + _w(ax == 1, ivy.abs() / scale, 0.0)
            utz = tmz + _w(ax == 2, ivz.abs() / scale, 0.0)
            out_exit = ~inner & outside(ncx, ncy, ncz, sx, sy, sz)
            new_dom = region_id(ncx, ncy, ncz)
            region_change = ~inner & ~out_exit & (new_dom != dom)
            in_exit = inner & outside(ncx, ncy, ncz, redge, redge, redge)
            lx = _w(inner, ncx, ncx & 15).clamp(0, 15)
            ly = _w(inner, ncy, ncy & 15).clamp(0, 15)
            lz = _w(inner, ncz, ncz & 15).clamp(0, 15)
            edge_l2 = _w(inner, resl, 4)
            local = (((lx << edge_l2) + ly) << edge_l2) + lz
            widx = (local >> 5).clamp(0, 127)
            word = ctx.rows[dom.clamp(0, n_domains - 1).long(), widx.long()]
            bit = (word >> (local & 31)) & 1
            hit_now = act & ~out_exit & ~in_exit & ~region_change & (bit == 1)
            commit = act & ~region_change
            count("steps", act)
            if work is not None:
                work["ray_steps"] = work["ray_steps"] + act.int()
            count("outer_steps", act & ~inner)
            count("tests", commit & ~out_exit & ~in_exit)
            count("hits", hit_now)
            dom = _w(act & region_change, new_dom, dom)
            cx, cy, cz = _w(commit, ncx, cx), _w(commit, ncy, cy), _w(commit, ncz, cz)
            tmx, tmy, tmz = _w(commit, utx, tmx), _w(commit, uty, tmy), _w(commit, utz, tmz)
            hitk = _w(hit_now, _w(inner, HIT_INNER, zi + HIT_OUTER), _w(act & in_exit, INNER_EXIT, zi))
            record = hitk != 0
            hit = _w(record, hitk, hit)
            face = _w(hit_now, f, face)
            t = _w(hit_now, t_hit, t)
            nt = _w(hit_now, torch.minimum(utx, torch.minimum(uty, utz)), nt)
            hx, hy, hz = _w(hit_now, ncx, hx), _w(hit_now, ncy, hy), _w(hit_now, ncz, hz)
            walking = walking & ~record & ~(act & out_exit)
    count("macro_rays", macro)
    return dict(
        dom=dom, cx=cx, cy=cy, cz=cz, tmx=tmx, tmy=tmy, tmz=tmz,
        walking=walking.to(torch.int32), hit=hit, face=face, t=t, nt=nt,
        hx=hx, hy=hy, hz=hz,
    )


def _fn():
    lib = kernels.load_library("trace_v1")
    fn = lib.aic_trace_v1
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(rays: PackedRays, st_in: torch.Tensor, ctx: BitmaskCtx,
           idx: torch.Tensor | None = None) -> torch.Tensor:
    """Launch `csrc/trace_v1.cu` on packed inputs (the state as
    `pack_fields(st, STATE_FIELDS, FLOAT_FIELDS)`, i32[9, m]) over the
    rays `idx` (i64[n], each walking), or over all m rays without a list.
    Returns the packed i32[15, n] `OUT_FIELDS`, column j for ray idx[j].
    An empty list launches nothing."""
    global LAUNCHES
    dev = ctx.rows.device
    m = rays.f.shape[1]
    n = m if idx is None else idx.shape[0]
    req = kernels.require
    req(rays.f, "rays", torch.float32, (9, m), dev)
    req(rays.i, "ray steps", torch.int32, (3, m), dev)
    req(st_in, "state", torch.int32, (len(STATE_FIELDS), m), dev)
    req(ctx.l1, "l1", torch.int32, (1, 128), dev)
    req(ctx.rows, "rows", torch.int32, (ctx.rows.shape[0], 128), dev)
    if idx is not None:
        req(idx, "walking list", torch.int64, (n,), dev)
    out = torch.empty((len(OUT_FIELDS), n), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    ptr = kernels.ptr
    err = _fn()(
        ptr(rays.f), ptr(rays.i), ptr(st_in), ptr(out), ptr(ctx.l1), ptr(ctx.rows),
        ctypes.c_void_p(0) if idx is None else ptr(idx), n, m,
        ITERS, SUBSTEPS, ctx.n_regions, ctx.rows.shape[0],
        ctx.size[0], ctx.size[1], ctx.size[2], ctx.rdims[1], ctx.rdims[2],
        kernels.stream_ptr(dev),
    )
    LAUNCHES += 1
    kernels.check_launch(err, "trace v1 kernel")
    return out


def surface_finder_cuda(rays: dict, st: dict, ctx: BitmaskCtx) -> dict:
    """Pack, then launch `csrc/trace_v1.cu` once over all rays; same
    contract as `surface_finder_plain`. Writes none of its inputs."""
    st_in = pack_fields(st, STATE_FIELDS, FLOAT_FIELDS)
    return unpack_fields(launch(PackedRays.pack(rays), st_in, ctx), OUT_FIELDS, FLOAT_FIELDS)


def run_surface_finder(rays: dict, st: dict, ctx: BitmaskCtx) -> dict:
    """One surface-finder launch over all rays: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    dev = ctx.rows.device
    if dev.type == "cuda":
        return surface_finder_cuda(rays, st, ctx)
    if dev.type == "cpu":
        return surface_finder_plain(rays, st, ctx)
    raise ValueError(f"no v1 trace kernel for device {dev}")


def find_surfaces(rays: PackedRays, st_buf: torch.Tensor, idx: torch.Tensor, ctx: BitmaskCtx) -> torch.Tensor:
    """The surface finder over the listed rays `idx` of the packed state:
    the kernel reads them through the list on CUDA; on the CPU the plain
    version runs on the gathered rays. Returns the packed i32[15, n]
    `OUT_FIELDS` of the listed rays, in list order."""
    dev = ctx.rows.device
    if dev.type == "cuda":
        return launch(rays, st_buf, ctx, idx)
    if dev.type == "cpu":
        st = unpack_fields(st_buf[:, idx], STATE_FIELDS, FLOAT_FIELDS)
        return pack_fields(surface_finder_plain(rays.take(idx).fields(), st, ctx), OUT_FIELDS, FLOAT_FIELDS)
    raise ValueError(f"no v1 trace kernel for device {dev}")


def initial_state_v1(st2: dict) -> dict:
    """The 9-field launch state from the megakernel's initial state
    (`trace_kernel.initial_state`): the same entry cube, domain and
    boundary t, outer resolution, and walking where the ray meets the
    volume (`_trace_pallas_impl`'s set-up, pallas_trace.py:539-556)."""
    st = {k: st2[k] for k in ("dom", "cx", "cy", "cz", "tmx", "tmy", "tmz", "resl")}
    st["walking"] = st2["mode"]
    return st


def empty_buffers(m: int, device) -> tuple[dict, dict]:
    """Zeroed saved outer registers and hit buffers for `m` rays."""
    zi = torch.zeros(m, dtype=torch.int32, device=device)
    zf = torch.zeros(m, dtype=torch.float32, device=device)
    saved = dict(sdom=zi, scx=zi, scy=zi, scz=zi, stmx=zf, stmy=zf, stmz=zf, sbx=zi, sby=zi, sbz=zi)
    hb = dict(
        hit_kind=zi, hit_idx=zi, hit_vflat=zi, hit_face=zi, hit_t=zf, hit_next_t=zf,
        hit_cube=torch.zeros((m, 3), dtype=torch.int32, device=device),
    )
    return saved, hb


#: The round loop's packed buffer, i32[28, m]: the 9-field launch state,
#: the saved outer registers and the hit buffers (`hit_cube` in the last
#: three rows); float fields bit-cast.
SAVED_FIELDS = ("sdom", "scx", "scy", "scz", "stmx", "stmy", "stmz", "sbx", "sby", "sbz")
HIT_FIELDS = ("hit_kind", "hit_idx", "hit_vflat", "hit_face", "hit_t", "hit_next_t")
ROUND_ROWS = len(STATE_FIELDS) + len(SAVED_FIELDS) + len(HIT_FIELDS) + 3
ROUND_FLOAT = frozenset(("tmx", "tmy", "tmz", "stmx", "stmy", "stmz", "hit_t", "hit_next_t"))
_S, _H = len(STATE_FIELDS), len(STATE_FIELDS) + len(SAVED_FIELDS)  # first saved / hit row
WALKING_ROW = STATE_FIELDS.index("walking")
HIT_KIND_ROW = _H


def pack_round(st: dict, saved: dict, hb: dict) -> torch.Tensor:
    """State, saved registers and hit buffers → the i32[28, n] round buffer."""
    return torch.cat([
        pack_fields(st, STATE_FIELDS, ROUND_FLOAT), pack_fields(saved, SAVED_FIELDS, ROUND_FLOAT),
        pack_fields(hb, HIT_FIELDS, ROUND_FLOAT), hb["hit_cube"].T,
    ])


def hit_buffers(buf: torch.Tensor) -> dict:
    """The hit-buffer dict (`advance`'s, the shader's) as views of a round
    buffer."""
    hb = unpack_fields(buf[_H : _H + 6], HIT_FIELDS, ROUND_FLOAT)
    hb["hit_cube"] = buf[_H + 6 :].T
    return hb


def unpack_round(buf: torch.Tensor) -> tuple[dict, dict, dict]:
    """The inverse of `pack_round`: (state, saved registers, hit buffers) as
    views."""
    return (unpack_fields(buf[:_S], STATE_FIELDS, ROUND_FLOAT),
            unpack_fields(buf[_S:_H], SAVED_FIELDS, ROUND_FLOAT), hit_buffers(buf))


def _fetch_cell(state: SpaceState, size, x, y, z):
    """Packed outer cell at (x, y, z), clamped into the volume, from the
    brick rows (pallas_trace.py:576-585)."""
    sbd = brick_dims(size)
    xc, yc, zc = x.clamp(0, size[0] - 1), y.clamp(0, size[1] - 1), z.clamp(0, size[2] - 1)
    key = ((xc >> 2) * sbd[1] + (yc >> 2)) * sbd[2] + (zc >> 2)
    local = ((xc & 3) << 4) | ((yc & 3) << 2) | (zc & 3)
    return state.cells[key.long(), local.long()]


def advance(state: SpaceState, ctx: BitmaskCtx, rays: dict, d_len, st: dict, saved: dict, hb: dict, out: dict):
    """One round's glue after a launch (pallas_trace.py:593-690): classify
    each hit through its packed cell, record final hits in the hit
    buffers, and carry the state over -- a voxel block pushes the outer
    registers and enters its grid one voxel early (1e-4/|d| nudge), an
    inner exit pops them. Returns (st, saved, hb) for the next launch.
    Per field, as `aic_tpu`'s glue: the all-ray loop's, and the reference
    that `advance_packed` equals bit for bit."""
    n_regions = ctx.n_regions
    max_r = state.tables.padded_voxel_resolution
    hit = out["hit"]
    hx, hy, hz = out["hx"], out["hy"], out["hz"]
    cell = _fetch_cell(state, ctx.size, hx, hy, hz)
    is_vox = (cell & VOXEL_BIT) != 0
    payload = cell & 0xFFFF
    res_log2 = (cell >> RES_SHIFT) & 7

    outer = hit == HIT_OUTER
    atom = outer & ~is_vox
    vox = outer & is_vox
    innerh = hit == HIT_INNER
    iexit = hit == INNER_EXIT
    final = atom | innerh

    # ---- record final hits ------------------------------------------------
    vflat = (out["dom"] - n_regions) * (max_r**3) + (hx * max_r + hy) * max_r + hz
    block_cube = torch.stack([saved["sbx"], saved["sby"], saved["sbz"]], -1)
    hit_cube = torch.stack([hx, hy, hz], -1)
    hb = dict(
        hit_kind=_w(atom, HIT_ATOM, _w(innerh, HIT_VOXEL, hb["hit_kind"])),
        hit_idx=_w(atom, payload, hb["hit_idx"]),
        hit_vflat=_w(innerh, vflat, hb["hit_vflat"]),
        hit_face=_w(final, out["face"], hb["hit_face"]),
        hit_t=_w(final, out["t"], hb["hit_t"]),
        hit_next_t=_w(final, out["nt"], hb["hit_next_t"]),
        hit_cube=torch.where(
            final[:, None], torch.where(innerh[:, None], block_cube, hit_cube), hb["hit_cube"]
        ),
    )

    # ---- voxel-block entry registers: one virtual voxel early along the
    # entry face axis (recursive_raycast, raycast.rs:458) -------------------
    t = out["t"]
    axis = out["face"] % 3
    ohx, ohy, ohz = (axis == 0).int(), (axis == 1).int(), (axis == 2).int()
    blk_res = 1 << res_log2
    rf = blk_res.float()
    iox = (rays["ox"] - hx.float()) * rf
    ioy = (rays["oy"] - hy.float()) * rf
    ioz = (rays["oz"] - hz.float()) * rf
    nud = 1e-4 / d_len
    epx = iox + rays["dx"] * rf * t + rays["dx"] * nud
    epy = ioy + rays["dy"] * rf * t + rays["dy"] * nud
    epz = ioz + rays["dz"] * rf * t + rays["dz"] * nud
    icx = torch.minimum(torch.clamp(torch.floor(epx).int(), min=0), blk_res - 1)
    icy = torch.minimum(torch.clamp(torch.floor(epy).int(), min=0), blk_res - 1)
    icz = torch.minimum(torch.clamp(torch.floor(epz).int(), min=0), blk_res - 1)
    stx, sty, stz = rays["stx"], rays["sty"], rays["stz"]
    inf = torch.full_like(t, float("inf"))
    itmx = _w(stx == 0, inf, ((icx + (stx > 0).int()).float() - iox) * rays["ivx"] / rf)
    itmy = _w(sty == 0, inf, ((icy + (sty > 0).int()).float() - ioy) * rays["ivy"] / rf)
    itmz = _w(stz == 0, inf, ((icz + (stz > 0).int()).float() - ioz) * rays["ivz"] / rf)

    # ---- state transitions ----------------------------------------------
    def sel3(on_vox, on_exit, dflt):
        return _w(vox, on_vox, _w(iexit, on_exit, dflt))

    st = dict(
        dom=sel3(n_regions + payload, saved["sdom"], out["dom"]),
        cx=sel3(icx - ohx * stx, saved["scx"], out["cx"]),
        cy=sel3(icy - ohy * sty, saved["scy"], out["cy"]),
        cz=sel3(icz - ohz * stz, saved["scz"], out["cz"]),
        tmx=sel3(_w(ohx == 1, t, itmx), saved["stmx"], out["tmx"]),
        tmy=sel3(_w(ohy == 1, t, itmy), saved["stmy"], out["tmy"]),
        tmz=sel3(_w(ohz == 1, t, itmz), saved["stmz"], out["tmz"]),
        resl=sel3(res_log2, 0, st["resl"]),
        walking=(vox | iexit | (out["walking"] == 1)).to(torch.int32),
    )
    saved = dict(
        sdom=_w(vox, out["dom"], saved["sdom"]),
        scx=_w(vox, out["cx"], saved["scx"]),
        scy=_w(vox, out["cy"], saved["scy"]),
        scz=_w(vox, out["cz"], saved["scz"]),
        stmx=_w(vox, out["tmx"], saved["stmx"]),
        stmy=_w(vox, out["tmy"], saved["stmy"]),
        stmz=_w(vox, out["tmz"], saved["stmz"]),
        sbx=_w(vox, hx, saved["sbx"]),
        sby=_w(vox, hy, saved["sby"]),
        sbz=_w(vox, hz, saved["sbz"]),
    )
    return st, saved, hb


def advance_packed(state: SpaceState, ctx: BitmaskCtx, rays: PackedRays, d_len, buf: torch.Tensor,
                   out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One round's glue after a launch (pallas_trace.py:593-690), on packed
    columns: rays, the i32[28, n] round buffer the launch read and its
    i32[15, n] output. Classifies each hit through its packed cell, records
    final hits in the hit buffers, and carries the state over -- a voxel
    block pushes the outer registers and enters its grid one voxel early
    (1e-4/|d| nudge), an inner exit pops them. The x, y and z of a quantity
    are one [3, n] tensor, each element computed by the same operations in
    the same order as in `advance`. Returns (the next round buffer,
    walking bool[n])."""
    n_regions = ctx.n_regions
    max_r = state.tables.padded_voxel_resolution
    hit, face, t = out[8], out[9], out[10].view(torch.float32)
    h = out[12:15]
    cell = _fetch_cell(state, ctx.size, h[0], h[1], h[2])
    is_vox = (cell & VOXEL_BIT) != 0
    payload = cell & 0xFFFF
    res_log2 = (cell >> RES_SHIFT) & 7

    outer = hit == HIT_OUTER
    atom = outer & ~is_vox
    vox = outer & is_vox
    innerh = hit == HIT_INNER
    iexit = hit == INNER_EXIT
    final = atom | innerh

    # ---- record final hits -------------------------------------------------
    old = buf[_H:]
    vflat = (out[0] - n_regions) * (max_r**3) + (h[0] * max_r + h[1]) * max_r + h[2]
    hits = torch.cat([
        torch.stack([
            _w(atom, HIT_ATOM, _w(innerh, HIT_VOXEL, old[0])),
            _w(atom, payload, old[1]),
            _w(innerh, vflat, old[2]),
        ]),
        _w(final, out[9:12], old[3:6]),  # face, t, next t
        _w(final, _w(innerh, buf[_H - 3 : _H], h), old[6:9]),  # the block's cube for a voxel
    ])

    # ---- voxel-block entry registers: one virtual voxel early along the
    # entry face axis (recursive_raycast, raycast.rs:458) -------------------
    o, d, iv, step = rays.f[0:3], rays.f[3:6], rays.f[6:9], rays.i
    oh = (face % 3) == torch.arange(3, device=face.device)[:, None]
    blk_res = 1 << res_log2
    rf = blk_res.float()
    io = (o - h.float()) * rf
    ep = io + d * rf * t + d * (1e-4 / d_len)
    ic = torch.minimum(torch.clamp(torch.floor(ep).int(), min=0), blk_res - 1)
    itm = _w(step == 0, float("inf"), ((ic + (step > 0).int()).float() - io) * iv / rf)

    # ---- state transitions: enter the block, pop on an inner exit ----------
    on_vox = torch.cat([
        (n_regions + payload)[None], ic - oh.int() * step, _w(oh, t, itm).view(torch.int32), res_log2[None],
    ])
    on_exit = torch.cat([buf[_S : _S + 7], torch.zeros_like(buf[:1])])
    walking = vox | iexit | (out[7] == 1)
    st = torch.cat([
        _w(vox, on_vox, _w(iexit, on_exit, torch.cat([out[0:7], buf[7:8]]))),
        walking.to(torch.int32)[None],
    ])
    saved = _w(vox, torch.cat([out[0:7], h]), buf[_S:_H])
    return torch.cat([st, saved, hits]), walking


def walk_round(state: SpaceState, ctx: BitmaskCtx, rays: PackedRays, d_len, buf: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """One round over the walking rays `idx` (i64[n], the rays whose state
    walks) of the round buffer `buf` (i32[28, m], `pack_round`): the
    surface finder over the list, `advance_packed` over the same rays, its
    results scattered into `buf` (the rays off the list keep theirs, as an
    all-ray round leaves them). Returns the rays that walk in the next
    round."""
    out = find_surfaces(rays, buf[:_S], idx, ctx)
    nxt, walking = advance_packed(state, ctx, rays.take(idx), d_len[idx], buf[:, idx], out)
    buf[:, idx] = nxt
    return idx[walking]


def trace_phases_v1(state: SpaceState, ctx: BitmaskCtx, rays: dict, st2: dict, d_len, shade_fn):
    """The v1 phase loop (`_trace_pallas_impl`, pallas_trace.py:696-714):
    per phase, rounds of the surface finder + the glue while any ray walks
    (at most `ROUNDS`), then shading of the phase's final hits; a ray
    resumes in the next phase while its transmittance is at least 1/256.
    The ray constants are packed once and the state, saved registers and
    hit buffers carried in one packed buffer; each round walks only the
    rays that walk in it (`walk_round`), and its list is the one sync per
    round. Returns (light f32[m,3], transmittance f32[m], unfinished bool),
    the sky not yet added; `unfinished` is set when a ray still walks after
    `ROUNDS` rounds. Equals `trace_phases_all_rays` bit for bit."""
    dev = ctx.rows.device
    m = rays["ox"].shape[0]
    packed = PackedRays.pack(rays)
    buf = pack_round(initial_state_v1(st2), *empty_buffers(m, dev))
    light_acc = torch.zeros((m, 3), dtype=torch.float32, device=dev)
    trans_acc = torch.ones(m, dtype=torch.float32, device=dev)
    unfinished = False
    idx = torch.nonzero(buf[WALKING_ROW] == 1).squeeze(1)
    for _phase in range(PHASES):
        for _round in range(ROUNDS):
            if idx.numel() == 0:
                break
            idx = walk_round(state, ctx, packed, d_len, buf, idx)
        unfinished = unfinished or idx.numel() > 0
        has_hit = buf[HIT_KIND_ROW] != TR_HIT_NONE
        if bool(has_hit.any()):
            light_acc, trans_acc = shade_fn(hit_buffers(buf), light_acc, trans_acc)
        resume = has_hit & (trans_acc >= 1.0 / 256.0)
        idx = torch.nonzero(resume).squeeze(1)
        if idx.numel() == 0:
            break
        buf[WALKING_ROW] = resume.to(torch.int32)
        buf[HIT_KIND_ROW] = 0
    return light_acc, trans_acc, unfinished


def trace_phases_all_rays(state: SpaceState, ctx: BitmaskCtx, rays: dict, st2: dict, d_len, shade_fn):
    """The same phase loop with every round over all rays (one launch on
    all m rays, `advance` on all of them), as `aic_tpu` runs it: the
    reference that `trace_phases_v1` equals bit for bit."""
    dev = ctx.rows.device
    m = rays["ox"].shape[0]
    st = initial_state_v1(st2)
    saved, hb = empty_buffers(m, dev)
    light_acc = torch.zeros((m, 3), dtype=torch.float32, device=dev)
    trans_acc = torch.ones(m, dtype=torch.float32, device=dev)
    unfinished = torch.zeros((), dtype=torch.bool, device=dev)
    for _phase in range(PHASES):
        for _round in range(ROUNDS):
            if not bool((st["walking"] == 1).any()):
                break
            out = run_surface_finder(rays, st, ctx)
            st, saved, hb = advance(state, ctx, rays, d_len, st, saved, hb, out)
        unfinished = unfinished | (st["walking"] == 1).any()
        has_hit = hb["hit_kind"] != TR_HIT_NONE
        if bool(has_hit.any()):
            light_acc, trans_acc = shade_fn(hb, light_acc, trans_acc)
        resume = has_hit & (trans_acc >= 1.0 / 256.0)
        if not bool(resume.any()):
            break
        st = dict(st, walking=resume.to(torch.int32))
        hb = dict(hb, hit_kind=torch.zeros_like(hb["hit_kind"]))
    return light_acc, trans_acc, bool(unfinished)
