"""Ray traversal megakernel (`csrc/trace.cu`), its plain twin, and the
phase loop around them. Counterpart of `aic_tpu/raytrace/pallas_trace.py`.

The kernel replaces the TPU megakernel `aic_tpu/raytrace/pallas_trace.py:
1140 _make_kernel2` (launched by `_run_kernel2`, driven by
`_trace_pallas_impl2`). Per ray it runs the two-level DDA from the entry
cube to the first visible surface: empty 16³ regions are crossed in one
step through the L1 region bitmask; inside an occupied region the ray
steps cube by cube against the region's 4096-bit row; a visible cube is
classified through its region's classify page (narrow u16 pairs, or wide
u32 codes when the scene has R32 blocks); an atom ends the ray, a voxel
block saves the outer registers and walks the block's grid (one row for
R ≤ 16, eight octant rows for R32) until a voxel is hit or the grid is
left, when the saved registers come back. Ties break Z, then Y, then X;
block entry uses a 1e-4/|d| nudge.

On the H100 the kernel is one thread per listed ray, reading `l1`,
`rows`, `page_idx` and `pages` from global memory: they are a few
hundred KB at most (atrium: 45 rows, 512 page rows) and stay in L1/L2.
It keeps the 28-field state contract, so that the twin and the tests
are `aic_tpu`'s, but updates the state in place and touches only what
a ray's path needs (see `csrc/trace.cu`); the TPU kernel's min-domain
group synchronisation (a Mosaic gather workaround) is gone, and a
thread runs its ray to the end in one launch, so the TPU tracer's
relaunch rounds, each behind a device-to-host check, are gone too.

The phase loop (`_phases_v2`) packs the ray constants and the state
once a frame and carries the state in one i32[28, m] buffer; each phase
walks only its listed rays (`walk_phase`): all the rays that meet the
volume, then the few that resume past a transparent hit (demo-city at
1080p: 2.07 M, then 1,075). It equals the all-ray loop
(`phases_all_rays`, `aic_tpu`'s) bit for bit.

`run_megakernel` (all rays, the dict contract) and `walk_phase` (a
list, in place) dispatch on the tensors' device: CPU → the plain
vectorised version, CUDA → the kernel or an exception.
`trace_rays_kernel` takes the megakernel where its tables fit
(`megakernel_fits`) and the v1 surface finder (`trace_kernel_v1.py`)
elsewhere, as `aic_tpu`'s `trace_rays_pallas` does.
"""

from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..space.state import SpaceState
from .tracer import (
    HIT_ATOM,
    HIT_NONE as TR_HIT_NONE,
    HIT_VOXEL,
    _sky_sample,
    make_phase_shader,
    ray_entry_setup,
)

REGION = 16
MAX_REGIONS = 4096  # L1 capacity: one 128-word row of region bits

#: Launches of the CUDA kernel by this process (the plain version does
#: not count).
LAUNCHES = 0

#: Per-ray iteration budget of one launch: `aic_tpu`'s 256 iterations
#: per launch × 128 relaunches, so a ray that `aic_tpu` finishes finishes.
MAX_ITERS = 256 * 128
#: Cube steps per iteration within one domain.
SUBSTEPS = 8
#: Transparency phases: a ray resumes past a hit while its transmittance
#: is at least 1/256.
PHASES = 4

HIT_NONE = 0
HIT_OUTER = 1  # entered a visible outer cube (atom OR voxel block)
HIT_INNER = 2  # entered a visible voxel within a block grid

MODE_DONE = 0
MODE_WALK = 1
MODE_CLASSIFY = 2
MODE_RESTORE = 3

#: Page geometry: WIDE = one u32 code per cube of a region (32 rows of
#: 128 lanes); NARROW = u16 pairs, 16 rows, used when every code fits.
PAGE_ROWS = 32
PAGE_ROWS_NARROW = 16

#: Per-ray state threading through kernel launches (all [m]).
STATE_FIELDS = (
    "dom", "cx", "cy", "cz", "tmx", "tmy", "tmz",
    "tdx", "tdy", "tdz", "resl", "mode", "vbase",
    "hit", "pidx", "face", "t", "nt", "hx", "hy", "hz",
    "sdom", "scx", "scy", "scz", "stmx", "stmy", "stmz",
)
FLOAT_FIELDS = frozenset(
    ("tmx", "tmy", "tmz", "tdx", "tdy", "tdz", "t", "nt", "stmx", "stmy", "stmz")
)
#: Per-ray constants: f32 origin, direction, inverse direction, then i32 step.
RAY_FIELDS = ("ox", "oy", "oz", "dx", "dy", "dz", "ivx", "ivy", "ivz", "stx", "sty", "stz")


@dataclass(frozen=True)
class PackedRays:
    """The 12 per-ray constants as the kernels read them, packed once per
    `trace_rays_kernel` call: f32[9, m] (origin, direction, inverse
    direction) and i32[3, m] (step)."""

    f: torch.Tensor
    i: torch.Tensor

    @staticmethod
    def pack(rays: dict) -> "PackedRays":
        return PackedRays(
            torch.stack([rays[k] for k in RAY_FIELDS[:9]]),
            torch.stack([rays[k] for k in RAY_FIELDS[9:]]),
        )

    def take(self, idx: torch.Tensor) -> "PackedRays":
        """The rays `idx` (i64[n]), packed the same way."""
        return PackedRays(self.f[:, idx], self.i[:, idx])

    def fields(self) -> dict:
        """The 12 constants by name (row views)."""
        return dict(zip(RAY_FIELDS, [*self.f, *self.i]))


def pack_fields(st: dict, fields, float_fields) -> torch.Tensor:
    """Per-ray fields → one i32[len(fields), m] buffer (floats bit-cast)."""
    return torch.stack([st[k].view(torch.int32) if k in float_fields else st[k] for k in fields])


def unpack_fields(buf: torch.Tensor, fields, float_fields) -> dict:
    """The inverse of `pack_fields`: row views by name."""
    return {k: (buf[i].view(torch.float32) if k in float_fields else buf[i]) for i, k in enumerate(fields)}


@dataclass(frozen=True)
class BitmaskCtx2:
    """Megakernel tables; u32 words are held as int32 (see state.py)."""

    rows: torch.Tensor  # i32[n_domains, 128] visibility bits (regions + vrows)
    l1: torch.Tensor  # i32[1, 128] region-occupancy bits
    page_idx: torch.Tensor | None  # i32[n_regions_pad, 8] region → page or -1
    pages: torch.Tensor | None  # i32 classify codes
    rdims: tuple
    size: tuple
    n_regions: int
    n_ventries: int
    has_r32: bool
    wide_pages: bool = False


def _pack_bits_3d(vis: np.ndarray, edge: int) -> np.ndarray:
    """bool[≤edge]³ → u32[128], bit index (x*edge + y)*edge + z."""
    p = np.zeros((edge, edge, edge), bool)
    p[: vis.shape[0], : vis.shape[1], : vis.shape[2]] = vis
    flat = p.reshape(-1)
    words = np.zeros(128, np.uint32)
    idx = np.nonzero(flat)[0]
    np.bitwise_or.at(words, idx >> 5, np.uint32(1) << (idx & 31).astype(np.uint32))
    return words


def build_bitmask_ctx2(state: SpaceState) -> BitmaskCtx2:
    """Occupancy rows + per-region classify pages (host numpy, copied from
    `aic_tpu` `build_bitmask_ctx2`, pallas_trace.py:918-1090).

    A wide page stores one u32 code per cube: bit 31 voxel-block flag,
    bits 28-30 res_log2, bits 14-27 ventry, bits 0-13 the ventry's first
    row in `rows` (R32 entries own 8 rows, one 16³ octant each). A narrow
    page stores u16 codes (0x8000 flag, res_log2 << 12, ventry) in pairs.
    Atoms carry their palette index. Scenes with no voxel blocks have no
    pages."""
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
    if t.padded_voxel_resolution > 2 * REGION:
        raise ValueError(
            f"voxel resolution {t.padded_voxel_resolution} > {2 * REGION} unsupported; "
            "the general tracer (tracer.trace_rays) holds it, and render sends it there"
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
    l1_words = np.zeros(128, np.uint32)
    idx = np.nonzero(l1_bits)[0]
    np.bitwise_or.at(l1_words, idx >> 5, np.uint32(1) << (idx & 31).astype(np.uint32))

    # Ventry rows: R<=16 entries pack R³ bits at native edge in ONE row;
    # R32 entries own 8 rows (one 16³ octant each). A voxel is visible if
    # it has alpha or emission.
    vr = t.vox_rows.cpu().numpy()
    vis_v = (vr[..., 3] > 0.0) | (vr[..., 4:7] != 0.0).any(-1)
    n_ventries = vis_v.shape[0]
    voxel_index = t.voxel_index.cpu().numpy()
    res_log2 = t.res_log2.cpu().numpy()
    ventry_res = np.zeros(n_ventries, np.int32)
    live = voxel_index >= 0
    ventry_res[voxel_index[live]] = 1 << res_log2[live]
    vrow_base = np.zeros(n_ventries, np.int32)
    vrow_list = []
    has_r32 = False
    for v in range(n_ventries):
        r = int(ventry_res[v]) or 1
        vrow_base[v] = len(vrow_list)
        if r <= REGION:
            vrow_list.append(_pack_bits_3d(vis_v[v][:r, :r, :r], r))
        else:
            has_r32 = True
            for ox in range(2):
                for oy in range(2):
                    for oz in range(2):
                        sub = vis_v[v][
                            ox * 16 : ox * 16 + 16,
                            oy * 16 : oy * 16 + 16,
                            oz * 16 : oz * 16 + 16,
                        ]
                        vrow_list.append(_pack_bits_3d(sub, REGION))
    if len(vrow_list) >= 1 << 14 or n_ventries >= 1 << 14:
        raise ValueError(
            f"{len(vrow_list)} ventry rows / {n_ventries} entries exceed "
            "the 14-bit classify-code fields"
        )
    vrows = np.stack(vrow_list, axis=0) if vrow_list else np.zeros((0, 128), np.uint32)
    all_rows = np.concatenate([rows, vrows], axis=0)

    dev = state.device

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a).view(np.int32), device=dev)

    ventry_cube = voxel_index[contents]  # -1 for atoms/air
    vox_cube = visible & (ventry_cube >= 0)
    if not vox_cube.any():
        return BitmaskCtx2(
            rows=i32(all_rows), l1=i32(l1_words[None, :]),
            page_idx=None, pages=None, rdims=rd, size=(sx, sy, sz),
            n_regions=n_regions, n_ventries=n_ventries, has_r32=False,
        )
    wide = has_r32 or n_ventries >= (1 << 12) or int(contents.max(initial=0)) >= 0x8000
    res_cube = res_log2[contents].astype(np.int64)
    vent_safe = np.maximum(ventry_cube, 0)
    if wide:
        code = np.where(
            vox_cube,
            (1 << 31)
            | (res_cube << 28)
            | (vent_safe.astype(np.int64) << 14)
            | vrow_base[vent_safe].astype(np.int64),
            contents,
        ).astype(np.uint32)
        page_rows = PAGE_ROWS
    else:
        # In a no-R32 scene each ventry owns exactly one row, so the u16
        # code's 12-bit field serves as both ventry and row base.
        if not (vrow_base[:n_ventries] == np.arange(n_ventries)).all():
            raise AssertionError("narrow pages need one row per voxel entry")
        code = np.where(
            vox_cube,
            0x8000 | (res_cube << 12) | vent_safe.astype(np.int64),
            contents,
        ).astype(np.uint32)
        page_rows = PAGE_ROWS_NARROW

    page_idx = np.full(n_regions, -1, np.int32)
    page_list = []
    for rx in range(rd[0]):
        for ry in range(rd[1]):
            for rz in range(rd[2]):
                rid = (rx * rd[1] + ry) * rd[2] + rz
                sl = np.s_[
                    rx * REGION : (rx + 1) * REGION,
                    ry * REGION : (ry + 1) * REGION,
                    rz * REGION : (rz + 1) * REGION,
                ]
                if not visible[sl].any():
                    continue  # never hit -> no page
                codes = np.zeros((REGION, REGION, REGION), np.uint32)
                s = code[sl]
                codes[: s.shape[0], : s.shape[1], : s.shape[2]] = s
                flat = codes.reshape(-1)
                if not wide:
                    flat = flat[0::2] | (flat[1::2] << 16)
                page_idx[rid] = len(page_list)
                page_list.append(flat.reshape(page_rows, 128).astype(np.uint32))
    # Page count padded to a multiple of 8 (aic_tpu keeps shapes stable
    # across small occupancy changes; kept so tables compare field for field).
    while len(page_list) % 8:
        page_list.append(np.zeros((page_rows, 128), np.uint32))
    pages = np.concatenate(page_list, axis=0)
    npad = -(-n_regions // 8) * 8
    pidx = np.zeros((npad, 8), np.int32)
    pidx[:n_regions, 0] = page_idx
    return BitmaskCtx2(
        rows=i32(all_rows), l1=i32(l1_words[None, :]),
        page_idx=i32(pidx), pages=i32(pages),
        rdims=rd, size=(sx, sy, sz),
        n_regions=n_regions, n_ventries=n_ventries, has_r32=has_r32,
        wide_pages=wide,
    )


#: id(state.contents) → (weakref to it, ctx): one build per snapshot.
_CTX2_CACHE: dict = {}


def get_bitmask_ctx2(state: SpaceState) -> BitmaskCtx2:
    key = id(state.contents)
    hit = _CTX2_CACHE.get(key)
    if hit is not None and hit[0]() is state.contents:
        return hit[1]
    ctx = build_bitmask_ctx2(state)
    if len(_CTX2_CACHE) >= 8:
        _CTX2_CACHE.pop(next(iter(_CTX2_CACHE)))
    _CTX2_CACHE[key] = (weakref.ref(state.contents), ctx)
    return ctx


def region_count(state: SpaceState) -> int:
    """The state's count of 16³ regions, each one row of the kernels'
    tables."""
    return int(np.prod([-(-s // REGION) for s in state.contents.shape]))


def megakernel_fits(state: SpaceState) -> bool:
    """`aic_tpu` `_megakernel_fits` (pallas_trace.py:1107-1117), kept so
    that both packages send the same states to each kernel: palette ids
    must fit the 15-bit classify code and the tables 10 MiB (a VMEM limit
    on the TPU; the card's kernel reads them from global memory). Where
    `aic_tpu`'s raises (more than `MAX_REGIONS` regions, voxel resolution
    above 32, voxel rows past the 14-bit code fields) this says False
    before building anything. States outside it go to the v1 kernel where
    `trace_kernel_v1.v1_fits`, else to the general tracer."""
    t = state.tables
    if t.visible.shape[0] > 0x8000:
        return False
    if region_count(state) > MAX_REGIONS or t.padded_voxel_resolution > 2 * REGION:
        return False
    n_ventries = t.vox_rows.shape[0]
    n_r32 = int((t.resolution[t.voxel_index >= 0] > REGION).sum())
    if n_ventries >= 1 << 14 or n_ventries + 7 * n_r32 >= 1 << 14:
        return False
    ctx2 = get_bitmask_ctx2(state)
    table_bytes = ctx2.rows.numel() * 4 + 512
    if ctx2.pages is not None:
        table_bytes += ctx2.page_idx.numel() * 4 + ctx2.pages.numel() * 4
    return table_bytes <= 10 << 20


def _argmin3(tx, ty, tz):
    """DDA axis choice, reference tie-break: prefer Z, then Y, then X on
    equal t (raycast.rs:584)."""
    return torch.where(
        tx < ty, torch.where(tx < tz, 0, 2), torch.where(ty < tz, 1, 2)
    ).to(torch.int32)


def _w(cond, a, b):
    """torch.where that accepts Python scalars on either side."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.where(cond, a, b)


def megakernel_plain(rays: dict, st: dict, ctx: BitmaskCtx2, work: dict | None = None) -> dict:
    """Plain PyTorch megakernel: the kernel's per-ray logic as a masked
    loop over all rays. Runs up to `MAX_ITERS` iterations; each iteration
    does, per walking ray, either one macro step across an empty region
    or up to `SUBSTEPS` cube steps within its current domain, then pops
    rays leaving a voxel grid and classifies rays that hit an outer cube.
    Returns the 28 state fields. `work`, a dict, gets the work the
    kernel does on these inputs, by branch: "rays"; "iters" and
    "outer_iters" (iterations of rays not done, and of those walking an
    outer domain); "macro_steps"; "steps" and "outer_steps" (cube-step
    attempts, and those in an outer domain); "tests" (attempts that test
    a bit: neither a region change nor a step out of the volume or grid);
    "hits"; "restores"; "classify" (outer hits classified through a
    page) and "pushes" (those that enter a voxel grid); and rays, each
    counted once: "walking" (not done at launch), "macro_rays" (those
    that take a macro step or push: they read their origin and
    direction), "hit_rays" (those that end on a hit) and "grid_rays"
    (those inside a voxel grid at launch or entering one)."""
    s = {k: v.clone() for k, v in st.items()}
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
    has_vox = ctx.pages is not None
    inf = torch.full_like(ox, float("inf"))
    nud = 1e-4 / torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-30))

    def region_id(cx, cy, cz):
        return ((cx >> 4) * rdy + (cy >> 4)) * rdz + (cz >> 4)

    def outside(cx, cy, cz, ex, ey, ez):
        return (cx < 0) | (cx >= ex) | (cy < 0) | (cy >= ey) | (cz < 0) | (cz >= ez)

    def octant(ax_, ay_, az_):
        ax_, ay_, az_ = ax_.clamp(0, 31), ay_.clamp(0, 31), az_.clamp(0, 31)
        return ((ax_ >> 4) & 1) * 4 + ((ay_ >> 4) & 1) * 2 + ((az_ >> 4) & 1)

    def count(key, mask):
        if work is not None:
            work[key] = work.get(key, 0) + int(mask.sum())

    if work is not None:
        work["rays"] = work.get("rays", 0) + ox.shape[0]
    count("walking", s["mode"] != MODE_DONE)
    # Per ray: took a macro step or pushed; ended on a hit; in a grid.
    read_ray = torch.zeros_like(ox, dtype=torch.bool)
    ended_hit = torch.zeros_like(read_ray)
    in_grid = (s["mode"] != MODE_DONE) & (s["dom"] >= n_regions)
    for _ in range(MAX_ITERS):
        if not bool((s["mode"] != MODE_DONE).any()):
            break
        # ---- macro step across an empty region --------------------------
        dom, cx, cy, cz = s["dom"], s["cx"], s["cy"], s["cz"]
        walking = s["mode"] == MODE_WALK
        inner = dom >= n_regions
        count("iters", s["mode"] != MODE_DONE)
        count("outer_iters", walking & ~inner)
        dom_c = dom.clamp(0, MAX_REGIONS - 1)
        l1bit = (l1[(dom_c >> 5).long()] >> (dom_c & 31)) & 1
        inb = ~outside(cx, cy, cz, sx, sy, sz)
        in_empty = walking & ~inner & (l1bit == 0) & inb
        count("macro_steps", in_empty)
        read_ray |= in_empty
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
        s["tmx"] = _w(adv, _w(stx == 0, inf, ((cx + spx).float() - ox) * ivx), s["tmx"])
        s["tmy"] = _w(adv, _w(sty == 0, inf, ((cy + spy).float() - oy) * ivy), s["tmy"])
        s["tmz"] = _w(adv, _w(stz == 0, inf, ((cz + spz).float() - oz) * ivz), s["tmz"])
        s["dom"] = _w(adv, region_id(cx, cy, cz), dom)
        s["cx"], s["cy"], s["cz"] = cx, cy, cz
        s["mode"] = _w(in_empty & exits, MODE_DONE, s["mode"])

        # ---- cube steps within the current domain ------------------------
        dom_start = s["dom"]
        for _k in range(SUBSTEPS):
            dom, cx, cy, cz = s["dom"], s["cx"], s["cy"], s["cz"]
            tmx, tmy, tmz = s["tmx"], s["tmy"], s["tmz"]
            mode, resl = s["mode"], s["resl"]
            inner = dom >= n_regions
            act = (mode == MODE_WALK) & (dom == dom_start) & ~in_empty
            if not bool(act.any()):
                break
            redge = _w(inner, 1 << resl, REGION)
            ax = _argmin3(tmx, tmy, tmz)
            t_hit = torch.minimum(tmx, torch.minimum(tmy, tmz))
            stax = _w(ax == 0, stx, _w(ax == 1, sty, stz))
            f = _w(stax > 0, ax, ax + 3)
            ncx = cx + _w(ax == 0, stx, 0)
            ncy = cy + _w(ax == 1, sty, 0)
            ncz = cz + _w(ax == 2, stz, 0)
            utx = tmx + _w(ax == 0, s["tdx"], 0.0)
            uty = tmy + _w(ax == 1, s["tdy"], 0.0)
            utz = tmz + _w(ax == 2, s["tdz"], 0.0)
            out_exit = ~inner & outside(ncx, ncy, ncz, sx, sy, sz)
            region_change = ~inner & ~out_exit & (region_id(ncx, ncy, ncz) != dom)
            in_exit = inner & outside(ncx, ncy, ncz, redge, redge, redge)
            new_dom = region_id(ncx, ncy, ncz)
            if ctx.has_r32:
                # R32 grids: crossing an octant boundary hops the domain
                # to the neighbour row, like a region change.
                dom_inner = n_regions + s["vbase"] + octant(ncx, ncy, ncz)
                oct_change = inner & (resl == 5) & ~in_exit & (dom_inner != dom)
                region_change = region_change | oct_change
                new_dom = _w(oct_change, dom_inner, new_dom)
            lx, ly, lz = (ncx & 15).clamp(0, 15), (ncy & 15).clamp(0, 15), (ncz & 15).clamp(0, 15)
            edge_l2 = _w(inner, torch.clamp(resl, max=4), 4)
            local = (((lx << edge_l2) + ly) << edge_l2) + lz
            widx = (local >> 5).clamp(0, 127)
            word = ctx.rows[dom.clamp(0, n_domains - 1).long(), widx.long()]
            bit = (word >> (local & 31)) & 1
            hit_now = act & ~out_exit & ~in_exit & ~region_change & (bit == 1)
            commit = act & ~region_change
            count("steps", act)
            count("outer_steps", act & ~inner)
            count("tests", commit & ~out_exit & ~in_exit)
            count("hits", hit_now)
            ended_hit |= hit_now & inner
            s["dom"] = _w(act & region_change, new_dom, dom)
            s["cx"], s["cy"], s["cz"] = _w(commit, ncx, cx), _w(commit, ncy, cy), _w(commit, ncz, cz)
            s["tmx"], s["tmy"], s["tmz"] = _w(commit, utx, tmx), _w(commit, uty, tmy), _w(commit, utz, tmz)
            nt = torch.minimum(utx, torch.minimum(uty, utz))
            outer_hit = hit_now & ~inner
            inner_hit = hit_now & inner
            s["hit"] = _w(inner_hit, HIT_INNER, s["hit"])
            s["face"] = _w(hit_now, f, s["face"])
            s["t"] = _w(hit_now, t_hit, s["t"])
            s["nt"] = _w(hit_now, nt, s["nt"])
            s["hx"], s["hy"], s["hz"] = _w(hit_now, ncx, s["hx"]), _w(hit_now, ncy, s["hy"]), _w(hit_now, ncz, s["hz"])
            s["mode"] = _w(
                outer_hit,
                MODE_CLASSIFY,
                _w(inner_hit | (act & out_exit), MODE_DONE, _w(act & in_exit, MODE_RESTORE, mode)),
            )

        # ---- restore: pop the outer DDA registers -------------------------
        restoring = s["mode"] == MODE_RESTORE
        count("restores", restoring)
        for k, sk in (("dom", "sdom"), ("cx", "scx"), ("cy", "scy"), ("cz", "scz"),
                      ("tmx", "stmx"), ("tmy", "stmy"), ("tmz", "stmz")):
            s[k] = _w(restoring, s[sk], s[k])
        s["tdx"] = _w(restoring, ivx.abs(), s["tdx"])
        s["tdy"] = _w(restoring, ivy.abs(), s["tdy"])
        s["tdz"] = _w(restoring, ivz.abs(), s["tdz"])
        s["resl"] = _w(restoring, 0, s["resl"])
        s["mode"] = _w(restoring, MODE_WALK, s["mode"])

        # ---- classification: atom -> final, voxel block -> push -----------
        pend = s["mode"] == MODE_CLASSIFY
        if not bool(pend.any()):
            continue
        if not has_vox:
            s["hit"] = _w(pend, HIT_OUTER, s["hit"])
            s["mode"] = _w(pend, MODE_DONE, s["mode"])
            ended_hit |= pend
            continue
        local = ((((s["hx"] & 15) << 4) + (s["hy"] & 15)) << 4) + (s["hz"] & 15)
        page = ctx.page_idx[s["dom"].clamp(0, n_regions - 1).long(), 0]
        if ctx.wide_pages:
            lane, rsel, n_prows = local & 127, local >> 7, PAGE_ROWS
        else:
            lane, rsel, n_prows = (local >> 1) & 127, local >> 8, PAGE_ROWS_NARROW
        val = ctx.pages[(torch.clamp(page, min=0) * n_prows + rsel).long(), lane.long()]
        if ctx.wide_pages:
            is_vox = pend & (val < 0) & (page >= 0)  # bit 31 set
            vent = (val >> 14) & 0x3FFF
            vrow = val & 0x3FFF
            rl = (val >> 28) & 7
            atom_pidx = val & 0xFFFF
        else:
            u16v = (val >> (16 * (local & 1))) & 0xFFFF
            is_vox = pend & (u16v >= 0x8000) & (page >= 0)
            vent = u16v & 0xFFF
            vrow = vent  # one row per entry in no-R32 scenes
            rl = (u16v >> 12) & 7
            atom_pidx = u16v & 0x7FFF
        count("classify", pend)
        count("pushes", is_vox)
        atom = pend & ~is_vox
        read_ray |= is_vox
        in_grid |= is_vox
        ended_hit |= atom
        s["hit"] = _w(atom, HIT_OUTER, s["hit"])
        s["pidx"] = _w(atom, atom_pidx, s["pidx"])
        s["mode"] = _w(atom, MODE_DONE, s["mode"])

        # Push: save the outer registers, enter the voxel grid one virtual
        # voxel early along the entry face axis.
        for k, sk in (("dom", "sdom"), ("cx", "scx"), ("cy", "scy"), ("cz", "scz"),
                      ("tmx", "stmx"), ("tmy", "stmy"), ("tmz", "stmz")):
            s[sk] = _w(is_vox, s[k], s[sk])
        t = s["t"]
        axis = s["face"] % 3
        ohx, ohy, ohz = (axis == 0).int(), (axis == 1).int(), (axis == 2).int()
        blk_res = 1 << rl
        rf = blk_res.float()
        iox = (ox - s["hx"].float()) * rf
        ioy = (oy - s["hy"].float()) * rf
        ioz = (oz - s["hz"].float()) * rf
        epx = iox + dx * rf * t + dx * nud
        epy = ioy + dy * rf * t + dy * nud
        epz = ioz + dz * rf * t + dz * nud
        icx = torch.minimum(torch.clamp(torch.floor(epx).int(), min=0), blk_res - 1)
        icy = torch.minimum(torch.clamp(torch.floor(epy).int(), min=0), blk_res - 1)
        icz = torch.minimum(torch.clamp(torch.floor(epz).int(), min=0), blk_res - 1)
        itmx = _w(stx == 0, inf, ((icx + spx).float() - iox) * ivx / rf)
        itmy = _w(sty == 0, inf, ((icy + spy).float() - ioy) * ivy / rf)
        itmz = _w(stz == 0, inf, ((icz + spz).float() - ioz) * ivz / rf)
        ecx, ecy, ecz = icx - ohx * stx, icy - ohy * sty, icz - ohz * stz
        s["cx"], s["cy"], s["cz"] = _w(is_vox, ecx, s["cx"]), _w(is_vox, ecy, s["cy"]), _w(is_vox, ecz, s["cz"])
        s["tmx"] = _w(is_vox, _w(ohx == 1, t, itmx), s["tmx"])
        s["tmy"] = _w(is_vox, _w(ohy == 1, t, itmy), s["tmy"])
        s["tmz"] = _w(is_vox, _w(ohz == 1, t, itmz), s["tmz"])
        s["tdx"] = _w(is_vox, ivx.abs() / rf, s["tdx"])
        s["tdy"] = _w(is_vox, ivy.abs() / rf, s["tdy"])
        s["tdz"] = _w(is_vox, ivz.abs() / rf, s["tdz"])
        vdom = n_regions + vrow
        if ctx.has_r32:
            # R32 entries start in the octant of the (clipped) entry cube.
            vdom = vdom + _w(rl == 5, octant(ecx, ecy, ecz), 0)
        s["dom"] = _w(is_vox, vdom, s["dom"])
        s["vbase"] = _w(is_vox, vrow, s["vbase"])
        s["pidx"] = _w(is_vox, vent, s["pidx"])
        s["resl"] = _w(is_vox, rl, s["resl"])
        s["mode"] = _w(is_vox, MODE_WALK, s["mode"])
    count("macro_rays", read_ray)
    count("hit_rays", ended_hit)
    count("grid_rays", in_grid)
    return s


def _fn():
    lib = kernels.load_library("trace")
    fn = lib.aic_trace_megakernel
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch_megakernel(rays: PackedRays, state: torch.Tensor, ctx: BitmaskCtx2,
                      idx: torch.Tensor | None = None) -> None:
    """Launch `csrc/trace.cu` over the rays `idx` (i64[n]) of the packed
    state `state` (i32[28, m], `pack_fields(st, STATE_FIELDS,
    FLOAT_FIELDS)`), or over all m rays without a list, in place: each
    listed ray whose mode is WALK walks to its end or its budget; columns
    off the list are neither read nor written. An empty list launches
    nothing."""
    global LAUNCHES
    dev = ctx.rows.device
    m = rays.f.shape[1]
    n = m if idx is None else idx.shape[0]
    req = kernels.require
    req(rays.f, "rays", torch.float32, (9, m), dev)
    req(rays.i, "ray steps", torch.int32, (3, m), dev)
    req(state, "state", torch.int32, (len(STATE_FIELDS), m), dev)
    req(ctx.l1, "l1", torch.int32, (1, 128), dev)
    req(ctx.rows, "rows", torch.int32, (ctx.rows.shape[0], 128), dev)
    if idx is not None:
        req(idx, "ray list", torch.int64, (n,), dev)
    has_vox = ctx.pages is not None
    if has_vox:
        req(ctx.page_idx, "page_idx", torch.int32, (ctx.page_idx.shape[0], 8), dev)
        req(ctx.pages, "pages", torch.int32, (ctx.pages.shape[0], 128), dev)
    if n == 0:
        return
    ptr = kernels.ptr
    null = ctypes.c_void_p(0)
    err = _fn()(
        ptr(rays.f), ptr(rays.i), ptr(state), null if idx is None else ptr(idx), n, m,
        ptr(ctx.l1), ptr(ctx.rows),
        ptr(ctx.page_idx) if has_vox else null, ptr(ctx.pages) if has_vox else null,
        MAX_ITERS, SUBSTEPS, ctx.n_regions, ctx.rows.shape[0],
        ctx.size[0], ctx.size[1], ctx.size[2], ctx.rdims[1], ctx.rdims[2],
        int(has_vox), int(ctx.has_r32), int(ctx.wide_pages),
        kernels.stream_ptr(dev),
    )
    LAUNCHES += 1
    kernels.check_launch(err, "trace megakernel")


def megakernel_cuda(rays: dict, st: dict, ctx: BitmaskCtx2) -> dict:
    """Pack, then launch `csrc/trace.cu` once with every ray listed, on
    the packed copy; same contract as `megakernel_plain`. Writes none of
    its inputs."""
    buf = pack_fields(st, STATE_FIELDS, FLOAT_FIELDS)
    launch_megakernel(PackedRays.pack(rays), buf, ctx)
    return unpack_fields(buf, STATE_FIELDS, FLOAT_FIELDS)


def run_megakernel(rays: dict, st: dict, ctx: BitmaskCtx2) -> dict:
    """One megakernel launch over all rays: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    dev = ctx.rows.device
    if dev.type == "cuda":
        return megakernel_cuda(rays, st, ctx)
    if dev.type == "cpu":
        return megakernel_plain(rays, st, ctx)
    raise ValueError(f"no megakernel for device {dev}")


def walk_phase(rays: PackedRays, buf: torch.Tensor, ctx: BitmaskCtx2, idx: torch.Tensor) -> None:
    """One phase's walk of the listed rays `idx` (i64[n]) of the packed
    state `buf` (i32[28, m]), in place: the kernel reads and writes them
    through the list on CUDA; on the CPU the plain version runs on the
    gathered columns and they are scattered back. Columns off the list
    keep theirs, as an all-ray launch leaves a done ray."""
    dev = ctx.rows.device
    if dev.type == "cuda":
        launch_megakernel(rays, buf, ctx, idx)
    elif dev.type == "cpu":
        st = unpack_fields(buf[:, idx], STATE_FIELDS, FLOAT_FIELDS)
        out = megakernel_plain(rays.take(idx).fields(), st, ctx)
        buf[:, idx] = pack_fields(out, STATE_FIELDS, FLOAT_FIELDS)
    else:
        raise ValueError(f"no megakernel for device {dev}")


def initial_state(state: SpaceState, o: torch.Tensor, d: torch.Tensor, ctx: BitmaskCtx2):
    """Ray constants and the 28-field launch state for space-local rays
    (`_trace_pallas_impl2`'s set-up, pallas_trace.py:1643-1672)."""
    entry = ray_entry_setup(o, d, ctx.size)
    inv_d, step = entry["inv_d"], entry["step"]
    m = o.shape[0]
    size_i = torch.as_tensor(ctx.size, dtype=torch.int32, device=o.device)
    cube0 = entry["cube0"]
    cc = torch.minimum(torch.clamp(cube0, min=0), size_i - 1)
    rdy, rdz = ctx.rdims[1], ctx.rdims[2]
    dom0 = ((cc[:, 0] >> 4) * rdy + (cc[:, 1] >> 4)) * rdz + (cc[:, 2] >> 4)
    rays = dict(
        ox=o[:, 0], oy=o[:, 1], oz=o[:, 2],
        dx=d[:, 0], dy=d[:, 1], dz=d[:, 2],
        ivx=inv_d[:, 0], ivy=inv_d[:, 1], ivz=inv_d[:, 2],
        stx=step[:, 0], sty=step[:, 1], stz=step[:, 2],
    )
    rays = {k: v.contiguous() for k, v in rays.items()}
    tmax0 = entry["tmax0"]
    zi = torch.zeros(m, dtype=torch.int32, device=o.device)
    zf = torch.zeros(m, dtype=torch.float32, device=o.device)
    st = dict(
        dom=dom0, cx=cube0[:, 0], cy=cube0[:, 1], cz=cube0[:, 2],
        tmx=tmax0[:, 0], tmy=tmax0[:, 1], tmz=tmax0[:, 2],
        tdx=inv_d[:, 0].abs(), tdy=inv_d[:, 1].abs(), tdz=inv_d[:, 2].abs(),
        resl=zi, mode=entry["hits_box"].to(torch.int32), vbase=zi,
        hit=zi, pidx=zi, face=zi, t=zf, nt=zf, hx=zi, hy=zi, hz=zi,
        sdom=zi, scx=zi, scy=zi, scz=zi, stmx=zf, stmy=zf, stmz=zf,
    )
    st = {k: v.contiguous() for k, v in st.items()}
    return rays, st, entry


MODE_ROW, HIT_ROW = STATE_FIELDS.index("mode"), STATE_FIELDS.index("hit")


def _hit_buffers(st: dict, ctx: BitmaskCtx2, state: SpaceState) -> dict:
    """The shader's hit buffers from a phase's state (`_trace_pallas_impl2`'s
    glue): the hit kind, the atom's palette id (in page-less scenes read
    from the contents), the voxel's flat index, face, t, next t and the
    hit cube (a voxel's block cube)."""
    max_r = state.tables.padded_voxel_resolution
    sx, sy, sz = ctx.size
    atomh = st["hit"] == HIT_OUTER
    innerh = st["hit"] == HIT_INNER
    if ctx.pages is not None:
        payload = st["pidx"]
    else:
        # Page-less scenes: the atom's palette id is its contents entry
        # (what `aic_tpu` reads from the brick cells).
        hx = st["hx"].clamp(0, sx - 1)
        hy = st["hy"].clamp(0, sy - 1)
        hz = st["hz"].clamp(0, sz - 1)
        payload = state.contents.reshape(-1)[((hx * sy + hy) * sz + hz).long()] & 0xFFFF
    vflat = st["pidx"] * max_r**3 + (st["hx"] * max_r + st["hy"]) * max_r + st["hz"]
    block_cube = torch.stack([st["scx"], st["scy"], st["scz"]], -1)
    hit_cube = torch.stack([st["hx"], st["hy"], st["hz"]], -1)
    zero = torch.zeros_like(payload)
    return dict(
        hit_kind=torch.where(atomh, HIT_ATOM, torch.where(innerh, HIT_VOXEL, TR_HIT_NONE)),
        hit_idx=_w(atomh, payload, zero),
        hit_vflat=_w(innerh, vflat, zero),
        hit_face=st["face"],
        hit_t=st["t"],
        hit_next_t=st["nt"],
        hit_cube=torch.where(innerh[:, None], block_cube, hit_cube),
    )


def _phases_v2(ctx: BitmaskCtx2, rays: dict, st: dict, shade_fn, state: SpaceState):
    """The megakernel phase loop: each of up to `PHASES` phases walks its
    rays to their next surface, then shades the phase's hits; a ray
    resumes in the next phase while its transmittance is at least 1/256.
    The ray constants are packed once and the 28 state fields carried in
    one packed i32[28, m] buffer, which the shader reads as row views.
    Each phase lists the rays that walk in it -- in the first those that
    meet the volume, later the resuming ones -- and walks only them, in
    place (`walk_phase`); a phase with an empty list launches nothing.
    Returns (light, transmittance, unfinished), the sky not yet added.
    Equals `phases_all_rays` bit for bit."""
    dev = ctx.rows.device
    m = rays["ox"].shape[0]
    packed = PackedRays.pack(rays)
    buf = pack_fields(st, STATE_FIELDS, FLOAT_FIELDS)
    s = unpack_fields(buf, STATE_FIELDS, FLOAT_FIELDS)
    light_acc = torch.zeros((m, 3), dtype=torch.float32, device=dev)
    trans_acc = torch.ones(m, dtype=torch.float32, device=dev)
    unfinished = torch.zeros((), dtype=torch.bool, device=dev)
    idx = torch.nonzero(buf[MODE_ROW] == MODE_WALK).squeeze(1)
    if idx.numel() == 0:
        return light_acc, trans_acc, False
    for _phase in range(PHASES):
        walk_phase(packed, buf, ctx, idx)
        unfinished = unfinished | (s["mode"] != MODE_DONE).any()
        has_hit = s["hit"] != HIT_NONE
        if bool(has_hit.any()):
            light_acc, trans_acc = shade_fn(_hit_buffers(s, ctx, state), light_acc, trans_acc)
        resume = has_hit & (trans_acc >= 1.0 / 256.0)
        if not bool(resume.any()):
            break
        idx = torch.nonzero(resume).squeeze(1)
        buf[MODE_ROW] = resume.to(torch.int32)
        buf[HIT_ROW] = 0
    return light_acc, trans_acc, bool(unfinished)


def phases_all_rays(ctx: BitmaskCtx2, rays: dict, st: dict, shade_fn, state: SpaceState):
    """The same phase loop with every phase one launch over all rays on
    per-field state, repacked each phase (`run_megakernel`), as `aic_tpu`
    runs it: the reference that `_phases_v2` equals bit for bit."""
    dev = ctx.rows.device
    m = rays["ox"].shape[0]
    light_acc = torch.zeros((m, 3), dtype=torch.float32, device=dev)
    trans_acc = torch.ones(m, dtype=torch.float32, device=dev)
    unfinished = torch.zeros((), dtype=torch.bool, device=dev)
    for _phase in range(PHASES):
        st = run_megakernel(rays, st, ctx)
        unfinished = unfinished | (st["mode"] != MODE_DONE).any()
        has_hit = st["hit"] != HIT_NONE
        if bool(has_hit.any()):
            light_acc, trans_acc = shade_fn(_hit_buffers(st, ctx, state), light_acc, trans_acc)
        resume = has_hit & (trans_acc >= 1.0 / 256.0)
        if not bool(resume.any()):
            break
        st = dict(st, mode=resume.to(torch.int32), hit=torch.zeros_like(st["hit"]))
    return light_acc, trans_acc, bool(unfinished)


def trace_rays_kernel(
    state: SpaceState,
    origins: torch.Tensor,
    directions: torch.Tensor,
    options,
    megakernel: bool | None = None,
    include_sky: bool = True,
):
    """Trace rays (`aic_tpu` `trace_rays_pallas`). Returns (light
    f32[...,3] premultiplied HDR, transmittance f32[...], unfinished
    bool): with `include_sky` the sky is added and the transmittance is
    all 0; `unfinished` is the Flaws::UNFINISHED analog, set when a ray
    used up its budget.

    `megakernel` picks the kernel as `trace_rays_pallas` does: None takes
    the megakernel where `megakernel_fits` says its tables fit and the v1
    surface finder elsewhere; False forces v1, True the megakernel. A
    state that neither holds raises ValueError."""
    from .trace_kernel_v1 import get_bitmask_ctx, trace_phases_v1

    if megakernel is None:
        megakernel = megakernel_fits(state)
    ctx = get_bitmask_ctx2(state) if megakernel else get_bitmask_ctx(state)
    batch_shape = origins.shape[:-1]
    dev = state.device
    lower = torch.as_tensor(state.lower, dtype=torch.float32, device=dev)
    o = (origins.reshape(-1, 3).to(torch.float32) - lower).contiguous()
    d = directions.reshape(-1, 3).to(torch.float32).contiguous()

    rays, st, entry = initial_state(state, o, d, ctx)
    d_len = entry["d_len"]
    t_to_view = d_len / float(options.view_distance)
    sky_rgb = _sky_sample(state, d)
    shade_fn = make_phase_shader(state, options, o, d, d_len, t_to_view, sky_rgb)
    if megakernel:
        light_acc, trans_acc, unfinished = _phases_v2(ctx, rays, st, shade_fn, state)
    else:
        light_acc, trans_acc, unfinished = trace_phases_v1(state, ctx, rays, st, d_len, shade_fn)

    if include_sky:
        light_acc = light_acc + sky_rgb * trans_acc[..., None]
        trans_acc = torch.zeros_like(trans_acc)
    return light_acc.reshape(batch_shape + (3,)), trans_acc.reshape(batch_shape), unfinished
