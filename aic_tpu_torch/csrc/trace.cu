// Ray traversal megakernel: one thread per ray.
//
// Replaces the TPU kernel aic_tpu/raytrace/pallas_trace.py:1140
// `_make_kernel2`; the plain PyTorch twin is `megakernel_plain` in
// aic_tpu_torch/raytrace/trace_kernel.py, and both keep the TPU kernel's
// 28-field per-ray state contract (STATE_FIELDS there, `Field` here).
//
// Per ray: the two-level DDA from its current cube to the next visible
// surface. An empty 16^3 region (L1 bit clear) is crossed in one macro
// step; in an occupied region the ray steps cube by cube against the
// region's 4096-bit row; a hit on an outer cube is classified through the
// region's classify page (atom -> final hit; voxel block -> save the outer
// registers and walk the block's grid, one row for R <= 16 or eight octant
// rows for R32); leaving a grid pops the saved registers.
//
// Bound on the H100: a serial chain of dependent loads per ray (row word,
// then page word) plus warp divergence between rays that take different
// paths. The tables are a few hundred KB and stay in L1/L2; every thread
// reads its own words (the TPU kernel's min-domain group synchronisation
// was a Mosaic gather workaround and is gone). All DDA state lives in
// registers for the whole launch.
//
// State arrays are [28, m] int32 (float fields bit-cast); rays are
// f32 [9, m] (origin, direction, inverse direction) and i32 [3, m] (step).
// Built with -fmad=false so float results match PyTorch's separately
// rounded ops. Returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Field {
  DOM, CX, CY, CZ, TMX, TMY, TMZ, TDX, TDY, TDZ, RESL, MODE, VBASE,
  HIT, PIDX, FACE, T, NT, HX, HY, HZ,
  SDOM, SCX, SCY, SCZ, STMX, STMY, STMZ, N_FIELDS
};

constexpr int MODE_DONE = 0, MODE_WALK = 1, MODE_CLASSIFY = 2, MODE_RESTORE = 3;
constexpr int HIT_OUTER = 1, HIT_INNER = 2;
constexpr int REGION = 16, MAX_REGIONS = 4096;
constexpr int PAGE_ROWS = 32, PAGE_ROWS_NARROW = 16;

struct Tables {
  const uint32_t* l1;        // [128] region-occupancy bits
  const uint32_t* rows;      // [n_domains, 128] visibility bits
  const int32_t* page_idx;   // [n_regions_pad, 8] region -> page or -1
  const uint32_t* pages;     // classify codes
  int n_regions, n_domains, sx, sy, sz, rdy, rdz, has_vox, has_r32, wide;
};

__device__ __forceinline__ int argmin3(float tx, float ty, float tz) {
  return tx < ty ? (tx < tz ? 0 : 2) : (ty < tz ? 1 : 2);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int octant(int x, int y, int z) {
  x = clampi(x, 0, 31);
  y = clampi(y, 0, 31);
  z = clampi(z, 0, 31);
  return ((x >> 4) & 1) * 4 + ((y >> 4) & 1) * 2 + ((z >> 4) & 1);
}

__global__ void trace_megakernel(const float* __restrict__ rays,
                                 const int32_t* __restrict__ steps,
                                 const int32_t* __restrict__ st_in,
                                 int32_t* __restrict__ st_out, Tables tb,
                                 int m, int max_iters, int substeps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float ox = rays[0 * m + i], oy = rays[1 * m + i], oz = rays[2 * m + i];
  const float dx = rays[3 * m + i], dy = rays[4 * m + i], dz = rays[5 * m + i];
  const float ivx = rays[6 * m + i], ivy = rays[7 * m + i], ivz = rays[8 * m + i];
  const int stx = steps[0 * m + i], sty = steps[1 * m + i], stz = steps[2 * m + i];
  const int spx = stx > 0, spy = sty > 0, spz = stz > 0;
  const float INF = __int_as_float(0x7f800000);
  const float nud = 1e-4f / sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));

  int v[N_FIELDS];
  for (int k = 0; k < N_FIELDS; ++k) v[k] = st_in[k * m + i];
  int dom = v[DOM], cx = v[CX], cy = v[CY], cz = v[CZ];
  float tmx = __int_as_float(v[TMX]), tmy = __int_as_float(v[TMY]), tmz = __int_as_float(v[TMZ]);
  float tdx = __int_as_float(v[TDX]), tdy = __int_as_float(v[TDY]), tdz = __int_as_float(v[TDZ]);
  int resl = v[RESL], mode = v[MODE], vbase = v[VBASE];
  int hit = v[HIT], pidx = v[PIDX], face = v[FACE];
  float t = __int_as_float(v[T]), nt = __int_as_float(v[NT]);
  int hx = v[HX], hy = v[HY], hz = v[HZ];
  int sdom = v[SDOM], scx = v[SCX], scy = v[SCY], scz = v[SCZ];
  float stmx = __int_as_float(v[STMX]), stmy = __int_as_float(v[STMY]), stmz = __int_as_float(v[STMZ]);

  const int sx = tb.sx, sy = tb.sy, sz = tb.sz;
  const int n_regions = tb.n_regions;
  auto region_id = [&](int x, int y, int z) {
    return ((x >> 4) * tb.rdy + (y >> 4)) * tb.rdz + (z >> 4);
  };
  auto outside = [](int x, int y, int z, int ex, int ey, int ez) {
    return x < 0 || x >= ex || y < 0 || y >= ey || z < 0 || z >= ez;
  };

  for (int it = 0; it < max_iters && mode != MODE_DONE; ++it) {
    bool in_empty = false;
    if (mode == MODE_WALK && dom < n_regions) {
      // ---- macro step across an empty region ----
      const int dom_c = clampi(dom, 0, MAX_REGIONS - 1);
      const uint32_t l1bit = (tb.l1[dom_c >> 5] >> (dom_c & 31)) & 1u;
      in_empty = l1bit == 0 && !outside(cx, cy, cz, sx, sy, sz);
      if (in_empty) {
        const int rbx = ((cx >> 4) + spx) << 4, rby = ((cy >> 4) + spy) << 4,
                  rbz = ((cz >> 4) + spz) << 4;
        const float rtx = stx == 0 ? INF : (float(rbx) - ox) * ivx;
        const float rty = sty == 0 ? INF : (float(rby) - oy) * ivy;
        const float rtz = stz == 0 ? INF : (float(rbz) - oz) * ivz;
        const int rax = argmin3(rtx, rty, rtz);
        const float rt = fminf(rtx, fminf(rty, rtz));
        const int bx0 = (cx >> 4) << 4, by0 = (cy >> 4) << 4, bz0 = (cz >> 4) << 4;
        const int fx = clampi(int(floorf(ox + dx * rt)), bx0, bx0 + 15);
        const int fy = clampi(int(floorf(oy + dy * rt)), by0, by0 + 15);
        const int fz = clampi(int(floorf(oz + dz * rt)), bz0, bz0 + 15);
        const int ecx = rax == 0 ? (stx > 0 ? rbx : rbx - 1) : fx;
        const int ecy = rax == 1 ? (sty > 0 ? rby : rby - 1) : fy;
        const int ecz = rax == 2 ? (stz > 0 ? rbz : rbz - 1) : fz;
        if (outside(ecx, ecy, ecz, sx, sy, sz)) {
          mode = MODE_DONE;
        } else {
          cx = ecx;
          cy = ecy;
          cz = ecz;
          tmx = stx == 0 ? INF : (float(cx + spx) - ox) * ivx;
          tmy = sty == 0 ? INF : (float(cy + spy) - oy) * ivy;
          tmz = stz == 0 ? INF : (float(cz + spz) - oz) * ivz;
          dom = region_id(cx, cy, cz);
        }
      }
    }
    if (mode == MODE_WALK && !in_empty) {
      // ---- cube steps within the current domain ----
      const int dom_start = dom;
      for (int k = 0; k < substeps && mode == MODE_WALK && dom == dom_start; ++k) {
        const bool inner = dom >= n_regions;
        const int redge = inner ? (1 << resl) : REGION;
        const int ax = argmin3(tmx, tmy, tmz);
        const float t_hit = fminf(tmx, fminf(tmy, tmz));
        const int stax = ax == 0 ? stx : (ax == 1 ? sty : stz);
        const int f = stax > 0 ? ax : ax + 3;
        const int ncx = cx + (ax == 0 ? stx : 0);
        const int ncy = cy + (ax == 1 ? sty : 0);
        const int ncz = cz + (ax == 2 ? stz : 0);
        const float utx = tmx + (ax == 0 ? tdx : 0.f);
        const float uty = tmy + (ax == 1 ? tdy : 0.f);
        const float utz = tmz + (ax == 2 ? tdz : 0.f);
        const bool out_exit = !inner && outside(ncx, ncy, ncz, sx, sy, sz);
        bool region_change = !inner && !out_exit && region_id(ncx, ncy, ncz) != dom;
        const bool in_exit = inner && outside(ncx, ncy, ncz, redge, redge, redge);
        int new_dom = region_id(ncx, ncy, ncz);
        if (tb.has_r32 && inner && resl == 5 && !in_exit) {
          // R32 grids: crossing an octant boundary hops to the neighbour row.
          const int dom_inner = n_regions + vbase + octant(ncx, ncy, ncz);
          if (dom_inner != dom) {
            region_change = true;
            new_dom = dom_inner;
          }
        }
        if (region_change) {
          dom = new_dom;  // no commit: the ray re-steps under the new row
          continue;
        }
        if (out_exit) {
          mode = MODE_DONE;
        } else if (in_exit) {
          mode = MODE_RESTORE;
        } else {
          const int lx = ncx & 15, ly = ncy & 15, lz = ncz & 15;
          const int edge_l2 = inner ? min(resl, 4) : 4;
          const int local = (((lx << edge_l2) + ly) << edge_l2) + lz;
          const int widx = clampi(local >> 5, 0, 127);
          const uint32_t word =
              tb.rows[clampi(dom, 0, tb.n_domains - 1) * 128 + widx];
          if ((word >> (local & 31)) & 1u) {
            face = f;
            t = t_hit;
            nt = fminf(utx, fminf(uty, utz));
            hx = ncx;
            hy = ncy;
            hz = ncz;
            if (inner) {
              hit = HIT_INNER;
              mode = MODE_DONE;
            } else {
              mode = MODE_CLASSIFY;
            }
          }
        }
        cx = ncx;
        cy = ncy;
        cz = ncz;
        tmx = utx;
        tmy = uty;
        tmz = utz;
      }
    }
    if (mode == MODE_RESTORE) {
      // ---- pop the outer DDA registers ----
      dom = sdom;
      cx = scx;
      cy = scy;
      cz = scz;
      tmx = stmx;
      tmy = stmy;
      tmz = stmz;
      tdx = fabsf(ivx);
      tdy = fabsf(ivy);
      tdz = fabsf(ivz);
      resl = 0;
      mode = MODE_WALK;
    }
    if (mode == MODE_CLASSIFY) {
      if (!tb.has_vox) {
        hit = HIT_OUTER;
        mode = MODE_DONE;
        continue;
      }
      // ---- classification: atom -> final, voxel block -> push ----
      const int local = ((((hx & 15) << 4) + (hy & 15)) << 4) + (hz & 15);
      const int page = tb.page_idx[clampi(dom, 0, n_regions - 1) * 8];
      const int n_prows = tb.wide ? PAGE_ROWS : PAGE_ROWS_NARROW;
      const int lane = tb.wide ? (local & 127) : ((local >> 1) & 127);
      const int rsel = tb.wide ? (local >> 7) : (local >> 8);
      const uint32_t val = tb.pages[(max(page, 0) * n_prows + rsel) * 128 + lane];
      bool is_vox;
      int vent, vrow, rl, atom_pidx;
      if (tb.wide) {
        is_vox = val >= 0x80000000u && page >= 0;
        vent = int((val >> 14) & 0x3FFFu);
        vrow = int(val & 0x3FFFu);
        rl = int((val >> 28) & 7u);
        atom_pidx = int(val & 0xFFFFu);
      } else {
        const uint32_t u16v = (val >> (16 * (local & 1))) & 0xFFFFu;
        is_vox = u16v >= 0x8000u && page >= 0;
        vent = int(u16v & 0xFFFu);
        vrow = vent;  // one row per entry in no-R32 scenes
        rl = int((u16v >> 12) & 7u);
        atom_pidx = int(u16v & 0x7FFFu);
      }
      if (!is_vox) {
        hit = HIT_OUTER;
        pidx = atom_pidx;
        mode = MODE_DONE;
      } else {
        // Push: save the outer registers, enter the voxel grid one
        // virtual voxel early along the entry face axis.
        sdom = dom;
        scx = cx;
        scy = cy;
        scz = cz;
        stmx = tmx;
        stmy = tmy;
        stmz = tmz;
        const int axis = face % 3;
        const int ohx = axis == 0, ohy = axis == 1, ohz = axis == 2;
        const int blk_res = 1 << rl;
        const float rf = float(blk_res);
        const float iox = (ox - float(hx)) * rf;
        const float ioy = (oy - float(hy)) * rf;
        const float ioz = (oz - float(hz)) * rf;
        const float epx = iox + dx * rf * t + dx * nud;
        const float epy = ioy + dy * rf * t + dy * nud;
        const float epz = ioz + dz * rf * t + dz * nud;
        const int icx = clampi(int(floorf(epx)), 0, blk_res - 1);
        const int icy = clampi(int(floorf(epy)), 0, blk_res - 1);
        const int icz = clampi(int(floorf(epz)), 0, blk_res - 1);
        const float itmx = stx == 0 ? INF : (float(icx + spx) - iox) * ivx / rf;
        const float itmy = sty == 0 ? INF : (float(icy + spy) - ioy) * ivy / rf;
        const float itmz = stz == 0 ? INF : (float(icz + spz) - ioz) * ivz / rf;
        cx = icx - ohx * stx;
        cy = icy - ohy * sty;
        cz = icz - ohz * stz;
        tmx = ohx ? t : itmx;
        tmy = ohy ? t : itmy;
        tmz = ohz ? t : itmz;
        tdx = fabsf(ivx) / rf;
        tdy = fabsf(ivy) / rf;
        tdz = fabsf(ivz) / rf;
        int vdom = n_regions + vrow;
        if (tb.has_r32 && rl == 5) vdom += octant(cx, cy, cz);
        dom = vdom;
        vbase = vrow;
        pidx = vent;
        resl = rl;
        mode = MODE_WALK;
      }
    }
  }

  v[DOM] = dom; v[CX] = cx; v[CY] = cy; v[CZ] = cz;
  v[TMX] = __float_as_int(tmx); v[TMY] = __float_as_int(tmy); v[TMZ] = __float_as_int(tmz);
  v[TDX] = __float_as_int(tdx); v[TDY] = __float_as_int(tdy); v[TDZ] = __float_as_int(tdz);
  v[RESL] = resl; v[MODE] = mode; v[VBASE] = vbase;
  v[HIT] = hit; v[PIDX] = pidx; v[FACE] = face;
  v[T] = __float_as_int(t); v[NT] = __float_as_int(nt);
  v[HX] = hx; v[HY] = hy; v[HZ] = hz;
  v[SDOM] = sdom; v[SCX] = scx; v[SCY] = scy; v[SCZ] = scz;
  v[STMX] = __float_as_int(stmx); v[STMY] = __float_as_int(stmy); v[STMZ] = __float_as_int(stmz);
  for (int k = 0; k < N_FIELDS; ++k) st_out[k * m + i] = v[k];
}

}  // namespace

extern "C" int aic_trace_megakernel(
    const void* rays, const void* steps, const void* st_in, void* st_out,
    const void* l1, const void* rows, const void* page_idx, const void* pages,
    int m, int max_iters, int substeps, int n_regions, int n_domains, int sx,
    int sy, int sz, int rdy, int rdz, int has_vox, int has_r32, int wide,
    void* stream) {
  Tables tb;
  tb.l1 = static_cast<const uint32_t*>(l1);
  tb.rows = static_cast<const uint32_t*>(rows);
  tb.page_idx = static_cast<const int32_t*>(page_idx);
  tb.pages = static_cast<const uint32_t*>(pages);
  tb.n_regions = n_regions;
  tb.n_domains = n_domains;
  tb.sx = sx;
  tb.sy = sy;
  tb.sz = sz;
  tb.rdy = rdy;
  tb.rdz = rdz;
  tb.has_vox = has_vox;
  tb.has_r32 = has_r32;
  tb.wide = wide;
  const int threads = 128;
  if (m > 0) {
    trace_megakernel<<<(m + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rays), static_cast<const int32_t*>(steps),
        static_cast<const int32_t*>(st_in), static_cast<int32_t*>(st_out), tb, m,
        max_iters, substeps);
  }
  return static_cast<int>(cudaGetLastError());
}
