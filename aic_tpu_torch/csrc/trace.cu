// Ray traversal megakernel: one thread per listed ray, state updated in
// place.
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
// rows for R32); leaving a grid pops the saved registers. An iteration is
// one macro step, or up to `substeps` cube steps in one domain with the
// push or pop that ends them; a ray takes `max_iters` iterations at most,
// counted as the twin counts them.
//
// Bound on the H100: the per-attempt arithmetic of the outer cube steps
// (95% of a demo-city frame's ~59 M attempts) and, where most rays hit
// within a step or two (the atrium), the bytes of the state. The tables
// are a few hundred KB and stay in L1/L2. What the design does:
//   * Launched over a list of the walking rays (`idx`), in place on the one
//     i32 [28, m] state buffer that the phase loop carries: columns off the
//     list are neither read nor written, so a later phase walks its few
//     resuming rays and nothing else.
//   * A ray reads and writes only what its path needs: its walk state (dom,
//     cube, boundary t) in and out, and its mode out; the grid registers
//     (resl, vbase, td) in only when it starts inside a grid; the saved
//     registers in only at a pop; the hit record, the saved and the grid
//     registers out only where a hit, a push or a pop changes them. A field
//     not written keeps its value in place, so all 28 still equal the
//     twin's.
//   * The walk is split (`walk_outer`, `walk_inner`): outer steps carry no
//     grid, resolution or R32 tests, and none of the clamps that are no-ops
//     wherever a bit is tested; a domain's row is addressed once per domain
//     change, a grid's edge and bit-index shift once per grid entry.
//   * The origin, direction and signed inverse direction are reloaded at a
//     macro step, a push or a pop instead of held across the cube steps,
//     and the register count is capped (48 registers, no spills).
// The twin's modes CLASSIFY and RESTORE live inside an iteration: here the
// classification and the pop run where the hit or the grid exit happens. A
// launch leaves every ray DONE or WALK, and walks the rays whose mode is
// WALK.
//
// State is [28, m] int32 (float fields bit-cast), column idx[j] for list
// entry j (j itself without a list); rays are f32 [9, m] (origin,
// direction, inverse direction) and i32 [3, m] (step). Built with
// -fmad=false so float results match PyTorch's separately rounded ops, in
// the twin's order: `tm` is accumulated by adding `td`, a macro step
// recomputes it from the origin, ties break Z, then Y, then X. Returns
// cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Field {
  DOM, CX, CY, CZ, TMX, TMY, TMZ, TDX, TDY, TDZ, RESL, MODE, VBASE,
  HIT, PIDX, FACE, T, NT, HX, HY, HZ,
  SDOM, SCX, SCY, SCZ, STMX, STMY, STMZ, N_FIELDS
};

constexpr int MODE_DONE = 0, MODE_WALK = 1;
constexpr int HIT_OUTER = 1, HIT_INNER = 2;
constexpr int MAX_REGIONS = 4096, THREADS = 128;
constexpr int PAGE_ROWS = 32, PAGE_ROWS_NARROW = 16;

// How a walk stops: the ray is done, is out of iterations, or goes on in
// the other walk (a push into a grid, a pop out of one).
enum Status { ENDED, BUDGET, SWITCH };

struct Tables {
  const uint32_t* l1;        // [128] region-occupancy bits
  const uint32_t* rows;      // [n_domains, 128] visibility bits
  const int32_t* page_idx;   // [n_regions_pad, 8] region -> page or -1
  const uint32_t* pages;     // classify codes
  int n_regions, n_domains, sx, sy, sz, rdy, rdz, has_vox, has_r32, wide;
};

// One ray's column of a [k, m] buffer: row k at p[k * m].
template <typename T>
struct Col {
  T* p;
  int m;
  __device__ __forceinline__ T& operator[](int k) const { return p[k * m]; }
};

struct State : Col<int32_t> {
  __device__ __forceinline__ float f(int k) const { return __int_as_float((*this)[k]); }
  __device__ __forceinline__ void set(int k, float v) const { (*this)[k] = __float_as_int(v); }
};

// What the cube steps read of a ray; origin, direction and inverse
// direction are read from `f` where a step needs them.
struct Ray {
  Col<const float> f;
  int stx, sty, stz;
};

// The walk's registers: domain, cube, boundary t per axis.
struct Walk {
  int dom, cx, cy, cz;
  float tmx, tmy, tmz;
};

// One cube step from (c, tm): the entered cube n and its boundary t ut.
struct Step {
  int ax, nx, ny, nz;
  float utx, uty, utz;
};

__device__ __forceinline__ int argmin3(float tx, float ty, float tz) {
  return tx < ty ? (tx < tz ? 0 : 2) : (ty < tz ? 1 : 2);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ bool outside(int x, int y, int z, int ex, int ey, int ez) {
  return unsigned(x) >= unsigned(ex) || unsigned(y) >= unsigned(ey) || unsigned(z) >= unsigned(ez);
}

// Octant of a cube of an R32 grid (coordinates within [0, 32)).
__device__ __forceinline__ int octant(int x, int y, int z) {
  return ((x >> 4) & 1) * 4 + ((y >> 4) & 1) * 2 + ((z >> 4) & 1);
}

__device__ __forceinline__ const uint32_t* row_of(const Tables& tb, int dom) {
  return tb.rows + clampi(dom, 0, tb.n_domains - 1) * 128;
}

__device__ __forceinline__ Step step_of(const Walk& w, const Ray& r, float tdx, float tdy,
                                        float tdz) {
  Step s;
  s.ax = argmin3(w.tmx, w.tmy, w.tmz);
  s.nx = w.cx + (s.ax == 0 ? r.stx : 0);
  s.ny = w.cy + (s.ax == 1 ? r.sty : 0);
  s.nz = w.cz + (s.ax == 2 ? r.stz : 0);
  s.utx = w.tmx + (s.ax == 0 ? tdx : 0.f);
  s.uty = w.tmy + (s.ax == 1 ? tdy : 0.f);
  s.utz = w.tmz + (s.ax == 2 ? tdz : 0.f);
  return s;
}

__device__ __forceinline__ void commit(Walk& w, const Step& s) {
  w.cx = s.nx;
  w.cy = s.ny;
  w.cz = s.nz;
  w.tmx = s.utx;
  w.tmy = s.uty;
  w.tmz = s.utz;
}

// Record a hit's face, t, next t and cube (the twin records them at every
// hit, outer or inner), then commit the step. Returns the hit's t.
__device__ __forceinline__ float record_hit(const State& st, Walk& w, const Ray& r, const Step& s) {
  const int stax = s.ax == 0 ? r.stx : (s.ax == 1 ? r.sty : r.stz);
  const float t = fminf(w.tmx, fminf(w.tmy, w.tmz));
  st[FACE] = stax > 0 ? s.ax : s.ax + 3;
  st.set(T, t);
  st.set(NT, fminf(s.utx, fminf(s.uty, s.utz)));
  st[HX] = s.nx;
  st[HY] = s.ny;
  st[HZ] = s.nz;
  commit(w, s);
  return t;
}

// A visible outer cube `w` (the hit cube, entered along axis `ax` at `t`)
// classified through its region's page. An atom, or any cube of a scene
// with no voxel blocks, ends the ray. A voxel block saves the outer
// registers and enters the block's grid one virtual voxel early along the
// entry face axis, with a 1e-4/|d| nudge.
__device__ Status classify(Walk& w, int ax, float t, const State& st, const Ray& r,
                           const Tables& tb) {
  if (!tb.has_vox) {
    st[HIT] = HIT_OUTER;
    return ENDED;
  }
  const int local = ((w.cx & 15) << 8) | ((w.cy & 15) << 4) | (w.cz & 15);
  const int page = tb.page_idx[w.dom * 8];
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
    st[HIT] = HIT_OUTER;
    st[PIDX] = atom_pidx;
    return ENDED;
  }
  st[SDOM] = w.dom;
  st[SCX] = w.cx;
  st[SCY] = w.cy;
  st[SCZ] = w.cz;
  st.set(STMX, w.tmx);
  st.set(STMY, w.tmy);
  st.set(STMZ, w.tmz);
  const float INF = __int_as_float(0x7f800000);
  const float ox = r.f[0], oy = r.f[1], oz = r.f[2];
  const float dx = r.f[3], dy = r.f[4], dz = r.f[5];
  const float ivx = r.f[6], ivy = r.f[7], ivz = r.f[8];
  const float nud = 1e-4f / sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));
  const int ohx = ax == 0, ohy = ax == 1, ohz = ax == 2;
  const int blk_res = 1 << rl;
  const float rf = float(blk_res);
  const float iox = (ox - float(w.cx)) * rf;
  const float ioy = (oy - float(w.cy)) * rf;
  const float ioz = (oz - float(w.cz)) * rf;
  const int icx = clampi(int(floorf(iox + dx * rf * t + dx * nud)), 0, blk_res - 1);
  const int icy = clampi(int(floorf(ioy + dy * rf * t + dy * nud)), 0, blk_res - 1);
  const int icz = clampi(int(floorf(ioz + dz * rf * t + dz * nud)), 0, blk_res - 1);
  const float itmx = r.stx == 0 ? INF : (float(icx + (r.stx > 0)) - iox) * ivx / rf;
  const float itmy = r.sty == 0 ? INF : (float(icy + (r.sty > 0)) - ioy) * ivy / rf;
  const float itmz = r.stz == 0 ? INF : (float(icz + (r.stz > 0)) - ioz) * ivz / rf;
  w.cx = icx - ohx * r.stx;
  w.cy = icy - ohy * r.sty;
  w.cz = icz - ohz * r.stz;
  w.tmx = ohx ? t : itmx;
  w.tmy = ohy ? t : itmy;
  w.tmz = ohz ? t : itmz;
  w.dom = tb.n_regions + vrow;
  if (tb.has_r32 && rl == 5) {
    // R32 entries start in the octant of the (clipped) entry cube.
    w.dom += octant(clampi(w.cx, 0, 31), clampi(w.cy, 0, 31), clampi(w.cz, 0, 31));
  }
  st.set(TDX, fabsf(ivx) / rf);
  st.set(TDY, fabsf(ivy) / rf);
  st.set(TDZ, fabsf(ivz) / rf);
  st[RESL] = rl;
  st[VBASE] = vrow;
  st[PIDX] = vent;
  return SWITCH;
}

// The walk through the outer regions: per iteration a macro step across an
// empty region, or up to `substeps` cube steps in the current region; a
// step into another region switches the domain without stepping and ends
// the iteration (the next one re-steps under the new row). Stops at a hit
// (classified in the same iteration), out of the volume, or out of
// iterations.
__device__ Status walk_outer(Walk& w, const Ray& r, const State& st, const Tables& tb, int& it,
                             int max_iters, int substeps) {
  const float INF = __int_as_float(0x7f800000);
  const float tdx = fabsf(r.f[6]), tdy = fabsf(r.f[7]), tdz = fabsf(r.f[8]);
  const int sx = tb.sx, sy = tb.sy, sz = tb.sz;
  auto region_id = [&](int x, int y, int z) {
    return ((x >> 4) * tb.rdy + (y >> 4)) * tb.rdz + (z >> 4);
  };
  auto l1_bit = [&](int dom) {
    const int d = clampi(dom, 0, MAX_REGIONS - 1);
    return (tb.l1[d >> 5] >> (d & 31)) & 1u;
  };
  uint32_t occupied = l1_bit(w.dom);
  const uint32_t* row = row_of(tb, w.dom);
  while (it < max_iters) {
    if (!occupied && !outside(w.cx, w.cy, w.cz, sx, sy, sz)) {
      // ---- macro step across an empty region ----
      const float ox = r.f[0], oy = r.f[1], oz = r.f[2];
      const float dx = r.f[3], dy = r.f[4], dz = r.f[5];
      const float ivx = r.f[6], ivy = r.f[7], ivz = r.f[8];
      const int spx = r.stx > 0, spy = r.sty > 0, spz = r.stz > 0;
      const int rbx = ((w.cx >> 4) + spx) << 4, rby = ((w.cy >> 4) + spy) << 4,
                rbz = ((w.cz >> 4) + spz) << 4;
      const float rtx = r.stx == 0 ? INF : (float(rbx) - ox) * ivx;
      const float rty = r.sty == 0 ? INF : (float(rby) - oy) * ivy;
      const float rtz = r.stz == 0 ? INF : (float(rbz) - oz) * ivz;
      const int rax = argmin3(rtx, rty, rtz);
      const float rt = fminf(rtx, fminf(rty, rtz));
      const int bx0 = (w.cx >> 4) << 4, by0 = (w.cy >> 4) << 4, bz0 = (w.cz >> 4) << 4;
      const int fx = clampi(int(floorf(ox + dx * rt)), bx0, bx0 + 15);
      const int fy = clampi(int(floorf(oy + dy * rt)), by0, by0 + 15);
      const int fz = clampi(int(floorf(oz + dz * rt)), bz0, bz0 + 15);
      const int ecx = rax == 0 ? (r.stx > 0 ? rbx : rbx - 1) : fx;
      const int ecy = rax == 1 ? (r.sty > 0 ? rby : rby - 1) : fy;
      const int ecz = rax == 2 ? (r.stz > 0 ? rbz : rbz - 1) : fz;
      ++it;
      if (outside(ecx, ecy, ecz, sx, sy, sz)) return ENDED;
      w.cx = ecx;
      w.cy = ecy;
      w.cz = ecz;
      w.tmx = r.stx == 0 ? INF : (float(ecx + spx) - ox) * ivx;
      w.tmy = r.sty == 0 ? INF : (float(ecy + spy) - oy) * ivy;
      w.tmz = r.stz == 0 ? INF : (float(ecz + spz) - oz) * ivz;
      w.dom = region_id(ecx, ecy, ecz);
      occupied = l1_bit(w.dom);
      row = row_of(tb, w.dom);
      continue;
    }
    // ---- cube steps within the current region ----
    for (int k = 0;;) {
      const Step s = step_of(w, r, tdx, tdy, tdz);
      if (outside(s.nx, s.ny, s.nz, sx, sy, sz)) {
        commit(w, s);
        return ENDED;
      }
      const int nd = region_id(s.nx, s.ny, s.nz);
      if (nd != w.dom) {
        w.dom = nd;
        occupied = l1_bit(nd);
        row = row_of(tb, nd);
        ++it;
        break;
      }
      const int local = ((s.nx & 15) << 8) | ((s.ny & 15) << 4) | (s.nz & 15);
      if ((row[local >> 5] >> (local & 31)) & 1u) {
        const float t = record_hit(st, w, r, s);
        ++it;
        return classify(w, s.ax, t, st, r, tb);
      }
      commit(w, s);
      if (++k == substeps) {
        ++it;
        break;
      }
    }
  }
  return BUDGET;
}

// The walk inside one voxel grid of edge 2^resl (R32: eight 16^3 octant
// rows, a step into another octant switches the row without stepping and
// ends the iteration). Stops at a visible voxel, at the grid's edge (the
// pop, in the same iteration), or out of iterations.
__device__ Status walk_inner(Walk& w, const Ray& r, const State& st, const Tables& tb, int& it,
                             int max_iters, int substeps) {
  const int resl = st[RESL], vbase = st[VBASE];
  const float tdx = st.f(TDX), tdy = st.f(TDY), tdz = st.f(TDZ);
  const int redge = 1 << resl, edge_l2 = min(resl, 4);
  const bool hops = tb.has_r32 && resl == 5;
  const uint32_t* row = row_of(tb, w.dom);
  while (it < max_iters) {
    for (int k = 0;;) {
      const Step s = step_of(w, r, tdx, tdy, tdz);
      if (outside(s.nx, s.ny, s.nz, redge, redge, redge)) {
        // ---- pop: the outer registers come back ----
        w.dom = st[SDOM];
        w.cx = st[SCX];
        w.cy = st[SCY];
        w.cz = st[SCZ];
        w.tmx = st.f(STMX);
        w.tmy = st.f(STMY);
        w.tmz = st.f(STMZ);
        st.set(TDX, fabsf(r.f[6]));
        st.set(TDY, fabsf(r.f[7]));
        st.set(TDZ, fabsf(r.f[8]));
        st[RESL] = 0;
        ++it;
        return SWITCH;
      }
      if (hops) {
        const int nd = tb.n_regions + vbase + octant(s.nx, s.ny, s.nz);
        if (nd != w.dom) {
          w.dom = nd;
          row = row_of(tb, nd);
          ++it;
          break;
        }
      }
      const int local = ((((s.nx & 15) << edge_l2) + (s.ny & 15)) << edge_l2) + (s.nz & 15);
      if ((row[local >> 5] >> (local & 31)) & 1u) {
        record_hit(st, w, r, s);
        st[HIT] = HIT_INNER;
        return ENDED;
      }
      commit(w, s);
      if (++k == substeps) {
        ++it;
        break;
      }
    }
  }
  return BUDGET;
}

// Eight blocks an SM: 64 registers at most. Uncapped, nvcc keeps the
// addresses of the state fields that a hit, a push or a pop writes live
// across the walks (72 registers); capped, it recomputes them there (48
// registers, no spills).
__global__ void __launch_bounds__(THREADS, 8)
trace_megakernel(const float* __restrict__ rays, const int32_t* __restrict__ steps,
                 int32_t* __restrict__ state, const int64_t* __restrict__ idx, Tables tb, int n,
                 int m, int max_iters, int substeps) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int i = idx ? int(idx[j]) : j;
  const State st{{state + i, m}};
  if (st[MODE] != MODE_WALK) return;
  Ray r;
  r.f = Col<const float>{rays + i, m};
  r.stx = steps[i];
  r.sty = steps[m + i];
  r.stz = steps[2 * m + i];
  Walk w;
  w.dom = st[DOM];
  w.cx = st[CX];
  w.cy = st[CY];
  w.cz = st[CZ];
  w.tmx = st.f(TMX);
  w.tmy = st.f(TMY);
  w.tmz = st.f(TMZ);
  int it = 0;
  Status status = SWITCH;
  while (status == SWITCH) {
    status = w.dom >= tb.n_regions ? walk_inner(w, r, st, tb, it, max_iters, substeps)
                                   : walk_outer(w, r, st, tb, it, max_iters, substeps);
  }
  st[DOM] = w.dom;
  st[CX] = w.cx;
  st[CY] = w.cy;
  st[CZ] = w.cz;
  st.set(TMX, w.tmx);
  st.set(TMY, w.tmy);
  st.set(TMZ, w.tmz);
  st[MODE] = status == BUDGET ? MODE_WALK : MODE_DONE;
}

}  // namespace

extern "C" int aic_trace_megakernel(
    const void* rays, const void* steps, void* state, const void* idx, int n, int m,
    const void* l1, const void* rows, const void* page_idx, const void* pages, int max_iters,
    int substeps, int n_regions, int n_domains, int sx, int sy, int sz, int rdy, int rdz,
    int has_vox, int has_r32, int wide, void* stream) {
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
  if (n > 0) {
    trace_megakernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rays), static_cast<const int32_t*>(steps),
        static_cast<int32_t*>(state), static_cast<const int64_t*>(idx), tb, n, m, max_iters,
        substeps);
  }
  return static_cast<int>(cudaGetLastError());
}
