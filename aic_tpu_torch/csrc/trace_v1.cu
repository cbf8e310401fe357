// v1 surface finder: one thread per listed ray.
//
// Replaces the TPU kernel aic_tpu/raytrace/pallas_trace.py:198
// `_make_kernel` (v1, launched by `_run_kernel`); the plain PyTorch twin is
// `surface_finder_plain` in aic_tpu_torch/raytrace/trace_kernel_v1.py, and
// both keep the TPU kernel's contract: 12 per-ray constants and 9 state
// fields in (`InField`), 15 fields out (`OutField`).
//
// Per ray: the two-level DDA from its current cube to its next surface
// event. An empty 16^3 region (L1 bit clear) is crossed in one macro step;
// otherwise the ray takes up to `substeps` cube steps within its current
// domain (a region's 4096-bit row, or a voxel entry's row at its native
// edge 2^resl <= 16) per iteration, `max_iters` iterations at most; a step
// into another region switches the domain and ends the iteration. The ray
// stops on HIT_OUTER (a visible outer cube: atom or voxel block),
// HIT_INNER (a visible voxel), INNER_EXIT (left a voxel grid) or when it
// leaves the volume. Inner steps advance t by |1/d|/2^resl; ties break Z,
// then Y, then X. Classification, voxel-grid entry and the pop back to the
// outer registers happen between launches (`trace_kernel_v1.advance_packed`).
//
// Bound on the H100: issue of the per-attempt arithmetic over ~80 M cube
// steps a 1080p plaza640 frame, and at the launch's tail the serial chain
// of the longest rays (~800 attempts, the blocks on the horizon's rows)
// sharing their SMs with the bulk; the tables (rows + the L1 row) are a
// few hundred KB to a few MB and stay in L1/L2. What the design does:
//   * A ray never changes between a voxel grid and the outer regions
//     inside one launch (grid entry and exit are the round glue's), so the
//     walk is split (`walk_inner`, `walk_outer`): the inner step |1/d|/
//     2^resl is computed once per launch instead of divided at every
//     step, the grid edge and the bit index's shifts are constants, and
//     the clamps of the local coordinates (no-ops wherever a bit is
//     tested) are gone.
//   * The row of the current domain is addressed once per domain change.
//   * The macro step reloads the ray's origin, direction and inverse
//     direction, so that they take no registers across the cube steps (48
//     registers without spills, ten blocks an SM).
//   * Launched over a list of the walking rays (`idx`): later rounds of a
//     frame walk a few hundred rays and read and write nothing else.
// Tried and measured no faster (aic_tpu_torch/tools/trace_v1_variants.py,
// PERF.md): a step into another region tested in the same attempt, the
// next step's row word loaded ahead of the bit test, the L1 row copied
// into shared memory, the ray held in registers, 64- or 256-thread
// blocks, register caps, blocks in reverse order.
//
// The TPU kernel's min-domain group synchronisation and its
// `domains_per_iter` / `macro_steps` knobs only scheduled rays within a
// group of 1024 and are gone.
//
// State arrays are int32 (float fields bit-cast): in [9, m], out [15, n]
// (column j for ray idx[j], or j itself without a list); rays are f32
// [9, m] (origin, direction, inverse direction) and i32 [3, m] (step).
// Built with -fmad=false so float results match PyTorch's separately
// rounded ops. Returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum InField { I_DOM, I_CX, I_CY, I_CZ, I_TMX, I_TMY, I_TMZ, I_RESL, I_WALKING, N_IN };
enum OutField {
  O_DOM, O_CX, O_CY, O_CZ, O_TMX, O_TMY, O_TMZ, O_WALKING,
  O_HIT, O_FACE, O_T, O_NT, O_HX, O_HY, O_HZ, N_OUT
};

constexpr int HIT_OUTER = 1, HIT_INNER = 2, INNER_EXIT = 3;
constexpr int REGION = 16, MAX_REGIONS = 4096, THREADS = 128;

struct Tables {
  const uint32_t* l1;    // [128] region-occupancy bits
  const uint32_t* rows;  // [n_domains, 128] visibility bits (regions, ventries)
  int n_regions, n_domains, sx, sy, sz, rdy, rdz;
};

// What the cube steps read of a ray; the macro step loads the rest.
struct Ray {
  int stx, sty, stz;
  float ivx, ivy, ivz;
};

// The walk's registers: in from the state, out to the 15 fields.
struct Walk {
  int dom, cx, cy, cz;
  float tmx, tmy, tmz;
  bool walking;
  int hit, face, hx, hy, hz;
  float t, nt;
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

__device__ __forceinline__ const uint32_t* row_of(const Tables& tb, int dom) {
  return tb.rows + clampi(dom, 0, tb.n_domains - 1) * 128;
}

// One cube step from (c, tm): the entered cube n and its boundary t ut.
struct Step {
  int ax, nx, ny, nz;
  float utx, uty, utz;
};

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

// Test the entered cube's bit in its row word; on a visible cube record
// the hit. Then commit the step (the twin commits exits and hits too).
__device__ __forceinline__ void test_word_and_commit(Walk& w, const Ray& r, const Step& s,
                                                     uint32_t word, int local, int kind) {
  if ((word >> (local & 31)) & 1u) {
    const int stax = s.ax == 0 ? r.stx : (s.ax == 1 ? r.sty : r.stz);
    w.hit = kind;
    w.face = stax > 0 ? s.ax : s.ax + 3;
    w.t = fminf(w.tmx, fminf(w.tmy, w.tmz));
    w.nt = fminf(s.utx, fminf(s.uty, s.utz));
    w.hx = s.nx;
    w.hy = s.ny;
    w.hz = s.nz;
    w.walking = false;
  }
  w.cx = s.nx;
  w.cy = s.ny;
  w.cz = s.nz;
  w.tmx = s.utx;
  w.tmy = s.uty;
  w.tmz = s.utz;
}

// A walk inside one voxel grid of edge 2^resl: no macro steps, no domain
// changes, so its iterations are `max_iters * substeps` attempts.
__device__ void walk_inner(Walk& w, const Ray& r, int resl, const Tables& tb, int max_attempts) {
  const float scale = float(1 << resl);
  const float tdx = fabsf(r.ivx) / scale, tdy = fabsf(r.ivy) / scale, tdz = fabsf(r.ivz) / scale;
  const int redge = 1 << resl;
  const uint32_t* row = row_of(tb, w.dom);
  for (int a = 0; a < max_attempts && w.walking; ++a) {
    const Step s = step_of(w, r, tdx, tdy, tdz);
    if (outside(s.nx, s.ny, s.nz, redge, redge, redge)) {
      w.hit = INNER_EXIT;
      w.walking = false;
      w.cx = s.nx;
      w.cy = s.ny;
      w.cz = s.nz;
      w.tmx = s.utx;
      w.tmy = s.uty;
      w.tmz = s.utz;
      break;
    }
    const int local = (((s.nx << resl) + s.ny) << resl) + s.nz;
    test_word_and_commit(w, r, s, row[local >> 5], local, HIT_INNER);
  }
}

// A walk through the outer regions: per iteration a macro step across an
// empty region, or up to `substeps` cube steps in the current region; a
// step into another region switches the domain without stepping and ends
// the iteration (the next one re-steps under the new row).
__device__ void walk_outer(Walk& w, const Ray& r, const Tables& tb, const uint32_t* l1,
                           int max_iters, int substeps, const float* __restrict__ rays, int m,
                           int i) {
  const float INF = __int_as_float(0x7f800000);
  const int spx = r.stx > 0, spy = r.sty > 0, spz = r.stz > 0;
  const float tdx = fabsf(r.ivx), tdy = fabsf(r.ivy), tdz = fabsf(r.ivz);
  const int sx = tb.sx, sy = tb.sy, sz = tb.sz;
  auto region_id = [&](int x, int y, int z) {
    return ((x >> 4) * tb.rdy + (y >> 4)) * tb.rdz + (z >> 4);
  };
  auto l1_bit = [&](int dom) {
    const int d = clampi(dom, 0, MAX_REGIONS - 1);
    return (l1[d >> 5] >> (d & 31)) & 1u;
  };
  uint32_t occupied = l1_bit(w.dom);
  const uint32_t* row = row_of(tb, w.dom);
  int it = 0;
  while (it < max_iters && w.walking) {
    if (!occupied && !outside(w.cx, w.cy, w.cz, sx, sy, sz)) {
      // ---- macro step across an empty region ----
      const float ox = rays[0 * m + i], oy = rays[1 * m + i], oz = rays[2 * m + i];
      const float dx = rays[3 * m + i], dy = rays[4 * m + i], dz = rays[5 * m + i];
      const float ivx = rays[6 * m + i], ivy = rays[7 * m + i], ivz = rays[8 * m + i];
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
      if (outside(ecx, ecy, ecz, sx, sy, sz)) {
        w.walking = false;
      } else {
        w.cx = ecx;
        w.cy = ecy;
        w.cz = ecz;
        w.tmx = r.stx == 0 ? INF : (float(ecx + spx) - ox) * ivx;
        w.tmy = r.sty == 0 ? INF : (float(ecy + spy) - oy) * ivy;
        w.tmz = r.stz == 0 ? INF : (float(ecz + spz) - oz) * ivz;
        w.dom = region_id(ecx, ecy, ecz);
        occupied = l1_bit(w.dom);
        row = row_of(tb, w.dom);
      }
      ++it;
      continue;
    }
    // ---- cube steps within the current region ----
    for (int k = 0;;) {
      const Step s = step_of(w, r, tdx, tdy, tdz);
      if (outside(s.nx, s.ny, s.nz, sx, sy, sz)) {
        w.walking = false;
        w.cx = s.nx;
        w.cy = s.ny;
        w.cz = s.nz;
        w.tmx = s.utx;
        w.tmy = s.uty;
        w.tmz = s.utz;
        break;
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
      test_word_and_commit(w, r, s, row[local >> 5], local, HIT_OUTER);
      if (!w.walking) break;
      if (++k == substeps) {
        ++it;
        break;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
trace_v1(const float* __restrict__ rays, const int32_t* __restrict__ steps,
         const int32_t* __restrict__ st_in, int32_t* __restrict__ st_out, Tables tb,
         const int64_t* __restrict__ idx, int n, int m, int max_iters,
         int substeps) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int i = idx ? int(idx[j]) : j;
  Walk w;
  w.walking = st_in[I_WALKING * m + i] == 1;
  Ray r;
  r.stx = steps[0 * m + i]; r.sty = steps[1 * m + i]; r.stz = steps[2 * m + i];
  r.ivx = rays[6 * m + i]; r.ivy = rays[7 * m + i]; r.ivz = rays[8 * m + i];
  w.dom = st_in[I_DOM * m + i];
  w.cx = st_in[I_CX * m + i];
  w.cy = st_in[I_CY * m + i];
  w.cz = st_in[I_CZ * m + i];
  w.tmx = __int_as_float(st_in[I_TMX * m + i]);
  w.tmy = __int_as_float(st_in[I_TMY * m + i]);
  w.tmz = __int_as_float(st_in[I_TMZ * m + i]);
  w.hit = w.face = w.hx = w.hy = w.hz = 0;
  w.t = w.nt = 0.f;
  if (w.walking) {
    if (w.dom >= tb.n_regions) {
      walk_inner(w, r, st_in[I_RESL * m + i], tb, max_iters * substeps);
    } else {
      walk_outer(w, r, tb, tb.l1, max_iters, substeps, rays, m, i);
    }
  }

  int v[N_OUT];
  v[O_DOM] = w.dom; v[O_CX] = w.cx; v[O_CY] = w.cy; v[O_CZ] = w.cz;
  v[O_TMX] = __float_as_int(w.tmx); v[O_TMY] = __float_as_int(w.tmy);
  v[O_TMZ] = __float_as_int(w.tmz);
  v[O_WALKING] = w.walking ? 1 : 0;
  v[O_HIT] = w.hit; v[O_FACE] = w.face;
  v[O_T] = __float_as_int(w.t); v[O_NT] = __float_as_int(w.nt);
  v[O_HX] = w.hx; v[O_HY] = w.hy; v[O_HZ] = w.hz;
  for (int k = 0; k < N_OUT; ++k) st_out[k * n + j] = v[k];
}

}  // namespace

extern "C" int aic_trace_v1(const void* rays, const void* steps, const void* st_in,
                            void* st_out, const void* l1, const void* rows, const void* idx,
                            int n, int m, int max_iters, int substeps,
                            int n_regions, int n_domains, int sx, int sy, int sz, int rdy,
                            int rdz, void* stream) {
  Tables tb;
  tb.l1 = static_cast<const uint32_t*>(l1);
  tb.rows = static_cast<const uint32_t*>(rows);
  tb.n_regions = n_regions;
  tb.n_domains = n_domains;
  tb.sx = sx;
  tb.sy = sy;
  tb.sz = sz;
  tb.rdy = rdy;
  tb.rdz = rdz;
  if (n > 0) {
    trace_v1<<<(n + THREADS - 1) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rays), static_cast<const int32_t*>(steps),
        static_cast<const int32_t*>(st_in), static_cast<int32_t*>(st_out), tb,
        static_cast<const int64_t*>(idx), n, m, max_iters, substeps);
  }
  return static_cast<int>(cudaGetLastError());
}
