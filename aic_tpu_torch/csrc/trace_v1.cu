// v1 surface finder: one thread per ray.
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
// edge 2^resl <= 16); a step into another region switches the domain
// without stepping, and the next iteration repeats the bit test there.
// The ray stops on HIT_OUTER (a visible outer cube: atom or voxel block),
// HIT_INNER (a visible voxel), INNER_EXIT (left a voxel grid) or when it
// leaves the volume. Inner steps advance t by |1/d|/2^resl; ties break Z,
// then Y, then X. Classification, voxel-grid entry and the pop back to the
// outer registers happen between launches (`trace_rays_v1`).
//
// Bound on the H100: like the megakernel, a serial chain of dependent row
// loads per ray plus warp divergence; the tables (rows + the L1 row) are a
// few hundred KB to a few MB and stay in L2. The TPU kernel's min-domain
// group synchronisation and its `domains_per_iter` / `macro_steps` knobs
// only scheduled rays within a group of 1024 and are gone: every thread
// loads its own row word and keeps its DDA registers in registers.
//
// State arrays are int32 (float fields bit-cast): in [9, m], out [15, m];
// rays are f32 [9, m] (origin, direction, inverse direction) and i32 [3, m]
// (step). Built with -fmad=false so float results match PyTorch's
// separately rounded ops. Returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum InField { I_DOM, I_CX, I_CY, I_CZ, I_TMX, I_TMY, I_TMZ, I_RESL, I_WALKING, N_IN };
enum OutField {
  O_DOM, O_CX, O_CY, O_CZ, O_TMX, O_TMY, O_TMZ, O_WALKING,
  O_HIT, O_FACE, O_T, O_NT, O_HX, O_HY, O_HZ, N_OUT
};

constexpr int HIT_OUTER = 1, HIT_INNER = 2, INNER_EXIT = 3;
constexpr int REGION = 16, MAX_REGIONS = 4096;

struct Tables {
  const uint32_t* l1;    // [128] region-occupancy bits
  const uint32_t* rows;  // [n_domains, 128] visibility bits (regions, ventries)
  int n_regions, n_domains, sx, sy, sz, rdy, rdz;
};

__device__ __forceinline__ int argmin3(float tx, float ty, float tz) {
  return tx < ty ? (tx < tz ? 0 : 2) : (ty < tz ? 1 : 2);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void trace_v1(const float* __restrict__ rays,
                         const int32_t* __restrict__ steps,
                         const int32_t* __restrict__ st_in,
                         int32_t* __restrict__ st_out, Tables tb, int m,
                         int max_iters, int substeps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float ox = rays[0 * m + i], oy = rays[1 * m + i], oz = rays[2 * m + i];
  const float dx = rays[3 * m + i], dy = rays[4 * m + i], dz = rays[5 * m + i];
  const float ivx = rays[6 * m + i], ivy = rays[7 * m + i], ivz = rays[8 * m + i];
  const int stx = steps[0 * m + i], sty = steps[1 * m + i], stz = steps[2 * m + i];
  const int spx = stx > 0, spy = sty > 0, spz = stz > 0;
  const float INF = __int_as_float(0x7f800000);

  int dom = st_in[I_DOM * m + i];
  int cx = st_in[I_CX * m + i], cy = st_in[I_CY * m + i], cz = st_in[I_CZ * m + i];
  float tmx = __int_as_float(st_in[I_TMX * m + i]);
  float tmy = __int_as_float(st_in[I_TMY * m + i]);
  float tmz = __int_as_float(st_in[I_TMZ * m + i]);
  const int resl = st_in[I_RESL * m + i];
  bool walking = st_in[I_WALKING * m + i] == 1;
  int hit = 0, face = 0, hx = 0, hy = 0, hz = 0;
  float t = 0.f, nt = 0.f;

  const int sx = tb.sx, sy = tb.sy, sz = tb.sz;
  const int n_regions = tb.n_regions;
  auto region_id = [&](int x, int y, int z) {
    return ((x >> 4) * tb.rdy + (y >> 4)) * tb.rdz + (z >> 4);
  };
  auto outside = [](int x, int y, int z, int ex, int ey, int ez) {
    return x < 0 || x >= ex || y < 0 || y >= ey || z < 0 || z >= ez;
  };

  for (int it = 0; it < max_iters && walking; ++it) {
    bool in_empty = false;
    if (dom < n_regions) {
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
          walking = false;
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
    if (in_empty) continue;
    // ---- cube steps within the current domain ----
    const int dom_start = dom;
    for (int k = 0; k < substeps && walking && dom == dom_start; ++k) {
      const bool inner = dom >= n_regions;
      const int redge = inner ? (1 << resl) : REGION;
      const float scale = inner ? float(1 << resl) : 1.f;
      const int ax = argmin3(tmx, tmy, tmz);
      const float t_hit = fminf(tmx, fminf(tmy, tmz));
      const int stax = ax == 0 ? stx : (ax == 1 ? sty : stz);
      const int f = stax > 0 ? ax : ax + 3;
      const int ncx = cx + (ax == 0 ? stx : 0);
      const int ncy = cy + (ax == 1 ? sty : 0);
      const int ncz = cz + (ax == 2 ? stz : 0);
      const float utx = tmx + (ax == 0 ? fabsf(ivx) / scale : 0.f);
      const float uty = tmy + (ax == 1 ? fabsf(ivy) / scale : 0.f);
      const float utz = tmz + (ax == 2 ? fabsf(ivz) / scale : 0.f);
      const bool out_exit = !inner && outside(ncx, ncy, ncz, sx, sy, sz);
      const bool in_exit = inner && outside(ncx, ncy, ncz, redge, redge, redge);
      if (!inner && !out_exit && region_id(ncx, ncy, ncz) != dom) {
        dom = region_id(ncx, ncy, ncz);  // no commit: re-step under the new row
        continue;
      }
      if (out_exit) {
        walking = false;
      } else if (in_exit) {
        hit = INNER_EXIT;
        walking = false;
      } else {
        const int lx = clampi(inner ? ncx : (ncx & 15), 0, 15);
        const int ly = clampi(inner ? ncy : (ncy & 15), 0, 15);
        const int lz = clampi(inner ? ncz : (ncz & 15), 0, 15);
        const int edge_l2 = inner ? resl : 4;
        const int local = (((lx << edge_l2) + ly) << edge_l2) + lz;
        const int widx = clampi(local >> 5, 0, 127);
        const uint32_t word = tb.rows[clampi(dom, 0, tb.n_domains - 1) * 128 + widx];
        if ((word >> (local & 31)) & 1u) {
          hit = inner ? HIT_INNER : HIT_OUTER;
          face = f;
          t = t_hit;
          nt = fminf(utx, fminf(uty, utz));
          hx = ncx;
          hy = ncy;
          hz = ncz;
          walking = false;
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

  int v[N_OUT];
  v[O_DOM] = dom; v[O_CX] = cx; v[O_CY] = cy; v[O_CZ] = cz;
  v[O_TMX] = __float_as_int(tmx); v[O_TMY] = __float_as_int(tmy); v[O_TMZ] = __float_as_int(tmz);
  v[O_WALKING] = walking ? 1 : 0;
  v[O_HIT] = hit; v[O_FACE] = face;
  v[O_T] = __float_as_int(t); v[O_NT] = __float_as_int(nt);
  v[O_HX] = hx; v[O_HY] = hy; v[O_HZ] = hz;
  for (int k = 0; k < N_OUT; ++k) st_out[k * m + i] = v[k];
}

}  // namespace

extern "C" int aic_trace_v1(const void* rays, const void* steps, const void* st_in,
                            void* st_out, const void* l1, const void* rows, int m,
                            int max_iters, int substeps, int n_regions, int n_domains,
                            int sx, int sy, int sz, int rdy, int rdz, void* stream) {
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
  const int threads = 128;
  if (m > 0) {
    trace_v1<<<(m + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rays), static_cast<const int32_t*>(steps),
        static_cast<const int32_t*>(st_in), static_cast<int32_t*>(st_out), tb, m,
        max_iters, substeps);
  }
  return static_cast<int>(cudaGetLastError());
}
