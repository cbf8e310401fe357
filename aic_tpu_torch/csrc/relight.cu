// The Jacobi relight pass: over the cubes that have ray weight in a
// volume, and over a queue round's batch of listed cubes.
//
// Replaces the TPU kernel aic_tpu/light/pallas_relight.py:338
// `_kernel_factory`; semantics are aic_tpu/light/dense.py `_run_pairs`
// (the reference's LightBuffer::traverse, updater.rs:755-880), and the
// plain PyTorch twins are `relight_pass_plain` in
// aic_tpu_torch/light/relight_kernel.py (the volume) and
// `relight_batch_plain` in aic_tpu_torch/light/update.py (a batch).
//
// Two kernels share one walk (`walk`, `step`):
//
// - `relight_pass_kernel`, the volume pass, in two variants as the TPU
//   kernel has (its `dyn` flag): the full pass, and the light-only pass
//   (DYN), which leaves out every term that does not read stored light --
//   emission, the sky a ray picks up at its end, the sky one-ring outside
//   the bounds (which no chart ray reads, below), and the total weight. A
//   pass is affine in the stored light, so full(ring only) +
//   light_only(interior) = full(interior + ring): the convergence loop runs
//   the full pass once and the light-only pass per iteration. It reads the
//   light decoded to f32.
// - `relight_listed_kernel`, the full pass over a batch of a few to about a
//   thousand rows (light/update.py `relight_batch`), which reads the
//   state's packed light itself.
//
// What bounds both on the H100: the latency of dependent loads. Each step
// of a ray is a chain (pair entry -> the entered cube -> its face row ->
// the stored light), and neither the operation bound nor the byte bound
// sees it. The walk shortens each step:
//
// - An air step reads one byte: a u8 mask padded by one cube on each side,
//   bit f set where face f of the cube is visible, bit 6 on the padding. A
//   chart ray moves one cube a step and ends at its first cube outside the
//   volume, so the padding stands in for the in-volume test.
// - One 32-bit word per pair (three i8 offsets, a 3-bit face, an end bit).
//   A step enters its cube through the word's face, so it moves by minus
//   that face's normal: the kernel steps its mask and volume indices by a
//   per-face stride and does not decode the offsets. The words are loaded
//   two steps ahead of their use, in three registers that take turns, so
//   no step waits on one. A ray's last pair ends it, so the walk needs no
//   bound of its own.
// - A visible step loads the light of its cube and of the one behind the
//   struck face (the cube the ray came from, inside the volume, so the sky
//   ring outside it is never read) at once, beside the chain contents ->
//   face row.
//
// The volume pass shortens the chain of a thread: a work list of the cubes
// that are walked and have ray weight (the others stay 0, as the wrapper's
// zero-filled outputs hold them); a block is 32 listed cubes, one per
// lane, times kWarps warps, and warp k walks its share of the rays (dealt
// by chart length, so the shares are even) for all 32 cubes in step, so
// every lane reads the same pair word, and skips a ray that none of its
// lanes weights. The warps' partial sums meet in shared memory and are
// added in warp order.
//
// The listed kernel has too few rows for that tile: a round's 16 cubes
// fill one block on one SM of 132, and each warp walks its 1/16 of the 602
// rays one after another. Instead each lane walks one (row, chart ray)
// pair, so the chain is one ray (at most 104 steps at light distance 60):
// a warp takes 32 rays of one row, dealt by chart length so that its
// lanes end together (`relight_kernel.deal_lanes`), and a batch of n rows
// is n x ceil(602 / 32) warps spread over the card. A lane whose ray has
// no weight does not walk; a warp none of whose lanes has weight walks
// nothing. The row's sum is taken in a fixed order: a shuffle tree within
// each warp, each (row, warp) partial to a scratch buffer, and the row's
// last warp to finish (an atomic ticket per row, which it resets to 0)
// adds the row's partials in warp order. It reads the state's light as
// u8[X, Y, Z, 4], one 32-bit load per cube, and decodes it through a
// 256-entry f32 table in shared memory that the wrapper computes with the
// same PyTorch decode as the plain walk.
//
// No float atomics: two launches on the same inputs give the same bits.
// Inputs are row-major like the tensors that hold them (cube index
// c = (x*Y + y)*Z + z). Each entry point returns cudaGetLastError() after
// its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Warps per block of the volume pass; the ray deal (`relight_kernel.WARPS`)
// is made for this. Three blocks an SM (40 registers a thread): the walk
// waits on loads, and 48 warps an SM hide more of that than 32 (2 blocks,
// 50 registers).
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
// Warps per block of the listed kernel (`relight_kernel.LISTED_BLOCK_WARPS`,
// checked at load). The launch waits on its longest ray's chain; blocks of
// 2, 4, 8 and 16 warps timed within 6% of each other on the H100.
constexpr int kListedWarps = 8;
// Mask bit of a padding cube (`relight_kernel.MASK_OUTSIDE`).
constexpr unsigned kOutside = 0x40u;
constexpr unsigned kFull = 0xffffffffu;

// One lane's walk of one ray.
struct Walk {
  int qm, qv;   // mask and volume index of the cube the ray is in
  float alpha;  // transmittance so far
  float w;      // the ray's weight for this cube
};

struct Sums {
  float r, g, b, total;
};

// How a step reads the stored light of the cube at volume index q: the
// volume pass reads it decoded, f32[V, 3]; the listed kernel reads the
// state's packed u8[V, 4] (R, G, B, status in one 32-bit word) and decodes
// each channel through the table in shared memory.
struct DecodedLight {
  const float* rgb;
  __device__ __forceinline__ float3 at(int q) const {
    const float* p = rgb + 3 * q;
    return make_float3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
  }
};

struct PackedLight {
  const uint32_t* texel;
  const float* table;  // shared: the f32 light of each u8 code
  __device__ __forceinline__ float3 at(int q) const {
    const uint32_t t = __ldg(texel + q);
    return make_float3(table[t & 0xffu], table[(t >> 8) & 0xffu], table[(t >> 16) & 0xffu]);
  }
};

// The change of (mask index, volume index) of a step that enters its cube
// through face f: minus the face's normal, in each array's strides. Set by
// the block's first six threads; the caller synchronizes.
__device__ __forceinline__ void set_face_step(int2* face_step, int tid, int Y, int Z) {
  if (tid < 6) {
    const int axis = tid % 3, sign = tid < 3 ? 1 : -1;
    const int sm = axis == 0 ? (Y + 2) * (Z + 2) : (axis == 1 ? Z + 2 : 1);
    const int sv = axis == 0 ? Y * Z : (axis == 1 ? Z : 1);
    face_step[tid] = make_int2(sign * sm, sign * sv);
  }
}

// One step of a walk, entering a cube through face `face`: returns whether
// the ray ends there, with the sky it then picks up added (full pass).
template <bool DYN, class Light>
__device__ __forceinline__ bool step(uint32_t word, Walk& k, Sums& acc,
                                     const int2* __restrict__ face_step,
                                     const uint8_t* __restrict__ mask,
                                     const int32_t* __restrict__ contents, const Light& light,
                                     const float* __restrict__ face_rows, float sr, float sg,
                                     float sb) {
  const int face = (word >> 24) & 7u;
  bool ends = ((word >> 27) & 1u) != 0u;
  if (!ends) {
    const int2 d = face_step[face];
    const int prev = k.qv;
    k.qm += d.x;
    k.qv += d.y;
    const unsigned bits = mask[k.qm];
    ends = (bits & kOutside) != 0u;
    if (!ends && ((bits >> face) & 1u)) {  // visible
      const float3 o = light.at(k.qv);
      const float3 b = light.at(prev);
      const float* row = face_rows + 8 * (6 * contents[k.qv] + face);
      const float flags = row[4];
      bool hit_opaque = false;
      const float ha = fminf(fmaxf(row[3], 0.f), 1.f);
      if (ha > 0.f) {  // struck: reflect the light behind the face
        const float aw = k.alpha * k.w;
        const float er = DYN ? 0.f : row[5], eg = DYN ? 0.f : row[6],
                    eb = DYN ? 0.f : row[7];
        acc.r = acc.r + (er + fminf(fmaxf(row[0], 0.f), 1.f) * b.x * ha) * aw;
        acc.g = acc.g + (eg + fminf(fmaxf(row[1], 0.f), 1.f) * b.y * ha) * aw;
        acc.b = acc.b + (eb + fminf(fmaxf(row[2], 0.f), 1.f) * b.z * ha) * aw;
        hit_opaque = fmodf(flags, 2.f) >= 1.f;
        if (!hit_opaque) k.alpha = k.alpha * (1.f - ha);
      }
      if (ha < 1.f && !hit_opaque) {  // pass through: own stored light
        const float aw = k.alpha * k.w;
        const float er = DYN ? 0.f : row[5], eg = DYN ? 0.f : row[6],
                    eb = DYN ? 0.f : row[7];
        acc.r = acc.r + (er + o.x * ha) * aw;
        acc.g = acc.g + (eg + o.y * ha) * aw;
        acc.b = acc.b + (eb + o.z * ha) * aw;
        k.alpha = k.alpha * (1.f - ha);
      }
      if (hit_opaque) k.alpha = 0.f;
      ends = hit_opaque || k.alpha <= 0.f;
    }
  }
  if (ends && !DYN) {  // the ray picks up the sky along its direction
    const float aw = k.alpha * k.w;
    acc.r = acc.r + sr * aw;
    acc.g = acc.g + sg * aw;
    acc.b = acc.b + sb * aw;
    acc.total = acc.total + k.w;
  }
  return ends;
}

// One ray from its first pair word `p` to its end, added into `acc`.
template <bool DYN, class Light>
__device__ __forceinline__ void walk(const uint32_t* __restrict__ p, Walk k, Sums& acc,
                                     const int2* __restrict__ face_step,
                                     const uint8_t* __restrict__ mask,
                                     const int32_t* __restrict__ contents, const Light& light,
                                     const float* __restrict__ face_rows, float sr, float sg,
                                     float sb) {
  uint32_t w0 = p[0], w1 = p[1], w2;
  for (;; p += 3) {  // the table ends in pad words
    w2 = p[2];
    if (step<DYN>(w0, k, acc, face_step, mask, contents, light, face_rows, sr, sg, sb)) break;
    w0 = p[3];
    if (step<DYN>(w1, k, acc, face_step, mask, contents, light, face_rows, sr, sg, sb)) break;
    w1 = p[4];
    if (step<DYN>(w2, k, acc, face_step, mask, contents, light, face_rows, sr, sg, sb)) break;
  }
}

// The mask index of volume cube c.
__device__ __forceinline__ int mask_index(int c, int Y, int Z) {
  const int cx = c / (Y * Z), cy = (c / Z) % Y, cz = c % Z;
  return ((cx + 1) * (Y + 2) + (cy + 1)) * (Z + 2) + (cz + 1);
}

// Block b walks the listed cubes cubes[32b .. 32b+31]; the mask is
// u8[X+2, Y+2, Z+2]. Per-cube inputs and outputs are indexed by the cube.
// Words, ray_start and warp_start follow the rays in the order they are
// dealt to the warps; cosines and sky_ray are per chart ray, ray_id[r] for
// dealt ray r.
template <bool DYN>
__global__ void __launch_bounds__(kThreads, 3) relight_pass_kernel(
    const int32_t* __restrict__ contents, const float* __restrict__ light_rgb,
    const float* __restrict__ face_rows, const float* __restrict__ dir_weights,
    const float* __restrict__ alpha0, const uint8_t* __restrict__ mask,
    const int32_t* __restrict__ cubes, const float* __restrict__ cosines,
    const float* __restrict__ sky_ray, const int32_t* __restrict__ ray_start,
    const int32_t* __restrict__ ray_id, const uint32_t* __restrict__ words,
    const int32_t* __restrict__ warp_start, float* __restrict__ incoming,
    float* __restrict__ total, int Y, int Z, int n) {
  __shared__ int2 face_step[6];
  __shared__ float4 part[kThreads];
  const int lane = threadIdx.x, warp = threadIdx.y, tid = warp * 32 + lane;
  set_face_step(face_step, tid, Y, Z);
  __syncthreads();
  const DecodedLight light = {light_rgb};

  const int i = blockIdx.x * 32 + lane;
  const bool listed = i < n;
  const int c = cubes[listed ? i : n - 1];
  const int q0 = mask_index(c, Y, Z);
  const float a0 = alpha0[c];
  float dw[6];
  for (int f = 0; f < 6; ++f) dw[f] = dir_weights[6 * c + f];

  Sums acc = {0.f, 0.f, 0.f, 0.f};
  const int k1 = warp_start[warp + 1];
  for (int r = warp_start[warp]; r < k1; ++r) {  // r: dealt ray, ray_id[r]: chart ray
    const int rc = ray_id[r];
    const float* cr = cosines + 6 * rc;
    float w = dw[0] * cr[0];
    for (int f = 1; f < 6; ++f) w = w + dw[f] * cr[f];
    const bool live = listed && w > 0.f;
    if (__ballot_sync(kFull, live) == 0u) continue;
    if (live) {
      float sr = 0.f, sg = 0.f, sb = 0.f;
      if (!DYN) {
        sr = sky_ray[3 * rc];
        sg = sky_ray[3 * rc + 1];
        sb = sky_ray[3 * rc + 2];
      }
      walk<DYN>(words + ray_start[r], Walk{q0, c, a0, w}, acc, face_step, mask, contents, light,
                face_rows, sr, sg, sb);
    }
  }

  // The warps' partial sums, added in warp order.
  part[tid] = make_float4(acc.r, acc.g, acc.b, acc.total);
  __syncthreads();
  if (warp == 0 && listed) {
    float4 sum = part[lane];
    for (int k = 1; k < kWarps; ++k) {
      const float4 q = part[32 * k + lane];
      sum.x = sum.x + q.x;
      sum.y = sum.y + q.y;
      sum.z = sum.z + q.z;
      sum.w = sum.w + q.w;
    }
    incoming[3 * c] = sum.x;
    incoming[3 * c + 1] = sum.y;
    incoming[3 * c + 2] = sum.z;
    total[c] = sum.w;
  }
}

// Warp g of the grid (blockIdx.x * kListedWarps + threadIdx.y) walks row
// g / ray_warps, the chart rays lane_ray[32 * (g % ray_warps) + lane]
// (-1: an empty lane) from their words at lane_start. Per-row inputs are
// cubes i32[n] (volume index), dir_weights f32[n, 6] and alpha0 f32[n];
// outputs incoming f32[n, 3] and total f32[n], every row written. Scratch:
// partial float4[n * ray_warps]; ticket i32[>= n], 0 at the launch and
// left 0. texel is the packed light u8[V, 4], decode f32[256].
__global__ void __launch_bounds__(32 * kListedWarps) relight_listed_kernel(
    const int32_t* __restrict__ contents, const uint32_t* __restrict__ texel,
    const float* __restrict__ decode, const float* __restrict__ face_rows,
    const float* __restrict__ dir_weights, const float* __restrict__ alpha0,
    const uint8_t* __restrict__ mask, const int32_t* __restrict__ cubes,
    const float* __restrict__ cosines, const float* __restrict__ sky_ray,
    const int32_t* __restrict__ lane_ray, const int32_t* __restrict__ lane_start,
    const uint32_t* __restrict__ words, float4* __restrict__ partial,
    int32_t* __restrict__ ticket, float* __restrict__ incoming, float* __restrict__ total,
    int Y, int Z, int n, int ray_warps) {
  __shared__ int2 face_step[6];
  __shared__ float table[256];
  const int lane = threadIdx.x, tid = threadIdx.y * 32 + lane;
  for (int i = tid; i < 256; i += 32 * kListedWarps) table[i] = decode[i];
  set_face_step(face_step, tid, Y, Z);
  __syncthreads();
  const PackedLight light = {texel, table};

  const int g = blockIdx.x * kListedWarps + threadIdx.y;
  if (g >= n * ray_warps) return;
  const int row = g / ray_warps, slot = 32 * (g - row * ray_warps) + lane;
  const int rc = lane_ray[slot];
  float w = 0.f;
  if (rc >= 0) {
    const float* dw = dir_weights + 6 * row;
    const float* cr = cosines + 6 * rc;
    w = dw[0] * cr[0];
    for (int f = 1; f < 6; ++f) w = w + dw[f] * cr[f];
  }
  Sums acc = {0.f, 0.f, 0.f, 0.f};
  if (w > 0.f) {
    const int c = cubes[row];
    walk<false>(words + lane_start[slot], Walk{mask_index(c, Y, Z), c, alpha0[row], w}, acc,
                face_step, mask, contents, light, face_rows, sky_ray[3 * rc], sky_ray[3 * rc + 1],
                sky_ray[3 * rc + 2]);
  }

  // The warp's sum, a fixed shuffle tree (lane 0 holds it).
  for (int d = 16; d > 0; d >>= 1) {
    acc.r = acc.r + __shfl_down_sync(kFull, acc.r, d);
    acc.g = acc.g + __shfl_down_sync(kFull, acc.g, d);
    acc.b = acc.b + __shfl_down_sync(kFull, acc.b, d);
    acc.total = acc.total + __shfl_down_sync(kFull, acc.total, d);
  }
  float4* parts = partial + row * ray_warps;
  int done = 0;
  if (lane == 0) {
    __stcg(parts + (g - row * ray_warps), make_float4(acc.r, acc.g, acc.b, acc.total));
    __threadfence();  // the partial is seen before the ticket
    done = atomicAdd(ticket + row, 1);
  }
  done = __shfl_sync(kFull, done, 0);
  if (done != ray_warps - 1) return;
  // The row's last warp: its partials, added in warp order (lane k loads
  // warp k's, past L1, which may hold another row's line from before).
  __threadfence();
  const float4 q = lane < ray_warps ? __ldcg(parts + lane) : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 sum = make_float4(__shfl_sync(kFull, q.x, 0), __shfl_sync(kFull, q.y, 0),
                           __shfl_sync(kFull, q.z, 0), __shfl_sync(kFull, q.w, 0));
  for (int k = 1; k < ray_warps; ++k) {
    sum.x = sum.x + __shfl_sync(kFull, q.x, k);
    sum.y = sum.y + __shfl_sync(kFull, q.y, k);
    sum.z = sum.z + __shfl_sync(kFull, q.z, k);
    sum.w = sum.w + __shfl_sync(kFull, q.w, k);
  }
  if (lane == 0) {
    incoming[3 * row] = sum.x;
    incoming[3 * row + 1] = sum.y;
    incoming[3 * row + 2] = sum.z;
    total[row] = sum.w;
    ticket[row] = 0;
  }
}

}  // namespace

extern "C" int aic_relight_warps() { return kWarps; }
extern "C" int aic_relight_listed_warps() { return kListedWarps; }

// `incoming` and `total` come zero-filled; the kernel writes the n listed
// cubes.
extern "C" int aic_relight_pass(
    const void* contents, const void* light_rgb, const void* face_rows,
    const void* dir_weights, const void* alpha0, const void* mask,
    const void* cubes, const void* cosines, const void* sky_ray,
    const void* ray_start, const void* ray_id, const void* words,
    const void* warp_start, void* incoming, void* total, int Y, int Z, int n,
    int dyn, void* stream) {
  if (n > 0) {
    auto kernel = dyn ? relight_pass_kernel<true> : relight_pass_kernel<false>;
    kernel<<<(n + 31) / 32, dim3(32, kWarps), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(contents), static_cast<const float*>(light_rgb),
        static_cast<const float*>(face_rows), static_cast<const float*>(dir_weights),
        static_cast<const float*>(alpha0), static_cast<const uint8_t*>(mask),
        static_cast<const int32_t*>(cubes), static_cast<const float*>(cosines),
        static_cast<const float*>(sky_ray), static_cast<const int32_t*>(ray_start),
        static_cast<const int32_t*>(ray_id), static_cast<const uint32_t*>(words),
        static_cast<const int32_t*>(warp_start),
        static_cast<float*>(incoming), static_cast<float*>(total), Y, Z, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// The listed pass over n rows, ray_warps warps a row. Every row of `incoming` and `total` is written.
extern "C" int aic_relight_listed(
    const void* contents, const void* light, const void* decode, const void* face_rows,
    const void* dir_weights, const void* alpha0, const void* mask, const void* cubes,
    const void* cosines, const void* sky_ray, const void* lane_ray, const void* lane_start,
    const void* words, void* partial, void* ticket, void* incoming, void* total, int Y,
    int Z, int n, int ray_warps, void* stream) {
  if (n > 0) {
    const int warps = n * ray_warps;
    relight_listed_kernel<<<(warps + kListedWarps - 1) / kListedWarps, dim3(32, kListedWarps), 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(contents), static_cast<const uint32_t*>(light),
        static_cast<const float*>(decode), static_cast<const float*>(face_rows),
        static_cast<const float*>(dir_weights), static_cast<const float*>(alpha0),
        static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(cubes),
        static_cast<const float*>(cosines), static_cast<const float*>(sky_ray),
        static_cast<const int32_t*>(lane_ray), static_cast<const int32_t*>(lane_start),
        static_cast<const uint32_t*>(words), static_cast<float4*>(partial),
        static_cast<int32_t*>(ticket), static_cast<float*>(incoming), static_cast<float*>(total),
        Y, Z, n, ray_warps);
  }
  return static_cast<int>(cudaGetLastError());
}
