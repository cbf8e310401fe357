// One Jacobi relight pass over the cubes that have ray weight.
//
// Replaces the TPU kernel aic_tpu/light/pallas_relight.py:338
// `_kernel_factory`; semantics are aic_tpu/light/dense.py `_run_pairs`
// (the reference's LightBuffer::traverse, updater.rs:755-880), and the
// plain PyTorch twin is `relight_pass_plain` in
// aic_tpu_torch/light/relight_kernel.py.
//
// Two variants, as the TPU kernel has (its `dyn` flag): the full pass, and
// the light-only pass (DYN), which leaves out every term that does not read
// stored light -- emission, the sky a ray picks up at its end, the sky
// one-ring outside the bounds (which no chart ray reads, below), and the
// total weight. A pass is affine in the
// stored light, so full(ring only) + light_only(interior) = full(interior +
// ring): the convergence loop runs the full pass once and the light-only
// pass per iteration.
//
// What bounds it on the H100: the latency of dependent loads. Each step of a
// ray is a chain (pair entry -> the entered cube -> its face row -> the
// stored light), and neither the operation bound nor the byte bound sees it.
// With one thread per cube walking all 602 chart rays in a row, a pass took
// as long as the longest cube's chain (15,333 steps on the atrium, ~1,000
// cycles a step). The design shortens the chain and each step of it:
//
// - A work list: only cubes that are walked and have ray weight get a lane.
//   The others stay 0, as the wrapper's zero-filled outputs hold them.
// - A block is 32 listed cubes, one per lane, times kWarps warps. Warp k
//   walks its share of the rays (dealt by chart length, so the shares are
//   even) for all 32 cubes in step, so every lane reads the same pair word,
//   and it skips a ray that none of its lanes weights. The warps' partial
//   sums meet in shared memory and are added in warp order, with no atomics:
//   two launches on the same inputs give the same bits.
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
// The same walk serves the incremental light queue (light/update.py
// `relight_batch`): with `per_row` set, listed cube i reads its ray
// weights and alpha and writes its sums at row i of per-row arrays ([n, 6],
// [n], [n, 3], [n]) instead of at its cube index, so a queue round's batch
// of 16 cubes neither reads nor writes a whole volume of them.
//
// Inputs are row-major like the tensors that hold them (cube index
// c = (x*Y + y)*Z + z). Returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Warps per block; the ray deal (`relight_kernel.WARPS`) is made for this.
// Three blocks an SM (40 registers a thread): the walk waits on loads, and
// 48 warps an SM hide more of that than 32 (2 blocks, 50 registers).
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
// Mask bit of a padding cube (`relight_kernel.MASK_OUTSIDE`).
constexpr unsigned kOutside = 0x40u;

// One lane's walk of one ray.
struct Walk {
  int qm, qv;   // mask and volume index of the cube the ray is in
  float alpha;  // transmittance so far
  float w;      // the ray's weight for this cube
};

struct Sums {
  float r, g, b, total;
};

// One step of a walk, entering a cube through face `face`: returns whether
// the ray ends there, with the sky it then picks up added (full pass).
template <bool DYN>
__device__ __forceinline__ bool step(uint32_t word, Walk& k, Sums& acc,
                                     const int2* __restrict__ face_step,
                                     const uint8_t* __restrict__ mask,
                                     const int32_t* __restrict__ contents,
                                     const float* __restrict__ light_rgb,
                                     const float* __restrict__ face_rows, float sr,
                                     float sg, float sb) {
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
      const float* own = light_rgb + 3 * k.qv;
      const float* behind = light_rgb + 3 * prev;
      const float o0 = own[0], o1 = own[1], o2 = own[2];
      const float b0 = behind[0], b1 = behind[1], b2 = behind[2];
      const float* row = face_rows + 8 * (6 * contents[k.qv] + face);
      const float flags = row[4];
      bool hit_opaque = false;
      const float ha = fminf(fmaxf(row[3], 0.f), 1.f);
      if (ha > 0.f) {  // struck: reflect the light behind the face
        const float aw = k.alpha * k.w;
        const float er = DYN ? 0.f : row[5], eg = DYN ? 0.f : row[6],
                    eb = DYN ? 0.f : row[7];
        acc.r = acc.r + (er + fminf(fmaxf(row[0], 0.f), 1.f) * b0 * ha) * aw;
        acc.g = acc.g + (eg + fminf(fmaxf(row[1], 0.f), 1.f) * b1 * ha) * aw;
        acc.b = acc.b + (eb + fminf(fmaxf(row[2], 0.f), 1.f) * b2 * ha) * aw;
        hit_opaque = fmodf(flags, 2.f) >= 1.f;
        if (!hit_opaque) k.alpha = k.alpha * (1.f - ha);
      }
      if (ha < 1.f && !hit_opaque) {  // pass through: own stored light
        const float aw = k.alpha * k.w;
        const float er = DYN ? 0.f : row[5], eg = DYN ? 0.f : row[6],
                    eb = DYN ? 0.f : row[7];
        acc.r = acc.r + (er + o0 * ha) * aw;
        acc.g = acc.g + (eg + o1 * ha) * aw;
        acc.b = acc.b + (eb + o2 * ha) * aw;
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

// Block b walks the listed cubes cubes[32b .. 32b+31]; the mask is
// u8[X+2, Y+2, Z+2]. Per-cube inputs and outputs are indexed by the cube,
// or by the list position with `per_row`. Words, ray_start and warp_start
// follow the rays in the order they are dealt to the warps; cosines and
// sky_ray are per chart ray, ray_id[r] for dealt ray r.
template <bool DYN>
__global__ void __launch_bounds__(kThreads, 3) relight_pass_kernel(
    const int32_t* __restrict__ contents, const float* __restrict__ light_rgb,
    const float* __restrict__ face_rows, const float* __restrict__ dir_weights,
    const float* __restrict__ alpha0, const uint8_t* __restrict__ mask,
    const int32_t* __restrict__ cubes, const float* __restrict__ cosines,
    const float* __restrict__ sky_ray, const int32_t* __restrict__ ray_start,
    const int32_t* __restrict__ ray_id, const uint32_t* __restrict__ words,
    const int32_t* __restrict__ warp_start, float* __restrict__ incoming,
    float* __restrict__ total, int Y, int Z, int n, bool per_row) {
  // The change of (mask index, volume index) of a step that enters its cube
  // through face f: minus the face's normal, in each array's strides.
  __shared__ int2 face_step[6];
  __shared__ float4 part[kThreads];
  const int lane = threadIdx.x, warp = threadIdx.y, tid = warp * 32 + lane;
  if (tid < 6) {
    const int axis = tid % 3, sign = tid < 3 ? 1 : -1;
    const int sm = axis == 0 ? (Y + 2) * (Z + 2) : (axis == 1 ? Z + 2 : 1);
    const int sv = axis == 0 ? Y * Z : (axis == 1 ? Z : 1);
    face_step[tid] = make_int2(sign * sm, sign * sv);
  }
  __syncthreads();

  const int i = blockIdx.x * 32 + lane;
  const bool listed = i < n;
  const int c = cubes[listed ? i : n - 1];
  const int pc = per_row ? (listed ? i : n - 1) : c;  // per-cube row
  const int cx = c / (Y * Z), cy = (c / Z) % Y, cz = c % Z;
  const int q0 = ((cx + 1) * (Y + 2) + (cy + 1)) * (Z + 2) + (cz + 1);
  const float a0 = alpha0[pc];
  float dw[6];
  for (int f = 0; f < 6; ++f) dw[f] = dir_weights[6 * pc + f];

  Sums acc = {0.f, 0.f, 0.f, 0.f};
  const int k1 = warp_start[warp + 1];
  for (int r = warp_start[warp]; r < k1; ++r) {  // r: dealt ray, ray_id[r]: chart ray
    const int rc = ray_id[r];
    const float* cr = cosines + 6 * rc;
    float w = dw[0] * cr[0];
    for (int f = 1; f < 6; ++f) w = w + dw[f] * cr[f];
    const bool live = listed && w > 0.f;
    if (__ballot_sync(0xffffffffu, live) == 0u) continue;
    if (live) {
      float sr = 0.f, sg = 0.f, sb = 0.f;
      if (!DYN) {
        sr = sky_ray[3 * rc];
        sg = sky_ray[3 * rc + 1];
        sb = sky_ray[3 * rc + 2];
      }
      Walk k = {q0, c, a0, w};
      const uint32_t* p = words + ray_start[r];
      uint32_t w0 = p[0], w1 = p[1], w2;
      for (;; p += 3) {  // the table ends in pad words
        w2 = p[2];
        if (step<DYN>(w0, k, acc, face_step, mask, contents, light_rgb, face_rows, sr, sg, sb)) break;
        w0 = p[3];
        if (step<DYN>(w1, k, acc, face_step, mask, contents, light_rgb, face_rows, sr, sg, sb)) break;
        w1 = p[4];
        if (step<DYN>(w2, k, acc, face_step, mask, contents, light_rgb, face_rows, sr, sg, sb)) break;
      }
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
    incoming[3 * pc] = sum.x;
    incoming[3 * pc + 1] = sum.y;
    incoming[3 * pc + 2] = sum.z;
    total[pc] = sum.w;
  }
}

}  // namespace

extern "C" int aic_relight_warps() { return kWarps; }

// `incoming` and `total` come zero-filled; the kernel writes the n listed
// cubes (at their list positions with `per_row`).
extern "C" int aic_relight_pass(
    const void* contents, const void* light_rgb, const void* face_rows,
    const void* dir_weights, const void* alpha0, const void* mask,
    const void* cubes, const void* cosines, const void* sky_ray,
    const void* ray_start, const void* ray_id, const void* words,
    const void* warp_start, void* incoming, void* total, int Y, int Z, int n,
    int dyn, int per_row, void* stream) {
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
        static_cast<float*>(incoming), static_cast<float*>(total), Y, Z, n, per_row != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
